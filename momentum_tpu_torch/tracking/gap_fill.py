"""Marker gap filling, after momentum_tpu/tracking/gap_fill.py
(marker_gap_fill.{h,cpp}; processMarkerFile runs it first,
process_markers.cpp:311). Host-side numpy: per marker, linear interpolation
across interior gaps of up to `max_gap` frames; leading and trailing
occlusions stay occluded. Returns a new MarkerSequence, on the input's
device, with the filled samples marked visible."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["fill_marker_gaps"]


def fill_marker_gaps(markers, max_gap: int = 10):
    pos = markers.positions.cpu().numpy().copy()
    occ = markers.occluded.cpu().numpy().copy()
    f, m = occ.shape
    for mi in range(m):
        vis = np.nonzero(~occ[:, mi])[0]
        if len(vis) < 2:
            continue
        for a, b in zip(vis[:-1], vis[1:]):
            gap = b - a - 1
            if 0 < gap <= max_gap:
                t = (np.arange(a + 1, b) - a) / (b - a)
                pos[a + 1: b, mi] = (1 - t)[:, None] * pos[a, mi] + t[:, None] * pos[b, mi]
                occ[a + 1: b, mi] = False
    device = markers.positions.device
    return dataclasses.replace(markers, positions=torch.as_tensor(pos, device=device),
                               occluded=torch.as_tensor(occ, device=device))
