"""Marker takes for the cells, drawn from the seed on the device.

A take is continuous motion of the rig and its markers: a frozen copy,
generalised to any length, of momentum_tpu_torch/testing/workloads.py::
tracking_clip_draws (commit 45bf5184d6b6a7fbab3c206b266155535e341f3c), the
repo's stand-in for momentum's CMU walking take 02_01.c3d (343 frames of
the 41-marker set at 120 Hz). With t = frame / period_frames:

    every rotation parameter  amp·sin(2πt + phase), amp U(amp_lo, amp_hi)
                              rad and phase U(0, 2π), drawn per parameter
    root x                    walk_m·t (a straight walk)
    root y                    0
    root z                    height_m + bob_m·sin(2πt)
    scale_global              fixed (log2)

and the markers are the truth's locator positions (the benchmark's own FK)
plus N(0, noise_m) on each coordinate. Lengths are in metres (config 6s's
mm / 1000). Every take of every seed has the same sizes; the seed draws
only the amplitudes, phases and noise.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import kinematics as kin


def draw_takes(rr, motion: dict, count: int, frames: int, num_params: int, gen,
               device) -> tuple:
    """(truth (count, F, P), markers (count, F, L, 3)) of `count` takes."""
    t = torch.arange(frames, dtype=torch.float32, device=device) / motion["period_frames"]
    lo, hi = motion["rotation_amp"]
    amp = lo + (hi - lo) * torch.rand(count, 1, num_params, generator=gen, device=device)
    phase = 2 * math.pi * torch.rand(count, 1, num_params, generator=gen, device=device)
    truth = amp * torch.sin(2 * math.pi * t[None, :, None] + phase)
    truth[..., 0] = motion["walk_m"] * t
    truth[..., 1] = 0.0
    truth[..., 2] = motion["height_m"] + motion["bob_m"] * torch.sin(2 * math.pi * t)
    truth[..., 6] = motion["scale_global"]
    clean = kin.locator_positions(rr, truth)
    markers = clean + motion["noise_m"] * torch.randn(clean.shape, generator=gen, device=device)
    return truth, markers


def keyframe_starts(truth: torch.Tensor, stride: int) -> torch.Tensor:
    """(..., F, P) each frame's start as a keyframe-seeded batched tracker
    gives it: the poses of every `stride`-th frame (and the last) linearly
    interpolated in between (tracking/tracker.py::track_poses_hierarchical's
    rule), here with the keyframes at their truth."""
    frames = truth.shape[-2]
    keys = list(range(0, frames, stride))
    if keys[-1] != frames - 1:
        keys.append(frames - 1)
    keys_t = torch.as_tensor(keys, device=truth.device)
    f = torch.arange(frames, device=truth.device)
    seg = torch.clamp(torch.searchsorted(keys_t, f, right=True) - 1, 0, len(keys) - 2)
    lo, hi = keys_t[seg], keys_t[seg + 1]
    w = ((f - lo) / torch.clamp(hi - lo, min=1)).to(truth.dtype)[:, None]
    return truth[..., lo, :] * (1 - w) + truth[..., hi, :] * w


def centroid_starts(markers: torch.Tensor, num_params: int) -> torch.Tensor:
    """(..., F, P) each frame's start as the tracker seeds a take: every
    parameter zero but the root's translation, at the frame's marker
    centroid (testing/workloads.py::build_tracking_clip's `seed_params`,
    frame by frame)."""
    start = torch.zeros(markers.shape[:-2] + (num_params,), dtype=markers.dtype,
                        device=markers.device)
    start[..., :3] = markers.mean(dim=-2)
    return start
