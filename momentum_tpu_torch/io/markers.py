"""Marker-file IO: C3D (binary) and TRC (text).

Reference: momentum/io/marker/c3d_io.{h,cpp} (via the ezc3d library) and
trc_io.{h,cpp} → MarkerSequence. This is a from-scratch reader for the
standard C3D file layout (512-byte blocks, header + parameter section + 3D
point data; see the public C3D spec): Intel, DEC (VAX floats) and MIPS
(big-endian) processor types with float or scaled-integer point data, reads
POINT:LABELS for marker names and treats residual < 0 as occluded — the same
semantics the reference gets from ezc3d.

Files are parsed on the host into a RawMarkerData (numpy);
`RawMarkerData.to_marker_sequence` puts a clip on the device the tracker
runs on.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch

from momentum_tpu_torch.device import resolve, to_host

__all__ = ["load_c3d", "load_trc", "save_trc", "RawMarkerData",
           "load_markers", "load_markers_from_bytes"]


class RawMarkerData:
    """Host-side marker clip: positions (F, M, 3) float32 (NaN when occluded),
    occluded (F, M) bool, names, fps. `name` is the subject/actor name when
    the file carries one (MarkerSequence.name, marker.h)."""

    def __init__(self, positions, occluded, names, fps, name=""):
        self.positions = positions
        self.occluded = occluded
        self.names = list(names)
        self.fps = fps
        self.name = name

    @property
    def num_frames(self):
        return self.positions.shape[0]

    @property
    def num_markers(self):
        return self.positions.shape[1]

    def to_marker_sequence(self, device="cuda"):
        """The clip as a tracking.MarkerSequence on `device` (the card
        unless the caller asks for the CPU); occluded positions read 0."""
        from momentum_tpu_torch.tracking import MarkerSequence

        device = resolve(device, "RawMarkerData.to_marker_sequence")
        pos = np.where(self.occluded[..., None], 0.0, self.positions)
        return MarkerSequence(
            positions=torch.as_tensor(pos.astype(np.float32), device=device),
            occluded=torch.as_tensor(np.asarray(self.occluded, bool), device=device),
            names=tuple(self.names),
        )


def _dec_to_f32(raw4: bytes) -> float:
    """A DEC (VAX F_floating) float: swap the 16-bit words, read as
    little-endian IEEE, divide by 4."""
    return struct.unpack("<f", raw4[2:4] + raw4[0:2])[0] / 4.0


def load_c3d(path) -> RawMarkerData:
    """Accepts a filesystem path or the raw file bytes (the reference's
    loadMarkersFromBytes variant, momentum_io.h)."""
    if isinstance(path, (bytes, bytearray)):
        data = bytes(path)
    else:
        with open(path, "rb") as f:
            data = f.read()

    # --- header (block 1) ---
    param_block, magic = data[0], data[1]
    if magic != 0x50:
        raise ValueError(f"not a C3D file (magic byte {magic:#x})")

    # processor type lives in the parameter section header (byte 4 = 83 + x):
    # 84 = Intel (LE IEEE), 85 = DEC (VAX F_floating, LE ints),
    # 86 = MIPS/SGI (BE IEEE)
    pstart = (param_block - 1) * 512
    proc = data[pstart + 3]
    if proc not in (0, 83, 84, 85, 86):
        raise ValueError(f"unknown C3D processor type {proc}")
    end = ">" if proc == 86 else "<"
    is_dec = proc == 85

    def u16(off):
        return struct.unpack_from(end + "H", data, off)[0]

    def _ieee_f32(off):
        return struct.unpack_from(end + "f", data, off)[0]

    if is_dec:
        # Some writers flag DEC but store IEEE floats (the reference's own
        # markers.c3d is such a file). Pick the decode whose header
        # scale/frame-rate are sane.
        dec_rate = _dec_to_f32(data[20:24])
        dec_scale = _dec_to_f32(data[12:16])
        if not (1.0 <= dec_rate <= 1e4 and abs(dec_scale) < 1e6):
            ieee_rate = _ieee_f32(20)
            ieee_scale = _ieee_f32(12)
            if 1.0 <= ieee_rate <= 1e4 and abs(ieee_scale) < 1e6:
                is_dec = False

    def f32(off):
        if is_dec:
            return _dec_to_f32(data[off: off + 4])
        return _ieee_f32(off)

    def f32_array(offset, count):
        if is_dec:
            raw = np.frombuffer(data, "<u2", count * 2, offset).reshape(-1, 2)
            sw = np.ascontiguousarray(raw[:, ::-1]).view("<f4")[:, 0]
            return (sw / 4.0).astype(np.float32)
        return np.frombuffer(data, end + "f4", count, offset).astype(np.float32)

    n_points = u16(2)
    first_frame = u16(6)
    last_frame = u16(8)
    scale = f32(12)
    data_block = u16(16)
    frame_rate = f32(20)
    analog_per_frame = u16(4)  # total analog samples per 3D frame

    n_frames = last_frame - first_frame + 1
    uses_float = scale < 0

    # --- parameter section: find POINT:LABELS ---
    labels = []
    pos = pstart + 4
    groups = {}
    while pos < len(data) - 4:
        n_name = struct.unpack_from("b", data, pos)[0]
        group_id = struct.unpack_from("b", data, pos + 1)[0]
        if n_name == 0 or group_id == 0:
            break
        name = data[pos + 2: pos + 2 + abs(n_name)].decode("ascii", "replace")
        off_ptr = pos + 2 + abs(n_name)
        next_off = u16(off_ptr)
        body_end = len(data) if next_off == 0 else off_ptr + next_off
        if group_id < 0:
            groups[-group_id] = name.upper()
        elif groups.get(group_id, "") == "POINT" and name.upper() == "LABELS":
            p = off_ptr + 2
            elem_size = struct.unpack_from("b", data, p)[0]
            n_dims = data[p + 1]
            dims = [data[p + 2 + k] for k in range(n_dims)]
            p2 = p + 2 + n_dims
            if elem_size == -1 and n_dims == 2:
                width, count = dims
                for i in range(count):
                    s = data[p2 + i * width: p2 + (i + 1) * width]
                    labels.append(s.decode("ascii", "replace").strip())
        if next_off == 0:
            break
        pos = body_end

    # --- point data ---
    dstart = (data_block - 1) * 512
    frame_words = n_points * 4 + analog_per_frame
    if uses_float:
        raw = f32_array(dstart, n_frames * frame_words).reshape(n_frames, frame_words)
        pts = raw[:, : n_points * 4].reshape(n_frames, n_points, 4)
        positions = pts[..., :3].astype(np.float32)
        residual = pts[..., 3]
    else:
        raw = np.frombuffer(data, dtype=end + "i2", count=n_frames * frame_words,
                            offset=dstart).reshape(n_frames, frame_words)
        pts = raw[:, : n_points * 4].reshape(n_frames, n_points, 4)
        positions = pts[..., :3].astype(np.float32) * abs(scale)
        residual = pts[..., 3].astype(np.float32)
    occluded = residual < 0
    positions = np.where(occluded[..., None], np.nan, positions)

    if len(labels) < n_points:
        labels += [f"M{i}" for i in range(len(labels), n_points)]
    return RawMarkerData(positions, occluded, labels[:n_points], frame_rate)


def load_trc(path) -> RawMarkerData:
    """TRC text marker format (trc_io.cpp). Accepts a path or raw bytes."""
    if isinstance(path, (bytes, bytearray)):
        lines = bytes(path).decode("utf-8", errors="replace").splitlines()
    else:
        with open(path, "r") as f:
            lines = f.read().splitlines()
    # line 1 (0-indexed): metadata headers; line 2: values; line 3: marker names
    meta = dict(zip(lines[1].split("\t"), lines[2].split("\t")))
    fps = float(meta.get("DataRate", 120.0))
    n_markers = int(meta.get("NumMarkers", 0))
    names = [n for n in lines[3].split("\t")[2:] if n.strip()][:n_markers]
    rows = []
    for line in lines[5:]:
        toks = line.split("\t")
        if not toks[0].strip().isdigit():
            continue
        vals = []
        for i in range(n_markers * 3):
            t = toks[2 + i] if 2 + i < len(toks) else ""
            vals.append(float(t) if t.strip() else np.nan)
        rows.append(vals)
    arr = np.asarray(rows, np.float32).reshape(len(rows), n_markers, 3)
    occluded = np.isnan(arr).any(axis=-1)
    return RawMarkerData(arr, occluded, names, fps)


def save_trc(path, markers: RawMarkerData) -> None:
    """Write a clip (host arrays or tensors) as TRC text; the header names
    `path`."""
    f_cnt, m_cnt = markers.num_frames, markers.num_markers
    positions, occluded = to_host(markers.positions), to_host(markers.occluded)
    with open(path, "w") as f:
        f.write(f"PathFileType\t4\t(X/Y/Z)\t{path}\n")
        f.write("DataRate\tCameraRate\tNumFrames\tNumMarkers\tUnits\t"
                "OrigDataRate\tOrigDataStartFrame\tOrigNumFrames\n")
        f.write(f"{markers.fps:g}\t{markers.fps:g}\t{f_cnt}\t{m_cnt}\tmm\t"
                f"{markers.fps:g}\t1\t{f_cnt}\n")
        f.write("Frame#\tTime\t" + "\t\t\t".join(markers.names) + "\t\t\t\n")
        f.write("\t\t" + "\t".join(
            f"X{i+1}\tY{i+1}\tZ{i+1}" for i in range(m_cnt)) + "\n\n")
        for fi in range(f_cnt):
            row = [str(fi + 1), f"{fi / markers.fps:.5f}"]
            for mi in range(m_cnt):
                if occluded[fi, mi]:
                    row += ["", "", ""]
                else:
                    row += [f"{v:.5f}" for v in positions[fi, mi]]
            f.write("\t".join(row) + "\n")


def _split_subjects(markers: RawMarkerData, main_subject_only: bool):
    """Split a clip into per-subject clips by "Subject:Marker" label prefixes
    (the C3D/TRC convention the reference's loadMarkersFromFile honors;
    marker_io). Unprefixed labels form the "" subject. main_subject_only
    keeps only the subject with the most markers."""
    groups: dict = {}
    for i, nm in enumerate(markers.names):
        subj, _, rest = nm.rpartition(":")
        groups.setdefault(subj, []).append((i, rest or nm))
    out = []
    for subj, items in groups.items():
        idx = [i for i, _ in items]
        out.append(RawMarkerData(markers.positions[:, idx], markers.occluded[:, idx],
                                 [n for _, n in items], markers.fps, name=subj))
    out.sort(key=lambda m: -m.num_markers)
    if main_subject_only:
        out = out[:1]
    return out


def _apply_up(markers: RawMarkerData, up: str) -> RawMarkerData:
    """Re-express marker positions in momentum's Y-up frame given the file's
    up axis (the `up` argument of pymomentum load_markers; UpVector)."""
    up = str(up).lower().lstrip("upvector.")
    if up in ("y", ""):
        return markers
    p = markers.positions
    if up == "z":  # Z-up right-handed → Y-up: (x, y, z) → (x, z, -y)
        markers.positions = np.stack([p[..., 0], p[..., 2], -p[..., 1]], axis=-1)
    elif up == "x":  # X-up → Y-up: (x, y, z) → (y, x, -z)
        markers.positions = np.stack([p[..., 1], p[..., 0], -p[..., 2]], axis=-1)
    else:
        raise ValueError(f"unknown up axis {up!r}")
    return markers


def _load_raw(source, fmt: str):
    """RawMarkerData of a path or bytes in the format `fmt` (c3d, trc, glb,
    gltf); None for a glTF file without markers."""
    if fmt == "c3d":
        return load_c3d(source)
    if fmt == "trc":
        return load_trc(source)
    if fmt in ("glb", "gltf"):
        from momentum_tpu_torch.io.gltf import load_character_glb

        _, _, fps, mseq = load_character_glb(source, return_markers=True, device="cpu")
        if mseq is None:
            return None
        return RawMarkerData(mseq.positions.numpy(), mseq.occluded.numpy().astype(bool),
                             list(mseq.names), fps)
    return None


def load_markers(path, main_subject_only: bool = True, up: str = "y"):
    """Load mocap markers from .c3d/.trc/.glb, one RawMarkerData (host
    arrays) per subject (pymomentum.geometry.load_markers,
    geometry_pybind.cpp:970-983)."""
    ext = os.path.splitext(str(path))[1].lower()
    if ext not in (".c3d", ".trc", ".glb", ".gltf"):
        raise ValueError(f"unsupported marker format {ext!r}")
    raw = _load_raw(path, ext[1:])
    if raw is None:
        return []
    return _split_subjects(_apply_up(raw, up), main_subject_only)


def load_markers_from_bytes(data: bytes, format: str, main_subject_only: bool = True,
                            up: str = "y"):
    """Same as load_markers but from an in-memory buffer plus an extension
    hint (".c3d", ".trc", ".glb") — the reference's loadMarkersFromBytes."""
    fmt = format.lower().lstrip(".")
    if fmt not in ("c3d", "trc", "glb", "gltf"):
        raise ValueError(f"unsupported marker format {format!r}")
    raw = _load_raw(bytes(data), fmt)
    if raw is None:
        return []
    return _split_subjects(_apply_up(raw, up), main_subject_only)
