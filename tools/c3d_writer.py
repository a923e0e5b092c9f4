"""A minimal C3D writer: 3D points only, Intel, DEC or MIPS processor type,
real or scaled-integer point format, POINT:LABELS and POINT:RATE/SCALE/USED.

Neither package has a C3D writer (the reference reads C3D through ezc3d and
writes none). This one exists so that tests and tools/jax_reference.py can
make C3D files for the readers of both packages; neither package imports
it. The layout is the public C3D specification's: a 512-byte header block,
the parameter section from block 2, the point data after it. A point is
(x, y, z, residual): residual -1 marks it occluded, 0 visible.

    import c3d_writer  # with tools/ on sys.path
    data = c3d_writer.c3d_bytes(positions, occluded, labels, rate=120.0,
                                processor="intel", point_format="real")
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["c3d_bytes", "save_c3d"]

_PROCESSORS = {"intel": 84, "dec": 85, "mips": 86}


def _dec_float(v: float) -> bytes:
    """A DEC (VAX F_floating) float: the IEEE single of 4·v with its two
    16-bit words swapped."""
    b = struct.pack("<f", 4.0 * v)
    return b[2:4] + b[0:2]


def _dec_floats(a: np.ndarray) -> bytes:
    ieee = (np.asarray(a, np.float32) * np.float32(4.0)).astype("<f4")
    words = ieee.view("<u2").reshape(-1, 2)[:, ::-1]
    return np.ascontiguousarray(words).tobytes()


def _param(name: str, group: int, elem: int, dims, payload: bytes, last: bool,
           e: str) -> bytes:
    """One parameter record: its name, group, the offset to the next record
    (byte order `e`), element size (-1 characters, 2 integers, 4 floats),
    dimensions, data, and an empty description."""
    nb = name.encode("ascii")
    body = struct.pack("<bB", elem, len(dims)) + bytes(dims) + payload + b"\x00"
    return (struct.pack("<bb", len(nb), group) + nb
            + struct.pack(e + "H", 0 if last else 2 + len(body)) + body)


def c3d_bytes(positions, occluded, labels, rate: float = 120.0, processor: str = "intel",
              point_format: str = "real", scale: float | None = None) -> bytes:
    """The bytes of a C3D file of `positions` (F, M, 3) with `occluded`
    (F, M) and M `labels`. point_format "real" stores float32 points (scale
    -1); "integer" stores int16 points times `scale` (default: the largest
    |coordinate| over 32000)."""
    pos = np.asarray(positions, np.float64)
    occ = np.asarray(occluded, bool)
    n_frames, n_points, _ = pos.shape
    proc = _PROCESSORS[processor]
    dec = processor == "dec"
    e = ">" if processor == "mips" else "<"  # DEC stores integers little-endian
    real = point_format == "real"
    if not real:
        if scale is None:
            scale = float(np.nanmax(np.abs(np.where(occ[..., None], 0.0, pos)))) / 32000.0
        scale = float(np.float32(max(scale, 1e-6)))

    def f32(v):
        return _dec_float(v) if dec else struct.pack(e + "f", v)

    # parameter section (block 2 on): the POINT group and its parameters
    width = max([len(s) for s in labels] + [1])
    label_bytes = b"".join(s.encode("ascii").ljust(width) for s in labels)
    params = (struct.pack("<bb", 5, -1) + b"POINT" + struct.pack(e + "H", 3) + b"\x00"
              + _param("USED", 1, 2, (), struct.pack(e + "h", n_points), False, e)
              + _param("SCALE", 1, 4, (), f32(-1.0 if real else scale), False, e)
              + _param("RATE", 1, 4, (), f32(rate), False, e)
              + _param("FRAMES", 1, 2, (), struct.pack(e + "h", n_frames), False, e)
              + _param("LABELS", 1, -1, (width, n_points), label_bytes, True, e))
    n_param_blocks = (4 + len(params) + 511) // 512
    param_section = (struct.pack("<BBBB", 1, 0x50, n_param_blocks, proc) + params).ljust(
        512 * n_param_blocks, b"\x00")
    data_block = 2 + n_param_blocks

    header = bytearray(512)
    header[0:2] = bytes((2, 0x50))
    struct.pack_into(e + "HHHHH", header, 2, n_points, 0, 1, n_frames, 10)
    header[12:16] = f32(-1.0 if real else scale)
    struct.pack_into(e + "HH", header, 16, data_block, 0)
    header[20:24] = f32(rate)

    residual = np.where(occ, -1.0, 0.0)
    xyz = np.where(occ[..., None], 0.0, pos)
    if real:
        pts = np.concatenate([xyz, residual[..., None]], axis=-1).astype(np.float32)
        data = _dec_floats(pts) if dec else pts.astype(e + "f4").tobytes()
    else:
        q = np.rint(xyz / scale)
        if np.abs(q).max(initial=0) > 32767:
            raise ValueError("positions out of the int16 range at this scale")
        pts = np.concatenate([q, residual[..., None]], axis=-1).astype(e + "i2")
        data = pts.tobytes()
    data = data.ljust((len(data) + 511) // 512 * 512, b"\x00")
    return bytes(header) + param_section + data


def save_c3d(path, positions, occluded, labels, **kw) -> None:
    with open(path, "wb") as f:
        f.write(c3d_bytes(positions, occluded, labels, **kw))
