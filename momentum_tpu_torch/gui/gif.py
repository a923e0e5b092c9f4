"""Dependency-free animated GIF writer (GIF89a, LZW-compressed) — the port
of momentum_tpu/gui/gif.py's numpy encoder, this package's own copy.

Backs the offline viewer (gui/viewer.py). Each image is quantized to a
6×7×6 uniform RGB cube (252 colours), plenty for shaded renders. The bytes
equal the JAX package's Python encoder's: the same palette, quantization
and LZW, its string table keyed by (prefix code, index) pairs instead of
whole index tuples, which gives the same codes in time linear in the pixels.
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["save_gif"]

_LEVELS = (6, 7, 6)


def _palette() -> np.ndarray:
    r, g, b = np.meshgrid(np.linspace(0, 255, _LEVELS[0]), np.linspace(0, 255, _LEVELS[1]),
                          np.linspace(0, 255, _LEVELS[2]), indexing="ij")
    pal = np.stack([r, g, b], axis=-1).reshape(-1, 3)
    return np.concatenate([pal, np.zeros((256 - pal.shape[0], 3))]).astype(np.uint8)


def _quantize(frame: np.ndarray) -> np.ndarray:
    f = np.clip(frame, 0, 255).astype(np.float64)
    idx = 0
    for c, levels in enumerate(_LEVELS):
        q = np.round(f[..., c] / 255.0 * (levels - 1)).astype(np.int32)
        idx = idx * levels + q
    return idx.astype(np.uint16)


def _lzw_encode(indices: np.ndarray, min_code_size: int = 8) -> bytes:
    """GIF LZW with code-table resets."""
    clear = 1 << min_code_size
    eoi = clear + 1
    out = bytearray()
    bitbuf = 0
    bitcnt = 0

    def emit(code, size):
        nonlocal bitbuf, bitcnt
        bitbuf |= code << bitcnt
        bitcnt += size
        while bitcnt >= 8:
            out.append(bitbuf & 0xFF)
            bitbuf >>= 8
            bitcnt -= 8

    table = {}  # (prefix code, index) -> code; single indices are their own codes
    next_code = eoi + 1
    code_size = min_code_size + 1
    emit(clear, code_size)
    prefix = None
    for px in indices.ravel().tolist():
        if prefix is None:
            prefix = px
            continue
        code = table.get((prefix, px))
        if code is not None:
            prefix = code
            continue
        emit(prefix, code_size)
        table[(prefix, px)] = next_code
        next_code += 1
        if next_code > (1 << code_size) and code_size < 12:
            code_size += 1
        elif next_code >= 4096:
            emit(clear, code_size)
            table = {}
            next_code = eoi + 1
            code_size = min_code_size + 1
        prefix = px
    if prefix is not None:
        emit(prefix, code_size)
    emit(eoi, code_size)
    if bitcnt:
        out.append(bitbuf & 0xFF)
    return bytes(out)


def save_gif(path: str, frames, fps: float = 15.0, loop: int = 0) -> None:
    """Write frames (F, H, W, 3) uint8 (or float in [0, 1]) as an animated
    GIF."""
    frames = np.asarray(frames)
    if frames.dtype != np.uint8:
        frames = (np.clip(frames, 0.0, 1.0) * 255).astype(np.uint8)
    if frames.ndim == 3:
        frames = frames[None]
    f, h, w, _ = frames.shape
    delay = max(int(round(100.0 / fps)), 2)  # hundredths of a second
    with open(path, "wb") as fh:
        fh.write(b"GIF89a")
        fh.write(struct.pack("<HHBBB", w, h, 0xF7, 0, 0))  # global colour table 256, 8 bpp
        fh.write(_palette().tobytes())
        # the Netscape loop extension
        fh.write(b"\x21\xFF\x0BNETSCAPE2.0\x03\x01" + struct.pack("<H", loop) + b"\x00")
        for i in range(f):
            fh.write(b"\x21\xF9\x04\x04" + struct.pack("<H", delay) + b"\x00\x00")  # control
            fh.write(b"\x2C" + struct.pack("<HHHHB", 0, 0, w, h, 0))
            fh.write(bytes([8]))  # LZW minimum code size
            data = _lzw_encode(_quantize(frames[i]))
            for off in range(0, len(data), 255):
                chunk = data[off:off + 255]
                fh.write(bytes([len(chunk)]) + chunk)
            fh.write(b"\x00")
        fh.write(b"\x3B")
