"""SignedDistanceField msgpack IO (axel/SignedDistanceFieldIO.{h,cpp};
pymomentum.axel save/load_sdf[s]_to/from_msgpack), the port's own copy of
momentum_tpu/axel/sdf_io.py: the files it writes are byte-equal to JAX's,
and the loaders put the field on the device asked for (the card unless the
caller asks for the CPU).

Schema (sdfToJsonObject): a msgpack map {"bounds_min": [3 floats],
"bounds_max": [3 floats], "resolution": [3 ints], "data": bin} with the
field values as little-endian float32 in x-fastest order
(linear = k·nx·ny + j·nx + i, SignedDistanceField.cpp:336). The multi-SDF
variant maps name → {"sdf": <map>, "parent_joint"?: str}.

The package depends on no msgpack library, so this implements the subset of the
format the schema needs (maps, arrays, strings, ints, floats, bin).
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from momentum_tpu_torch.device import resolve, to_host

__all__ = [
    "save_sdf_to_msgpack",
    "load_sdf_from_msgpack",
    "save_sdfs_to_msgpack",
    "load_sdfs_from_msgpack",
]


# ---- minimal msgpack codec ----


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif isinstance(obj, bool):
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, (int, np.integer)):
        v = int(obj)
        if 0 <= v < 128:
            out.append(v)
        elif -32 <= v < 0:
            out.append(v & 0xFF)
        elif -(1 << 31) <= v < (1 << 31):
            out.append(0xD2)
            out += struct.pack(">i", v)
        else:
            out.append(0xD3)
            out += struct.pack(">q", v)
    elif isinstance(obj, (float, np.floating)):
        out.append(0xCA)
        out += struct.pack(">f", float(obj))
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        if len(b) < 32:
            out.append(0xA0 | len(b))
        else:
            out.append(0xD9)
            out.append(len(b))
        out += b
    elif isinstance(obj, (bytes, bytearray)):
        n = len(obj)
        if n < 256:
            out.append(0xC4)
            out.append(n)
        elif n < (1 << 16):
            out.append(0xC5)
            out += struct.pack(">H", n)
        else:
            out.append(0xC6)
            out += struct.pack(">I", n)
        out += obj
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        if n < 16:
            out.append(0x90 | n)
        else:
            out.append(0xDC)
            out += struct.pack(">H", n)
        for it in obj:
            _pack(it, out)
    elif isinstance(obj, dict):
        n = len(obj)
        if n < 16:
            out.append(0x80 | n)
        else:
            out.append(0xDE)
            out += struct.pack(">H", n)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot msgpack {type(obj)}")


def _unpack(buf: bytes, pos: int = 0):
    b = buf[pos]
    pos += 1
    if b < 0x80:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if 0x80 <= b <= 0x8F:
        return _unpack_map(buf, pos, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return _unpack_array(buf, pos, b & 0x0F)
    if 0xA0 <= b <= 0xBF:
        n = b & 0x1F
        return buf[pos:pos + n].decode("utf-8"), pos + n
    if b == 0xC0:
        return None, pos
    if b == 0xC2:
        return False, pos
    if b == 0xC3:
        return True, pos
    if b == 0xC4:
        n = buf[pos]
        return bytes(buf[pos + 1:pos + 1 + n]), pos + 1 + n
    if b == 0xC5:
        n = struct.unpack_from(">H", buf, pos)[0]
        return bytes(buf[pos + 2:pos + 2 + n]), pos + 2 + n
    if b == 0xC6:
        n = struct.unpack_from(">I", buf, pos)[0]
        return bytes(buf[pos + 4:pos + 4 + n]), pos + 4 + n
    if b == 0xCA:
        return struct.unpack_from(">f", buf, pos)[0], pos + 4
    if b == 0xCB:
        return struct.unpack_from(">d", buf, pos)[0], pos + 8
    if b == 0xCC:
        return buf[pos], pos + 1
    if b == 0xCD:
        return struct.unpack_from(">H", buf, pos)[0], pos + 2
    if b == 0xCE:
        return struct.unpack_from(">I", buf, pos)[0], pos + 4
    if b == 0xCF:
        return struct.unpack_from(">Q", buf, pos)[0], pos + 8
    if b == 0xD0:
        return struct.unpack_from(">b", buf, pos)[0], pos + 1
    if b == 0xD1:
        return struct.unpack_from(">h", buf, pos)[0], pos + 2
    if b == 0xD2:
        return struct.unpack_from(">i", buf, pos)[0], pos + 4
    if b == 0xD3:
        return struct.unpack_from(">q", buf, pos)[0], pos + 8
    if b == 0xD9:
        n = buf[pos]
        return buf[pos + 1:pos + 1 + n].decode("utf-8"), pos + 1 + n
    if b == 0xDA:
        n = struct.unpack_from(">H", buf, pos)[0]
        return buf[pos + 2:pos + 2 + n].decode("utf-8"), pos + 2 + n
    if b == 0xDC:
        n = struct.unpack_from(">H", buf, pos)[0]
        return _unpack_array(buf, pos + 2, n)
    if b == 0xDD:
        n = struct.unpack_from(">I", buf, pos)[0]
        return _unpack_array(buf, pos + 4, n)
    if b == 0xDE:
        n = struct.unpack_from(">H", buf, pos)[0]
        return _unpack_map(buf, pos + 2, n)
    if b == 0xDF:
        n = struct.unpack_from(">I", buf, pos)[0]
        return _unpack_map(buf, pos + 4, n)
    raise ValueError(f"unsupported msgpack byte {b:#x}")


def _unpack_array(buf, pos, n):
    out = []
    for _ in range(n):
        v, pos = _unpack(buf, pos)
        out.append(v)
    return out, pos


def _unpack_map(buf, pos, n):
    out = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos)
        v, pos = _unpack(buf, pos)
        out[k] = v
    return out, pos


# ---- SDF <-> schema ----


def _sdf_to_obj(sdf) -> dict:
    vals = np.asarray(to_host(sdf.values), np.float32)
    origin = np.asarray(to_host(sdf.origin), np.float64)
    spacing = np.asarray(to_host(sdf.spacing), np.float64)
    res = list(vals.shape)
    bounds_min = origin
    bounds_max = origin + spacing * np.asarray(res)
    # reference layout: linear = k·nx·ny + j·nx + i (x fastest)
    data = np.ascontiguousarray(vals.transpose(2, 1, 0)).astype("<f4").tobytes()
    return {
        "bounds_min": [float(x) for x in bounds_min],
        "bounds_max": [float(x) for x in bounds_max],
        "resolution": res,
        "data": data,
    }


def _obj_to_sdf(obj: dict, device):
    from momentum_tpu_torch.axel.sdf import SignedDistanceField

    bmin = np.asarray(obj["bounds_min"], np.float64)
    bmax = np.asarray(obj["bounds_max"], np.float64)
    res = [int(x) for x in obj["resolution"]]
    data = np.frombuffer(obj["data"], "<f4")
    if data.size != res[0] * res[1] * res[2]:
        raise ValueError("SDF data size does not match resolution")
    vals = data.reshape(res[2], res[1], res[0]).transpose(2, 1, 0)
    spacing = (bmax - bmin) / np.asarray(res, np.float64)
    f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)
    return SignedDistanceField(origin=f32(bmin), spacing=f32(spacing), values=f32(vals))


def save_sdf_to_msgpack(sdf, path) -> None:
    out = bytearray()
    _pack(_sdf_to_obj(sdf), out)
    with open(path, "wb") as f:
        f.write(bytes(out))


def load_sdf_from_msgpack(path, device="cuda"):
    """The field of a file save_sdf_to_msgpack wrote, on `device`."""
    device = resolve(device, "load_sdf_from_msgpack")
    with open(path, "rb") as f:
        obj, _ = _unpack(f.read())
    return _obj_to_sdf(obj, device)


def save_sdfs_to_msgpack(sdfs: dict, path) -> None:
    """`sdfs` maps name → SignedDistanceField or (SignedDistanceField,
    parent_joint)."""
    doc = {}
    for name, entry in sdfs.items():
        if isinstance(entry, tuple):
            sdf, parent = entry
        else:
            sdf, parent = entry, ""
        e = {"sdf": _sdf_to_obj(sdf)}
        if parent:
            e["parent_joint"] = parent
        doc[name] = e
    out = bytearray()
    _pack(doc, out)
    with open(path, "wb") as f:
        f.write(bytes(out))


def load_sdfs_from_msgpack(path, device="cuda") -> dict:
    """→ dict name → (SignedDistanceField on `device`, parent_joint)."""
    device = resolve(device, "load_sdfs_from_msgpack")
    with open(path, "rb") as f:
        doc, _ = _unpack(f.read())
    return {name: (_obj_to_sdf(e["sdf"], device), e.get("parent_joint", ""))
            for name, e in doc.items()}
