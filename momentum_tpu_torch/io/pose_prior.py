"""MPPCA pose-prior files (.mppca).

Reference layout (momentum/io/skeleton/mppca_io.cpp:37-145):
  [d u64][p u64]
  d × ([len u64][name bytes])           — parameter names per data dimension
  Rpre: p floats
  Cinv: p × (d×d floats, column-major)  — symmetric, so order is moot
  mu:   p×d floats, Eigen column-major
L is recomputed on load as chol(Cinv) with LᵀL = Cinv (mppca_io.cpp:102).
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from momentum_tpu_torch.device import resolve, to_host
from momentum_tpu_torch.errors.pose_prior import Mppca

__all__ = ["load_mppca", "save_mppca"]


def mppca_from_bytes(data: bytes, device="cuda") -> Mppca:
    """The Mppca of a .mppca file's bytes, on `device` (the card unless the
    caller asks for the CPU)."""
    device = resolve(device, "load_mppca")
    off = 0
    d, p = struct.unpack_from("<QQ", data, off)
    off += 16
    names = []
    for _ in range(d):
        (ln,) = struct.unpack_from("<Q", data, off)
        off += 8
        names.append(data[off: off + ln].decode())
        off += ln
    rpre = np.frombuffer(data, "<f4", p, off).copy()
    off += 4 * p
    cinv = np.zeros((p, d, d), np.float32)
    for c in range(p):
        cinv[c] = np.frombuffer(data, "<f4", d * d, off).reshape(d, d, order="F")
        off += 4 * d * d
    mu = np.frombuffer(data, "<f4", p * d, off).reshape(p, d, order="F").copy()

    l = np.zeros_like(cinv)
    for c in range(p):
        l[c] = np.linalg.cholesky(cinv[c].astype(np.float64)).T.astype(np.float32)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return Mppca(mu=t(mu), cinv=t(cinv), l=t(l), rpre=t(rpre), names=tuple(names))


def load_mppca(path, device="cuda") -> Mppca:
    with open(path, "rb") as f:
        data = f.read()
    return mppca_from_bytes(data, device)


def mppca_to_bytes(mppca: Mppca) -> bytes:
    """The .mppca file's bytes of a mixture on any device."""
    d = mppca.dim
    p = mppca.num_components
    names = mppca.names or tuple(f"p{i}" for i in range(d))
    out = [struct.pack("<QQ", d, p)]
    for n in names[:d]:
        b = n.encode()
        out.append(struct.pack("<Q", len(b)) + b)
    out.append(to_host(mppca.rpre).astype("<f4").tobytes())
    cinv = to_host(mppca.cinv)
    for c in range(p):
        out.append(cinv[c].astype("<f4").T.tobytes())  # column-major
    out.append(to_host(mppca.mu).astype("<f4").T.tobytes())  # column-major (p, d)
    return b"".join(out)


def save_mppca(path, mppca: Mppca) -> None:
    data = mppca_to_bytes(mppca)
    with open(path, "wb") as f:
        f.write(data)
