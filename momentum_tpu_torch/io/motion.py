"""Binary momentum motion files (.mmo).

Reference layout (momentum/io/motion/mmo_io.cpp:142-171 save, :269-330 load):
  [nParams u64][nJoints u64][nFrames u64]
  nParams × ([len u64][name bytes])
  nJoints × ([len u64][name bytes])
  scale:  nJoints floats  (joint "offsets")
  poses:  nParams × nFrames floats, Eigen column-major (frame-contiguous)

Read and written on the host as numpy, in pure Python.
"""

from __future__ import annotations

import struct

import numpy as np

from momentum_tpu_torch.device import to_host

__all__ = ["save_mmo", "load_mmo"]


def save_mmo(path, poses, scale, parameter_names, joint_names) -> None:
    poses = to_host(poses).astype(np.float32)  # (F, P) convention here
    scale = to_host(scale).astype(np.float32)
    f_cnt, p_cnt = poses.shape
    out = [struct.pack("<QQQ", p_cnt, len(joint_names), f_cnt)]
    for name in list(parameter_names) + list(joint_names):
        b = name.encode()
        out.append(struct.pack("<Q", len(b)) + b)
    out.append(scale.astype("<f4").tobytes())
    # Eigen (params × frames) column-major == (F, P) row-major
    out.append(poses.astype("<f4").tobytes())
    with open(path, "wb") as f:
        f.write(b"".join(out))


def load_mmo(path):
    """→ (poses (F, P) float32, scale (nJoints,), parameter_names,
    joint_names); `path` is a path or the file's bytes."""
    if isinstance(path, (bytes, bytearray)):
        data = bytes(path)
    else:
        with open(path, "rb") as f:
            data = f.read()
    off = 0
    p_cnt, j_cnt, f_cnt = struct.unpack_from("<QQQ", data, off)
    off += 24

    def read_names(n, off):
        names = []
        for _ in range(n):
            (ln,) = struct.unpack_from("<Q", data, off)
            off += 8
            names.append(data[off: off + ln].decode())
            off += ln
        return names, off

    parameter_names, off = read_names(p_cnt, off)
    joint_names, off = read_names(j_cnt, off)
    scale = np.frombuffer(data, "<f4", j_cnt, off).copy()
    off += 4 * j_cnt
    poses = np.frombuffer(data, "<f4", p_cnt * f_cnt, off).reshape(f_cnt, p_cnt).copy()
    return poses, scale, parameter_names, joint_names
