"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and includes no PyTorch
header, so nvcc builds it in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas=-v -o lib<name>-<hash>.so csrc/<name>.cu

The library goes to `build/momentum_tpu_torch/` at the root of the checkout,
named by a hash of its source and the flags: an edited source builds anew, an
unchanged one is reused. ptxas's report (registers, shared memory, spills) is
kept beside it as `<library>.log`. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

__all__ = ["BUILD_DIR", "CSRC", "build", "load", "nvcc_path"]

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "momentum_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    """nvcc from PATH, else from $CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH, in $CUDA_HOME/bin or "
                           "/usr/local/cuda/bin: the CUDA kernels cannot be built")
    return path


def _library_path(name: str) -> pathlib.Path:
    key = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def build(name: str) -> pathlib.Path:
    """Compile csrc/<name>.cu unless a library of the same source exists."""
    out = _library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{proc.stderr}")
        pathlib.Path(str(out) + ".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)  # atomic: concurrent builders never load a half file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _loaded[name] = lib
        return lib
