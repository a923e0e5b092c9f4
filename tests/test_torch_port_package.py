"""Package-level properties of the port: it imports no jax, and on CPU
tensors its kernel wrappers take their plain PyTorch versions without
counting a launch."""

import pathlib
import subprocess
import sys

import numpy as np
import torch

from momentum_tpu_torch.ops import fk as fk_ops, psd
from momentum_tpu_torch.testing import workloads

REPO = pathlib.Path(__file__).resolve().parents[1]


def test_port_imports_no_jax():
    """Every module of the port imports in a fresh interpreter without
    pulling in jax or momentum_tpu (the test process itself has jax loaded,
    hence the subprocess)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import momentum_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, 'momentum_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'momentum_tpu'))\n"
        "assert not bad, bad\n"
        "assert len(names) >= 20, names\n"
        "print('ok', len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_import_sets_full_f32_matmul_precision():
    assert torch.get_float32_matmul_precision() == "highest"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_cpu_path_launches_no_kernel():
    """On CPU tensors the wrappers take the plain versions and leave their
    launch counters at 0, through a whole small solve too."""
    char, ef0, targets, x0 = workloads.build_fullbody_ik_problem(8, seed=1)
    local = torch.randn(8, char.num_joints, 8)
    np.testing.assert_array_equal(fk_ops.fk_global(char.skeleton, local).numpy(),
                                  fk_ops.fk_global_plain(char.skeleton, local).numpy())
    res = workloads.make_solve_batch(char, ef0, 8)(targets, x0)
    assert torch.isfinite(res.error).all()
    assert fk_ops.launches == 0
    assert psd.launches == 0
