"""Package-level properties of the port: it imports no jax, and on CPU
tensors its kernel wrappers take their plain PyTorch versions without
counting a launch."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from momentum_tpu_torch.ops import fk as fk_ops, psd, raster
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
        "new = {'momentum_tpu_torch.errors.limit', 'momentum_tpu_torch.errors.pose_prior',\n"
        "       'momentum_tpu_torch.solver.ik', 'momentum_tpu_torch.ops.chol'}\n"
        "assert new <= set(names), sorted(new - set(names))\n"
        "assert len(names) >= 30, names\n"
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
    char, ef0, targets, x0 = workloads.build_fullbody_ik_problem(8, seed=1, device="cpu")
    local = torch.randn(8, char.num_joints, 8)
    np.testing.assert_array_equal(fk_ops.fk_global(char.skeleton, local).numpy(),
                                  fk_ops.fk_global_plain(char.skeleton, local).numpy())
    res = workloads.make_solve_batch(char, ef0, 8)(targets, x0)
    assert torch.isfinite(res.error).all()
    assert fk_ops.launches == 0
    assert psd.launches == 0


def test_cpu_render_launches_no_kernel():
    """A frame of the render clip on CPU tensors takes the plain rasterizer
    and counts no K1, K4a or K4b launch."""
    char, motion, cam = workloads.build_render_clip(frames=1, image_height=48,
                                                    image_width=64, device="cpu")
    before = dict(raster.launches)
    imgs = workloads.make_render_clip(char, cam, width=32, height=24,
                                      shadow_resolution=32)(motion)
    assert imgs.shape == (1, 24, 32, 3) and bool((imgs > 0).any())
    assert raster.launches == before and fk_ops.launches == 0


def test_cpu_fullstack_launches_no_kernel():
    """The full-stack GN solve on CPU tensors takes the plain versions: no
    K1 or K2+K3 launch (K5a and K5b reach K2+K3's kernel)."""
    char, efs, targets, q, x0 = workloads.build_fullstack_problem(8, seed=1, device="cpu")
    before = (fk_ops.launches, psd.launches)
    params, energy = workloads.make_fullstack_solve(char, efs, 8)(targets, q, x0)
    assert params.shape == x0.shape and bool(torch.isfinite(energy).all())
    assert float(energy.max()) < 1e-3
    assert (fk_ops.launches, psd.launches) == before


@pytest.mark.parametrize("entry,args", [
    ("build_fullbody_ik_problem", (8,)),
    ("build_fullstack_problem", (8,)),
    ("build_render_clip", (1,)),
])
def test_workloads_default_to_the_card(monkeypatch, entry, args):
    """The workload entry points build on the card unless the caller asks for
    the CPU; with no card, the default raises and names the way out instead
    of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(workloads, entry)(*args)
