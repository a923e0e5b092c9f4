"""No module that the harness or the reference loads is JAX or the JAX
package, compared by whole top-level names (momentum_tpu_torch begins with
momentum_tpu), and the reference loads nothing of the port."""

import subprocess
import sys

from conftest import ROOT
from portbench.run import forbidden_modules

_LOADED = """
import sys
sys.path.insert(0, {root!r})
import {modules}
print(",".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level_names_after_import(*modules) -> set:
    code = _LOADED.format(root=str(ROOT), modules=", ".join(modules))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, timeout=300)
    return set(out.stdout.strip().split(","))


def test_reference_loads_neither_jax_nor_the_port():
    names = _top_level_names_after_import("portbench.reference.ik",
                                          "portbench.reference.sequence")
    assert not names & {"jax", "jaxlib", "flax", "momentum_tpu", "momentum_tpu_torch"}


def test_harness_and_drivers_load_no_jax():
    names = _top_level_names_after_import(
        "portbench.run", "portbench.tracing", "portbench.drivers.ik",
        "portbench.drivers.sequence", "momentum_tpu_torch.solver",
        "momentum_tpu_torch.sequence", "momentum_tpu_torch.errors")
    assert "momentum_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "momentum_tpu"}


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "momentum_tpu_torch_fake.sub", object())
    monkeypatch.setitem(sys.modules, "jaxlike", object())
    found = forbidden_modules(("momentum_tpu", "jax"))
    assert "momentum_tpu_torch_fake.sub" not in found and "jaxlike" not in found
    monkeypatch.setitem(sys.modules, "momentum_tpu.solver", object())
    assert "momentum_tpu.solver" in forbidden_modules(("momentum_tpu",))
