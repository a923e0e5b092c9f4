"""A cell, a configuration and a per-layer metric added as files are found
by the names BENCHMARK.json gives, with no file of the harness edited."""

import json
import shutil
from types import SimpleNamespace

from conftest import ROOT
from portbench import run


def test_added_files_are_found_by_name(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    config = json.loads((ROOT / "portbench/configs/fullbody_ik.json").read_text())
    config["name"] = "fullbody_ik_wide"
    (tmp_path / "portbench/configs/fullbody_ik_wide.json").write_text(json.dumps(config))
    traffic = json.loads((ROOT / "portbench/traffic/ik.b65536.json").read_text())
    (tmp_path / "portbench/traffic/ik.b256.json").write_text(json.dumps({**traffic, "batch": 256}))
    (tmp_path / "portbench/metrics/calls_seen.py").write_text(
        "def read(run):\n    return float(run.calls)\n")
    bench["configs"].append({"name": "fullbody_ik_wide", "source": "x",
                             "file": "portbench/configs/fullbody_ik_wide.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "ik.b256", "config": "fullbody_ik_wide",
                               "traffic": "ik.b256", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "calls_seen", "unit": "calls", "better": "higher",
                               "source": "host_clock", "layer": "solver",
                               "moves": "frames_per_s.ik", "workloads": ["ik.b256"]})
    cell, cfg, tr = run.resolve_cell(bench, "ik.b256", root=tmp_path)
    assert cell["config"] == "fullbody_ik_wide" and cfg["name"] == "fullbody_ik_wide"
    assert tr["batch"] == 256
    names = [m["name"] for m in run.metrics_of(bench, "ik.b256", "per_layer")]
    assert names == ["calls_seen"]
    reader = run.metric_reader("calls_seen", root=tmp_path)
    assert reader.read(SimpleNamespace(calls=7)) == 7.0
    # a quantity split by its cells keeps one reader
    assert run.metric_reader("calls_seen.ik", root=tmp_path).read(SimpleNamespace(calls=3)) == 3.0
    driver = run.load_module(tmp_path / "portbench/drivers" / f"{cfg['kind']}.py")
    assert callable(driver.build)
    assert "calls_seen" not in [m["name"] for m in run.metrics_of(bench, "ik.b65536", "per_layer")]
