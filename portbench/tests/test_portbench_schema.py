"""BENCHMARK.json against the benchmark's contract, and every name in it
against a file the harness finds."""

import json
import math
import re

import pytest

from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_configs():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
        assert c["reduced"] == [] and json.loads((ROOT / c["file"]).read_text())["reduced"] == []
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_workloads():
    names = [w["name"] for w in BENCH["workloads"]]
    assert len(set(names)) == len(names)
    configs = {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["config"] in configs and w["chips"] == 1
        traffic = json.loads((ROOT / "portbench" / "traffic" / f"{w['name']}.json").read_text())
        assert traffic["limits"] and all(math.isfinite(v) for v in traffic["limits"].values())


def test_metrics():
    e2e, layers = BENCH["end_to_end"], BENCH["per_layer"]
    all_names = [m["name"] for m in e2e + layers]
    assert len(set(all_names)) == len(all_names)
    assert "setup_s" in {m["name"] for m in e2e}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in layers:
        # every per-layer entry names its cells: the harness reads no other rule
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in SOURCES and _line(m["layer"])
        reporting = {c for c in cells
                     for e in e2e if e["name"] == m["moves"] and c in e.get("workloads", cells)}
        assert set(m["workloads"]) <= reporting, m["name"]
    for m in e2e + layers:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (ROOT / "portbench" / "metrics" / f"{m['name'].split('.')[0]}.py").is_file()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    from portbench.run import metrics_of

    e2e = {m["name"] for m in metrics_of(BENCH, cell, "end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert metrics_of(BENCH, cell, "per_layer")
