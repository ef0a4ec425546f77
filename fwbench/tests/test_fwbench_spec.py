"""BENCHMARK.json against the benchmark's contract: names, units, keys,
bounds, and the metrics' readers."""

import json
import math
import re

import pytest

from conftest import ROOT
from fwbench.harness import cell as cellmod

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_paths(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["fwbench"]
    assert bench["command"][:2] == ["python3", "fwbench/run.py"]
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 * 1024
    # every cell of 24 fits the check's 43 200 seconds at this length
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_every_name_and_unit(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("fwbench/")
        assert (ROOT / c["file"]).exists()
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
        names.append(c["name"])
    assert len(set(names)) == len(names)
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (ROOT / "fwbench" / "traffic" / f"{w['traffic']}.json").exists()
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES


def test_end_to_end_bounds(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in bench["workloads"]}
    for cell in cells:
        reported = [m for m in e2e.values() if cellmod.applies(m, cell)]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2


def test_every_per_layer_metric_moves_what_its_cells_report(bench):
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["workloads"] and set(m["workloads"]) <= cells
        (moved,) = [e for e in bench["end_to_end"] if e["name"] == m["moves"]]
        for cell in m["workloads"]:
            assert cellmod.applies(moved, cell), (m["name"], cell)
    for cell in cells:
        assert any(cellmod.applies(m, cell) for m in bench["per_layer"])


@pytest.mark.parametrize("name", ["render.enqueue_ms", "render.launches_per_block",
                                  "egress.copy_ms", "k3_roofline", "k1_roofline",
                                  "torch_ops.device_ms", "device.idle_pct",
                                  "device.peak_gib"])
def test_reader_declares_its_entry(bench, name):
    (m,) = [m for m in bench["per_layer"] if m["name"] == name]
    reader = cellmod.load_module(ROOT / "fwbench" / "metrics" / f"{name}.py")
    assert (reader.LAYER, reader.UNIT, reader.MOVES, reader.SOURCE) == (
        m["layer"], m["unit"], m["moves"], m["source"])
    # a kernel's roofline share is named <kernel>_roofline, in %
    if "roofline" in name:
        assert name.endswith("_roofline") and m["unit"] == "%"


def test_layers_are_named_alike(bench):
    """Metrics of one layer give the same layer, letter for letter, and
    PERF.md's list of layers names each."""
    perf = (ROOT / "PERF.md").read_text()
    for m in bench["per_layer"]:
        assert m["layer"] in perf, m["layer"]


def test_configs_state_their_limits_and_no_cut(bench):
    for c in bench["configs"]:
        cfg = cellmod.load_json(ROOT / c["file"])
        assert cfg["reduced"] == c["reduced"] == []
        limit = cfg["correct"]["max_lsb_gap"]
        assert isinstance(limit, int) and limit >= 0
        assert not math.isnan(limit)
