"""The parts: session values from the seed, the sample of compared
sessions, the roofline count, the import boundaries, the CLI without a
card, and a cell added by files alone."""

import ast
import json
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import ROOT, small
from fwbench.harness import cell as cellmod
from fwbench.harness import roofline
from fwbench.harness.runner import run_cell


@pytest.mark.parametrize("config", ["mixer64", "effects4"])
def test_session_values_come_from_the_seed(config):
    cfg = cellmod.load_json(ROOT / "fwbench" / "configs" / f"{config}.json")
    mod = cellmod.load_module(ROOT / "fwbench" / "configs" / f"{config}.py")
    a = mod.session_values(cfg, 64, 2 ** 31 + 5, "cpu")
    b = mod.session_values(cfg, 64, 2 ** 31 + 5, "cpu")
    c = mod.session_values(cfg, 64, 2 ** 31 + 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a if a[k].dtype != torch.bool)
    for key, (lo, hi) in cfg["sessions"].items():
        name = {"start_frame": "start_frame"}.get(key, key)
        v = a[name].double()
        assert float(v.min()) >= lo and float(v.max()) <= hi


def test_compared_sessions_cover_the_batch():
    rows = list(range(65536))
    picked = cellmod.sample_sessions(rows, 8, 7)
    assert picked == cellmod.sample_sessions(rows, 8, 7)
    assert [p // 8192 for p in picked] == list(range(8))
    assert picked != cellmod.sample_sessions(rows, 8, 8)


def test_roofline_hand_count_of_a_three_node_island(monkeypatch):
    """filter → echo (D = 480) → clip over 2 sessions, 2 blocks of 4 frames,
    two channels in and out, counted by hand."""
    frames, sessions = 8, 2
    per_session = (
        (12 + 2 * 16)          # filter: params; state z1, z2 a channel, read and written
        + (12 + frames * 16)   # echo: params; 2 channels x (read + write) x 4 B a frame
        + (4 + 2 * 4)          # clip: threshold; its counter
        + frames * 4 * 4)      # 2 channels in, 2 out
    ops = frames * (18 + 10 + 4)
    w = roofline.island_work(["filter", "echo", "hard_clip"], {"echo": {"delay_frames": 480}},
                             sessions, frames, 2, 2)
    assert (w.bytes, w.ops) == (sessions * per_session, sessions * ops)
    # the count does not read the program's lowering tables
    import firewheel_tpu_torch.executor_mega as em

    monkeypatch.setattr(em, "lower_schedule", lambda *a, **k: 1 / 0)
    w2 = roofline.island_work(["filter", "echo", "hard_clip"], {"echo": {"delay_frames": 480}},
                              sessions, frames, 2, 2)
    assert (w2.bytes, w2.ops) == (w.bytes, w.ops)


def test_roofline_hand_count_of_k1():
    """3 sessions, 2 channels, 4 frames: x and y, the state in and out, 5
    coefficients a session; 9 operations a sample."""
    w = roofline.biquad_launch_work(3, 4)
    assert w.bytes == 6 * (2 * 4 * 4 + 4 * 4) + 3 * 20
    assert w.ops == 6 * 4 * 9
    card = "NVIDIA H100 80GB HBM3"
    assert w.least_s(card) == max(w.bytes / 3.35e12, w.ops / 67e12)
    assert w.least_s("another card") is None


def test_references_import_nothing_of_the_program():
    for path in (ROOT / "fwbench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in ("firewheel_tpu_torch", "firewheel_tpu",
                                               "jax"), (path.name, n)


def test_the_harness_loads_neither_jax_nor_the_jax_package(bench):
    """In a fresh process: every module that a run imports, the configs,
    references and metric readers of every cell, and no module whose
    top-level name is jax or firewheel_tpu."""
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
import fwbench.run, fwbench.control
from fwbench.harness import cell, runner
bench = cell.load_json(cell.ROOT / "BENCHMARK.json")
for w in bench["workloads"]:
    c = cell.Cell(bench, w["name"])
    c.config.build(c.cfg, "cpu")
import firewheel_tpu_torch.executor_hybrid, firewheel_tpu_torch.parallel.mesh
print(sorted({{m.split(".")[0] for m in sys.modules}} & {{"jax", "jaxlib", "flax", "firewheel_tpu"}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_without_a_card_prints_nothing_and_fails():
    out = subprocess.run([sys.executable, "fwbench/run.py", "--workload",
                          "mixer64-steady-hybrid", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
                         timeout=300, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode == 2 and out.stdout == ""


def test_a_cell_is_added_by_files_alone(tmp_path, bench):
    """A throwaway traffic file, a throwaway metric reader and a
    BENCHMARK.json that names them, in a checkout of their own: the harness
    runs the new cell without an edit to any file it has."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "fwbench", root / "fwbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", "tests"))
    traffic = small(cellmod.load_json(ROOT / "fwbench" / "traffic" / "steady-hybrid-b131072.json"),
                    batch=16, live=8)
    (root / "fwbench" / "traffic" / "sparse-tiny.json").write_text(json.dumps(traffic))
    (root / "fwbench" / "metrics" / "throwaway.chunks.py").write_text(
        'LAYER = "batch renderer"\nUNIT = "chunks"\nSOURCE = "host_clock"\n'
        'MOVES = "shipped_rtf"\n\n\ndef read(run):\n    return float(run.chunks)\n')
    new = json.loads(json.dumps(bench))
    new["workloads"].append({"name": "mixer64-sparse-tiny", "config": "mixer64",
                             "traffic": "sparse-tiny", "chips": 1, "why": "a test"})
    new["per_layer"].append({"name": "throwaway.chunks", "unit": "chunks", "better": "lower",
                             "source": "host_clock", "layer": "batch renderer",
                             "moves": "shipped_rtf", "workloads": ["mixer64-sparse-tiny"]})
    r = run_cell(new, "mixer64-sparse-tiny", 99, 0.0, True, device="cpu", root=root,
                 chunks=4)
    assert r["correct"]
    assert r["metrics"]["throwaway.chunks"]["value"] == traffic["trace_chunks"]
