"""Whole runs of each cell on the CPU at a small size, past the look for a
card: the plain reference against the port, the control (the reference
in bfloat16) against the limit, and the timed path broken underneath."""

import pytest
import torch

from conftest import small
from fwbench.control import control_reading
from fwbench.harness import cell as cellmod
from fwbench.harness.runner import run_cell

CELLS = ["mixer64-steady-hybrid", "effects4-steady-hybrid", "mixer64-steady-eager"]
SEED = 2 ** 31 + 12345


def _run(bench, name, seed=SEED, trace=False, fault=None, **over):
    traffic = small(cellmod.Cell(bench, name).traffic, **over)
    return run_cell(bench, name, seed, 0.0, trace, device="cpu", traffic=traffic,
                    fault=fault, chunks=22)


@pytest.mark.parametrize("name", CELLS)
def test_reference_matches_the_port(bench, name):
    """The port, rendered on the CPU through the cell's own path, against
    the plain reference: within one LSB of int16 over every chunk."""
    r = _run(bench, name)
    assert r["correct"] and r["failed"] == 0
    assert r["check"]["max_lsb_gap"]["value"] <= 1
    assert list(r)[-1] == "check"
    names = {m["name"] for m in bench["end_to_end"] if cellmod.applies(m, name)}
    assert set(r["metrics"]) == names


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reports_per_layer_metrics(bench, name):
    r = _run(bench, name, trace=True)
    assert r["correct"]
    assert "busy_s" in r["device"] and "window_s" in r["device"]
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    allowed = {m["name"] for m in bench["per_layer"] if cellmod.applies(m, name)}
    assert set(r["metrics"]) <= allowed


@pytest.mark.parametrize("name", ["mixer64-steady-hybrid", "effects4-steady-hybrid"])
def test_control_fails_the_check(bench, name):
    """The reference in bfloat16, put in the program's place, reads far
    above the limit that sound runs keep."""
    cell = cellmod.Cell(bench, name, small(cellmod.Cell(bench, name).traffic))
    r = control_reading(cell, SEED, 6, torch.device("cpu"))
    assert r["max_lsb_gap"] > 3 * r["limit"], r


def _state_unchanged(fleet):
    render = fleet.renderer.render_chunk

    def broken(params, state, **kw):
        out, mask, _new = render(params, state, **kw)
        return out, mask, state
    fleet.renderer.render_chunk = broken


def _half_batch(fleet):
    render = fleet.renderer.render_chunk

    def broken(params, state, **kw):
        out, mask, new = render(params, state, **kw)
        out = out.clone()
        out[out.shape[0] // 2:] = 0
        return out, mask, new
    fleet.renderer.render_chunk = broken


def _altered(fleet):
    render = fleet.renderer.render_chunk

    def broken(params, state, **kw):
        out, mask, new = render(params, state, **kw)
        out = out.clone()
        out[:, 0, 0, 0] = torch.where(out[:, 0, 0, 0] > 0, out[:, 0, 0, 0] - 100,
                                      out[:, 0, 0, 0] + 100)
        return out, mask, new
    fleet.renderer.render_chunk = broken


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _altered],
                         ids=["state-unchanged", "half-batch", "answer-altered"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_path_is_not_correct(bench, name, fault):
    r = _run(bench, name, fault=fault)
    assert not r["correct"] and r["failed"] > 0
