"""``firewheel_tpu_torch.testing``: the node contract validator and the
naive reference renderer, on the CPU.

As ``tests/test_node_validator.py`` pins for the JAX package: (a) every
built-in node family passes the validator, and (b) each contract violation
class is caught and named under the check the executor relies on.  The
JAX package's ``jit`` check has no counterpart on eager torch: the kernel
that fails it there (branching on a traced value) is a valid eager kernel
here, and the validator passes it.  The naive renderer is held against
the port's executor and against the JAX package's ``NaiveGraphRenderer``
on the same graph at 1e-6.
"""

import numpy as np
import pytest
import torch

import firewheel_tpu as jfw
import firewheel_tpu_torch as ft
from firewheel_tpu import nodes as jn
from firewheel_tpu.testing import NaiveGraphRenderer as JNaive
from firewheel_tpu_torch import nodes as tn
from firewheel_tpu_torch.testing import (
    NaiveGraphRenderer,
    NodeContractError,
    validate_node,
)

SR, F = 48000, 128
TOL = 1e-6

ALL_CHECKS = {"activate", "pytrees", "eager", "determinism", "scan", "vmap",
              "partial_block"}


@pytest.mark.parametrize(
    "make,n_in,n_out",
    [
        (lambda: tn.BeepTestNode(440.0, -12.0, True), 0, 2),
        (lambda: tn.VolumeNode(80.0), 2, 2),
        (lambda: tn.SumNode(), 4, 2),
        (lambda: tn.FilterNode("lowpass", 2000.0), 2, 2),
        (lambda: tn.FilterNode("lowpass", 2000.0, backend="pallas"), 2, 2),
        (lambda: tn.EchoNode(0.05, 0.4), 2, 2),
        (lambda: tn.ParametricEQNode(), 2, 2),
        (lambda: tn.WaveshaperNode("tanh", 6.0), 2, 2),
        (lambda: tn.TremoloNode(5.0, 0.5), 2, 2),
        (lambda: tn.StereoPanNode(0.3), 2, 2),
        (lambda: tn.CompressorNode(), 2, 2),
        (lambda: tn.NoiseNode("pink"), 0, 2),
    ],
    ids=["beep", "volume", "sum", "filter", "filter_pallas", "echo", "eq",
         "waveshaper", "tremolo", "pan", "compressor", "pink_noise"],
)
def test_builtins_pass_validation(make, n_in, n_out):
    report = validate_node(make(), n_in, n_out, device="cpu")
    assert ALL_CHECKS <= set(report)
    assert all(report[c] == "ok" for c in ALL_CHECKS)


# -- deliberately broken nodes: each violation class must be caught --------


class _BrokenBase(ft.AudioNode):
    def info(self):
        return ft.AudioNodeInfo(1, 64, 1, 64)


def _mk(proc_cls):
    class N(_BrokenBase):
        def activate(self, sample_rate, max_block_frames, ni, no):
            return proc_cls(sample_rate, max_block_frames, ni, no)

    return N()


class _WrongShapeProc(ft.NodeProcessor):
    def kernel(self, params, state, inputs, in_mask, info):
        return inputs[..., :-1], state, in_mask  # one frame short


class _ImpureProc(ft.NodeProcessor):
    def kernel(self, params, state, inputs, in_mask, info):
        # host RNG inside the kernel: non-deterministic across calls
        return inputs + float(np.random.default_rng().standard_normal()), state, in_mask


class _StateShapeProc(ft.NodeProcessor):
    def init_state(self):
        return {"z": torch.zeros((2,), dtype=torch.float32)}

    def kernel(self, params, state, inputs, in_mask, info):
        # state leaf grows every block: breaks checkpoints and pooling
        return inputs, {"z": torch.cat([state["z"], state["z"]], dim=-1)}, in_mask


class _FixedFramesProc(ft.NodeProcessor):
    def kernel(self, params, state, inputs, in_mask, info):
        # hard-codes max_block_frames instead of reading inputs.shape[-1]
        out = inputs.new_zeros(inputs.shape[:-2] + (self.num_outputs, self.max_block_frames))
        out[..., : inputs.shape[-1]] = inputs
        return out, state, in_mask


class _AliasedStateProc(ft.NodeProcessor):
    """Returns a view of its state as output and writes that state in place
    the next block: each block alone is right, a chained dispatch that keeps
    its outputs until the end is not."""

    def init_state(self):
        return {"last": torch.zeros((self.num_inputs, self.max_block_frames))}

    def kernel(self, params, state, inputs, in_mask, info):
        last = state["last"]
        out = last[..., : inputs.shape[-1]]
        last[..., : inputs.shape[-1]] = inputs  # written after the read
        return out, state, in_mask


class _TupleStateProc(ft.NodeProcessor):
    def init_state(self):
        return {"z": (torch.zeros(()), torch.zeros(()))}

    def kernel(self, params, state, inputs, in_mask, info):
        return inputs, state, in_mask


class _BatchBlindProc(ft.NodeProcessor):
    """Normalizes by the peak of the whole call: right alone, wrong when
    instances share a batch."""

    def kernel(self, params, state, inputs, in_mask, info):
        return inputs / inputs.abs().max(), state, in_mask


class _UntraceableProc(ft.NodeProcessor):
    """Fails the JAX package's ``jit`` check; eager torch runs it as is."""

    def kernel(self, params, state, inputs, in_mask, info):
        if float(inputs.abs().max()) > 0.5:
            return inputs * 0.5, state, in_mask
        return inputs, state, in_mask


@pytest.mark.parametrize(
    "proc_cls,check",
    [
        (_WrongShapeProc, "eager"),
        (_ImpureProc, "determinism"),
        (_StateShapeProc, "eager"),
        (_FixedFramesProc, "partial_block"),
        (_AliasedStateProc, "scan"),
        (_TupleStateProc, "pytrees"),
        (_BatchBlindProc, "vmap"),
    ],
    ids=lambda v: getattr(v, "__name__", str(v)),
)
def test_violations_are_caught_and_named(proc_cls, check):
    with pytest.raises(NodeContractError) as ei:
        validate_node(_mk(proc_cls), 2, 2, device="cpu")
    assert ei.value.check == check, (
        f"expected check {check!r}, validator flagged {ei.value.check!r}"
    )


def test_jit_check_has_no_counterpart():
    report = validate_node(_mk(_UntraceableProc), 2, 2, device="cpu")
    assert "jit" not in report and all(report[c] == "ok" for c in ALL_CHECKS)


def test_entry_points_default_to_the_card(monkeypatch):
    """Without a card, ``validate_node`` and ``NaiveGraphRenderer`` raise
    unless the caller asks for the CPU: they never fall back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        validate_node(tn.VolumeNode(80.0), 2, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NaiveGraphRenderer(_chain(ft, tn), SR, F)


def test_port_count_outside_declared_range():
    with pytest.raises(NodeContractError) as ei:
        validate_node(tn.StereoPanNode(0.0), 3, 2, device="cpu")  # pan is max 2-in
    assert ei.value.check == "activate"


# -- NaiveGraphRenderer: graph-level oracle matches the executor -----------


def _chain(pkg, nodes):
    """beep → volume → pan → out, built from ``nodes`` (either package's
    node module), the JAX test's graph."""
    g = pkg.AudioGraph(pkg.AudioGraphConfig(0, 2))
    beep = g.add_node(0, 2, nodes.BeepTestNode(440.0, -12.0, True))
    vol = g.add_node(2, 2, nodes.VolumeNode(75.0))
    pan = g.add_node(2, 2, nodes.StereoPanNode(-0.4))
    for a, b in ((beep, vol), (vol, pan)):
        for ch in range(2):
            g.connect(a, ch, b, ch)
    for ch in range(2):
        g.connect(pan, ch, g.graph_out_node(), ch)
    return g


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "standalone"])
def test_naive_renderer_matches_executor_and_jax(shared):
    """Sharing the compile's processors, or activating its own, the port's
    naive renderer gives the port's executor's blocks and the JAX naive
    renderer's."""
    g = _chain(ft, tn)
    pkg = g.compile(SR, F)
    procs = dict(pkg.new_node_processors)
    prog = ft.ScheduleProgram(pkg.schedule, procs, SR, device="cpu")
    ref = NaiveGraphRenderer(g, SR, F, processors=procs if shared else None,
                             device="cpu")
    jg = _chain(jfw, jn)
    jref = JNaive(jg, SR, F)

    params, state = prog.collect_params(), prog.init_state()
    gi, im = torch.zeros((0, F)), torch.zeros((0,), dtype=torch.bool)
    for blk in range(4):
        info = ft.BlockInfo.make(stream_time_secs=blk * F / SR, stream_sample=blk * F)
        out_e, om_e, state = prog.render_block(params, state, gi, im, info)
        out_r, om_r = ref.render_block(gi, im, info)
        out_j, om_j = jref.render_block()
        np.testing.assert_allclose(out_r.numpy(), out_e.numpy(), atol=TOL, rtol=0)
        np.testing.assert_array_equal(om_e.numpy(), om_r)
        np.testing.assert_allclose(out_r.numpy(), np.asarray(out_j), atol=TOL, rtol=0)
        np.testing.assert_array_equal(om_r, om_j)
    assert float(out_r.abs().max()) > 0.05
