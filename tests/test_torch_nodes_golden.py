"""Golden-output cases of the JAX package's ``tests/test_nodes_golden.py``
that ``test_torch_nodes.py`` does not cover, on the port: the channel
adapters, the beep disabled and clamped, the volume at unity, ramping,
all-silent, muted and with one channel silent, and the sum's refused port
ratio.

Each block runs one instance (no batch axis) through the port's kernel,
the JAX package's kernel and the scalar reference (``reference_dsp.py``)
from the same inputs, params and state: 1e-6 absolute, the engine's
numeric contract (BASELINE.md); masks and integer state equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reference_dsp as ref
from firewheel_tpu import nodes as jn
from firewheel_tpu.core.node import BlockInfo as JBlockInfo
from firewheel_tpu.core.node import NodeActivationError as JActivationError
from firewheel_tpu_torch import nodes as tn
from firewheel_tpu_torch.convert import params_from_jax, state_from_jax, state_to_numpy
from firewheel_tpu_torch.core.node import BlockInfo as TBlockInfo
from firewheel_tpu_torch.core.node import NodeActivationError as TActivationError

SR = 48000
F = 128
TOL = 1e-6


class Pair:
    """One node activated in both packages, stepped block by block from the
    same state; each step holds the port against JAX."""

    def __init__(self, name, args, nin, nout):
        self.nodes = (getattr(jn, name)(*args), getattr(tn, name)(*args))
        self.procs = [n.activate(SR, F, nin, nout) for n in self.nodes]
        self.jstate = self.procs[0].init_state()
        self.tstate = state_from_jax(jax.tree.map(np.asarray, self.jstate), "cpu")

    def set(self, setter, *args):
        for n in self.nodes:
            getattr(n, setter)(*args)

    def step(self, x, mask):
        jp, tp = self.procs
        jo, self.jstate, jm = jp.kernel(jp.collect_params(), self.jstate, jnp.asarray(x),
                                        jnp.asarray(mask), JBlockInfo.make())
        to, self.tstate, tm = tp.kernel(params_from_jax(tp.collect_params(), "cpu"),
                                        self.tstate, torch.from_numpy(x),
                                        torch.from_numpy(mask), TBlockInfo.make())
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=TOL, rtol=0)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        jst = state_to_numpy(state_from_jax(jax.tree.map(np.asarray, self.jstate), "cpu"))
        tst = state_to_numpy(self.tstate)
        for (kj, vj), (kt, vt) in zip(_leaves(jst), _leaves(tst)):
            assert kj == kt
            np.testing.assert_allclose(vt, vj, atol=TOL, rtol=0, err_msg=str(kt))
        return to.numpy(), tm.numpy()


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], path + (k,))]
    return [(path, tree)]


def _inputs(rng, ch, mask=None):
    x = rng.standard_normal((ch, F)).astype(np.float32)
    mask = np.zeros(ch, bool) if mask is None else np.asarray(mask, bool)
    x[mask] = 0.0
    return x, mask


@pytest.mark.parametrize("name,nin,nout,mask", [
    ("MonoToStereoNode", 1, 2, [False]),
    ("MonoToStereoNode", 1, 2, [True]),
    ("StereoToMonoNode", 2, 1, [False, False]),
    ("StereoToMonoNode", 2, 1, [True, False]),
    ("StereoToMonoNode", 2, 1, [True, True]),
])
def test_channel_adapters(name, nin, nout, mask):
    x, m = _inputs(np.random.default_rng(42), nin, mask)
    out, om = Pair(name, (), nin, nout).step(x, m)
    golden = ref.ref_mono_to_stereo if nin == 1 else ref.ref_stereo_to_mono
    rout, rom = golden(x, m)
    np.testing.assert_allclose(out, rout, atol=TOL, rtol=0)
    np.testing.assert_array_equal(om, rom)
    if nin == 1:
        np.testing.assert_array_equal(out, rout)  # a copy, exactly
    if m.all():
        assert (out == 0).all() and om.all()


def test_beep_disabled_is_silent():
    pair = Pair("BeepTestNode", (440.0, -12.0, False), 0, 2)
    phase = int(pair.tstate["phase"])
    out, om = pair.step(np.zeros((0, F), np.float32), np.zeros(0, bool))
    assert (out == 0).all() and om.all()
    assert int(pair.tstate["phase"]) == phase  # the phasor frozen while disabled


@pytest.mark.parametrize("freq,db,clamped_freq,clamped_gain", [
    (5.0, 12.0, 20.0, 1.0),  # beep_test.rs:16-17
    (99999.0, -200.0, 20000.0, 0.0),
])
def test_beep_clamps(freq, db, clamped_freq, clamped_gain):
    for nodes in (jn, tn):
        n = nodes.BeepTestNode(freq, db)
        assert n.freq_hz == clamped_freq and n.gain == clamped_gain


@pytest.mark.parametrize("case", ["unity", "ramp", "muted", "one_channel_silent"])
def test_volume(case):
    """Unity passes the input through; a change at block 2 ramps; 0% mutes
    (silent, flagged); a silent channel reads zero and stays flagged."""
    rng = np.random.default_rng(7)
    percent = {"unity": 100.0, "ramp": 100.0, "muted": 0.0, "one_channel_silent": 75.0}[case]
    x, m = _inputs(rng, 2, [True, False] if case == "one_channel_silent" else None)
    pair = Pair("VolumeNode", (percent,), 2, 2)
    rstate = ref.ref_smoother_init(pair.nodes[1].raw_gain())
    for blk in range(6 if case == "ramp" else 3):
        if case == "ramp" and blk == 2:
            pair.set("set_percent_volume", 50.0)
        out, om = pair.step(x, m)
        rout, rstate, rom = ref.ref_volume(rstate, pair.nodes[1].raw_gain(), x, m, SR)
        np.testing.assert_allclose(out, rout, atol=TOL, rtol=0, err_msg=f"block {blk}")
        np.testing.assert_array_equal(om, rom)
    if case == "unity":
        np.testing.assert_allclose(out, x, atol=TOL, rtol=0)
    if case == "muted":
        assert (out == 0).all() and om.all()
    if case == "one_channel_silent":
        assert (out[0] == 0).all() and om.tolist() == [True, False]


def test_volume_all_silent_resets_the_smoother():
    """A silent block after a change resets the smoother to the new gain:
    the next audible block has no ramp."""
    pair = Pair("VolumeNode", (100.0,), 2, 2)
    pair.set("set_percent_volume", 10.0)
    out, om = pair.step(np.zeros((2, F), np.float32), np.ones(2, bool))
    assert (out == 0).all() and om.all()
    x, m = _inputs(np.random.default_rng(8), 2)
    out, _ = pair.step(x, m)
    np.testing.assert_allclose(out, x * np.float32(pair.nodes[1].raw_gain()), atol=TOL,
                               rtol=0)


@pytest.mark.parametrize("nin,nout", [(3, 2), (5, 2), (4, 3), (2, 4)])
def test_sum_refuses_an_invalid_ratio(nin, nout):
    """Inputs must be a multiple of outputs (sum.rs:42-57), in both packages."""
    with pytest.raises(JActivationError):
        jn.SumNode().activate(SR, F, nin, nout)
    with pytest.raises(TActivationError):
        tn.SumNode().activate(SR, F, nin, nout)
