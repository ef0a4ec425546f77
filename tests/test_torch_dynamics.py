"""The dynamics primitives and nodes (``ops/dynamics.py``,
``nodes/dynamics.py``) held against the JAX package on the CPU.

Each node kernel gets the same seeded inputs, params and state in both
packages, B=4 instances (``vmap`` on the JAX side), under audible, silent
and mixed input masks (``test_torch_nodes.run_both``): outputs and float
state within 1e-6 absolute, masks and the rest equal.  The recurrences run
through ``scan_lanes``'s plain version, which writes out the fused
multiply-adds that XLA makes of each scan body on the CPU, so they equal
JAX's scans bit for bit (asserted below); the dB conversions around them
may differ by an ulp of torch's and XLA's pow and log10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from firewheel_tpu import nodes as jn
from firewheel_tpu.core.node import NodeActivationError as JaxActivationError
from firewheel_tpu.ops import dynamics as jd
from firewheel_tpu_torch import nodes as tn
from firewheel_tpu_torch.convert import params_from_jax, state_from_jax, state_to_numpy
from firewheel_tpu_torch.core.node import NodeActivationError
from firewheel_tpu_torch.ops import dynamics as td
from test_torch_nodes import B, F, MASKS, SR, _mask, run_both

LANES = 64


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _levels(rng, shape, scale=0.3):
    return np.abs(rng.standard_normal(shape) * scale).astype(np.float32)


def test_envelope_follow_equals_jax_bit_for_bit():
    rng = np.random.default_rng(1)
    lvl = _levels(rng, (LANES, F))
    env0 = _levels(rng, (LANES,))
    att = rng.uniform(0.9, 1.0, LANES).astype(np.float32)
    rel = rng.uniform(0.99, 1.0, LANES).astype(np.float32)
    je, jl = jax.vmap(jd.envelope_follow)(lvl, env0, att, rel)
    te, tl = td.envelope_follow(_t(lvl), _t(env0), _t(att), _t(rel))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def _limiter_jax(env, need, rel):
    def step(e, g):
        e = jnp.minimum(g, rel * e + (1.0 - rel) * g)
        return e, e
    return jd.sample_scan(step, env, need)


def _gate_jax(carry, lvl, p):
    def step(c, lv):
        opn, hold, g = c
        above = lv >= p[0]
        below = lv < p[1]
        expired = hold <= 0.0
        opn = jnp.where(above, 1.0, jnp.where(below & expired, 0.0, opn))
        hold = jnp.where(above, p[5], jnp.maximum(hold - 1.0, 0.0))
        target = opn + (1.0 - opn) * p[2]
        b = jnp.where(target > g, p[3], p[4])
        g = b * g + (1.0 - b) * target
        return (opn, hold, g), g
    return jd.sample_scan(step, carry, lvl)


@pytest.mark.parametrize("kind", ["limiter", "gate"])
def test_scan_kinds_equal_jax_scans_bit_for_bit(kind):
    """The limiter's release and the gate's latch, through ``scan_lanes``,
    against the JAX nodes' scan bodies (their code, vmapped over lanes)."""
    rng = np.random.default_rng(2)
    if kind == "limiter":
        need = np.minimum(1.0, rng.uniform(0.2, 1.5, (LANES, F))).astype(np.float32)
        env = rng.uniform(0.2, 1.0, LANES).astype(np.float32)
        rel = rng.uniform(0.99, 1.0, LANES).astype(np.float32)
        jc, jy = jax.vmap(_limiter_jax)(env, need, rel)
        (tc,), ty = td.scan_lanes(td.LIMITER, _t(need), (_t(env),), (_t(rel),))
        jc = (jc,)
        tc = (tc,)
    else:
        lvl = _levels(rng, (LANES, F), 0.05)
        carry = (rng.integers(0, 2, LANES).astype(np.float32),
                 rng.integers(0, 30, LANES).astype(np.float32),
                 rng.uniform(0.0, 1.0, LANES).astype(np.float32))
        coefs = tuple(np.full(LANES, v, np.float32) for v in
                      (0.03, 0.015, 0.1, np.exp(-1 / 48.0), np.exp(-1 / 4800.0), 20.0))
        jc, jy = jax.vmap(_gate_jax)(carry, lvl, coefs)
        tc, ty = td.scan_lanes(td.GATE, _t(lvl), tuple(map(_t, carry)),
                               tuple(map(_t, coefs)))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    for a, b in zip(tc, jc, strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_scan_lanes_refuses_bad_operands():
    x = torch.zeros((2, F))
    with pytest.raises(ValueError, match="unknown kind"):
        td.scan_lanes(7, x, (), ())
    with pytest.raises(ValueError, match="carry leaves"):
        td.scan_lanes(td.ENVELOPE, x, (), (0.5, 0.5))
    with pytest.raises(TypeError):
        td.scan_lanes(td.PINK, x.double(), (0.0, 0.0, 0.0), ())


def test_compressor_gain_db_and_sliding_max_equal_jax():
    rng = np.random.default_rng(3)
    level_db = rng.uniform(-60.0, 6.0, (LANES, F)).astype(np.float32)
    level_db[0, :4] = -np.inf  # a silent envelope
    thr = rng.uniform(-30.0, -6.0, (LANES, 1)).astype(np.float32)
    ratio = rng.uniform(1.0, 10.0, (LANES, 1)).astype(np.float32)
    knee = rng.uniform(0.0, 12.0, (LANES, 1)).astype(np.float32)
    knee[1] = 0.0  # a hard knee
    jg = jd.compressor_gain_db(level_db, thr, ratio, knee)
    tg = td.compressor_gain_db(_t(level_db), _t(thr), _t(ratio), _t(knee))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6, rtol=0)
    x = _levels(rng, (3, 5, F + 143))
    for window in (1, 2, 144):
        np.testing.assert_array_equal(td.sliding_max(_t(x), window).numpy(),
                                      np.asarray(jd.sliding_max(jnp.asarray(x), window)))


def _draw(rng, lo, hi, n=B):
    return rng.uniform(lo, hi, n).astype(np.float32)


def _comp_params(rng):
    return {
        "threshold_db": _draw(rng, -30.0, -6.0),
        "ratio": _draw(rng, 1.0, 8.0),
        "knee_db": np.array([0.0, 3.0, 6.0, 12.0], np.float32),
        "makeup": _draw(rng, 0.5, 2.0),
        "att_b": _draw(rng, 0.99, 0.999),
        "rel_b": _draw(rng, 0.999, 0.99999),
    }


@pytest.mark.parametrize("mask_kind", MASKS)
def test_compressor(mask_kind):
    rng = np.random.default_rng(4)
    params = _comp_params(rng)
    state = {"env": _levels(rng, (B,))}
    x = (rng.standard_normal((B, 2, F)) * 0.4).astype(np.float32)
    run_both(jn.CompressorNode(), tn.CompressorNode(), 2, 2, params, state, x,
             _mask(mask_kind, rng, (B, 2)))


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("lookahead", [0.001, 0.003])
def test_limiter_over_three_blocks(mask_kind, lookahead):
    """48 and 144 frames of lookahead (the bus's 3 ms, longer than a block):
    the delay line and the level tail carry across blocks."""
    rng = np.random.default_rng(5)
    node_j = jn.LimiterNode(ceiling_db=-1.0, lookahead_secs=lookahead)
    node_t = tn.LimiterNode(ceiling_db=-1.0, lookahead_secs=lookahead)
    la = node_t.latency_frames(SR)
    params = {"ceiling": _draw(rng, 0.5, 1.0), "rel_b": _draw(rng, 0.999, 0.9999)}
    state = {
        "delay": (rng.standard_normal((B, 2, la)) * 0.5).astype(np.float32),
        "level_tail": _levels(rng, (B, la), 0.8),
        "env": _draw(rng, 0.3, 1.0),
    }
    state["delay"][0] = 0.0  # a quiet line: the mask passes through
    for _ in range(3):
        x = (rng.standard_normal((B, 2, F)) * 0.6).astype(np.float32)
        _, state, _ = run_both(node_j, node_t, 2, 2, params, state, x,
                               _mask(mask_kind, rng, (B, 2)))


@pytest.mark.parametrize("mask_kind", MASKS)
def test_gate(mask_kind):
    rng = np.random.default_rng(6)
    params = {
        "open_lin": _draw(rng, 0.02, 0.05),
        "close_lin": _draw(rng, 0.005, 0.02),
        "floor": np.array([0.0, 0.1, 1e-4, 0.5], np.float32),
        "att_b": _draw(rng, 0.9, 0.99),
        "rel_b": _draw(rng, 0.999, 0.9999),
        "hold_n": np.array([0.0, 10.0, 48.0, 2400.0], np.float32),
    }
    state = {"open": np.array([0, 1, 1, 0], np.float32),
             "hold": np.array([0, 5, 100, 3], np.float32),
             "gain": _draw(rng, 0.0, 1.0)}
    x = (rng.standard_normal((B, 2, F)) * 0.03).astype(np.float32)
    run_both(jn.GateNode(), tn.GateNode(), 2, 2, params, state, x,
             _mask(mask_kind, rng, (B, 2)))


@pytest.mark.parametrize("mask_kind", MASKS)
def test_ducker(mask_kind):
    """Main bus of 2 channels, a sidechain of 2 (one instance's sidechain
    silent: its envelope is 0, −inf dB, and the gain 1)."""
    rng = np.random.default_rng(7)
    params = {
        "threshold_db": _draw(rng, -46.0, -34.0),
        "duck_db": _draw(rng, -18.0, -6.0),
        "att_b": _draw(rng, 0.99, 0.999),
        "rel_b": _draw(rng, 0.999, 0.99999),
    }
    state = {"env": np.array([0.0, 0.01, 0.2, 0.003], np.float32)}
    x = (rng.standard_normal((B, 4, F)) * 0.1).astype(np.float32)
    x[0, 2:] = 0.0
    run_both(jn.DuckerNode(), tn.DuckerNode(), 4, 2, params, state, x,
             _mask(mask_kind, rng, (B, 4)))


NODES = {
    "compressor": (lambda n: n.CompressorNode(-20.0, 3.0, 0.01, 0.2, 2.0, 4.0), 2, 2),
    "limiter": (lambda n: n.LimiterNode(-0.5, 0.004, 0.1), 2, 2),
    "gate": (lambda n: n.GateNode(-45.0, -60.0, 0.002, 0.2, 0.1, 4.0), 2, 2),
    "ducker": (lambda n: n.DuckerNode(-35.0, -9.0, 0.02, 0.4), 4, 2),
}


@pytest.mark.parametrize("name", list(NODES))
def test_params_and_state_trees_round_trip(name):
    """collect_params and init_state equal JAX's, leaf for leaf (dtypes
    too), and pass through params_from_jax/state_from_jax and back."""
    make, nin, nout = NODES[name]
    jp = make(jn).activate(SR, F, nin, nout)
    tp = make(tn).activate(SR, F, nin, nout)
    # every dynamics node has a row in K2/K3 (the gate the FX palette's, the
    # others the mastering bus's)
    assert tp.supports_megakernel is True
    jparams = {k: np.asarray(v) for k, v in jp.collect_params().items()}
    tparams = state_to_numpy(params_from_jax(tp.collect_params(), "cpu"))
    assert jparams.keys() == tparams.keys()
    for k in jparams:
        assert tparams[k].dtype == jparams[k].dtype, k
        np.testing.assert_array_equal(tparams[k], jparams[k], err_msg=k)
    jstate = jax.tree.map(np.asarray, jp.init_state())
    tstate = state_to_numpy(tp.init_state())
    back = state_to_numpy(state_from_jax(jstate, "cpu"))
    for k in jstate:
        for got in (tstate[k], back[k]):
            assert got.dtype == jstate[k].dtype and got.shape == jstate[k].shape, k
            np.testing.assert_array_equal(got, jstate[k], err_msg=k)


@pytest.mark.parametrize("name,nin,nout", [("compressor", 2, 3), ("limiter", 1, 2),
                                           ("gate", 3, 2), ("ducker", 2, 2)])
def test_activation_errors_match_jax(name, nin, nout):
    make = NODES[name][0]
    with pytest.raises(JaxActivationError) as je:
        make(jn).activate(SR, F, nin, nout)
    with pytest.raises(NodeActivationError) as te:
        make(tn).activate(SR, F, nin, nout)
    assert str(te.value) == str(je.value)
