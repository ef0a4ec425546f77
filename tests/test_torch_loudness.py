"""The loudness meter and the FIR filter (``nodes/loudness.py``,
``nodes/fir.py``) held against the JAX package on the CPU.

Node kernels: B=4 instances (``vmap`` on the JAX side), audible, silent
and mixed masks.  The meter's K-weighting runs the associative-scan biquad
op for op as JAX's does (states within 1e-6); its ring holds each 100 ms
hop's energy, summed by a reduction where JAX adds sample by sample, so
the energies agree to 1e-6 relative; counts, position and index are
equal.  The FIR's convolution sums 255 products in another order: 1e-6.
The mastering bus that they close is in ``test_torch_mastering.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from firewheel_tpu import nodes as jn
from firewheel_tpu.core import node as jnode
from firewheel_tpu_torch import mixer
from firewheel_tpu_torch import nodes as tn
from firewheel_tpu_torch.convert import state_from_jax, state_to_numpy
from firewheel_tpu_torch.core import node as tnode
from test_torch_nodes import B, F, MASKS, SR, TOL, _mask, run_both

RING_RTOL = 1e-6


def _normalize(tree):
    return state_to_numpy(state_from_jax(jax.tree.map(np.asarray, tree), "cpu"))


def _meter_state(rng, pos, idx):
    return {
        "shelf_z": (rng.standard_normal((B, 2, 2)) * 0.1).astype(np.float32),
        "hp_z": (rng.standard_normal((B, 2, 2)) * 0.1).astype(np.float32),
        "ring": rng.uniform(0.0, 400.0, (B, 31)).astype(np.float32),
        "counts": rng.integers(0, 4801, (B, 31)).astype(np.uint32),
        "pos": np.asarray(pos, np.uint32),
        "idx": np.asarray(idx, np.uint32),
    }


def meter_block(nout, state, x, mask, frames=F):
    """One block through both meters → the port's new state (numpy); the
    ring within 1e-6 relative, the other leaves as ``run_both`` holds them."""
    jp = jn.LoudnessMeterNode().activate(SR, F, 2, nout)
    tp = tn.LoudnessMeterNode().activate(SR, F, 2, nout)
    jout, jst, jmask = jax.vmap(jp.kernel, in_axes=(0, 0, 0, 0, None))(
        {}, state, jnp.asarray(x), jnp.asarray(mask), jnode.BlockInfo.make())
    tout, tst, tmask = tp.kernel({}, state_from_jax(state, "cpu"), torch.from_numpy(x),
                                 torch.from_numpy(mask), tnode.BlockInfo.make())
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    got, want = state_to_numpy(tst), _normalize(jst)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        if k == "ring":
            np.testing.assert_allclose(got[k], want[k], rtol=RING_RTOL, atol=0)
        elif got[k].dtype.kind == "f":
            np.testing.assert_allclose(got[k], want[k], atol=TOL, rtol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    return got


@pytest.mark.parametrize("nout,mask_kind", [(2, m) for m in MASKS] + [(0, "mixed")])
def test_loudness_meter_over_hops(nout, mask_kind):
    """Per-instance write positions: mid-hop, a block that crosses a hop
    boundary, one that ends exactly on it, and the ring's last slot (the
    index wraps); then a block on; in line, and as a sink."""
    rng = np.random.default_rng(11)
    state = _meter_state(rng, [100, 4750, 4672, 4790], [3, 0, 17, 30])
    for _ in range(2):
        x = (rng.standard_normal((B, 2, F)) * 0.3).astype(np.float32)
        state = meter_block(nout, state, x, _mask(mask_kind, rng, (B, 2)))


def test_loudness_meter_partial_block():
    rng = np.random.default_rng(12)
    state = _meter_state(rng, [4790, 0, 4700, 17], [30, 5, 9, 0])
    x = (rng.standard_normal((B, 2, 100)) * 0.3).astype(np.float32)
    meter_block(2, state, x, np.zeros((B, 2), bool))


def test_read_and_integrated_loudness_equal_jax():
    rng = np.random.default_rng(13)
    st = {k: v[0] for k, v in _meter_state(rng, [2000] * B, [7] * B).items()}
    st["counts"][:] = 4800
    want = jn.LoudnessMeterNode.read(st)
    got = tn.LoudnessMeterNode.read(state_from_jax(st, "cpu"))
    assert got == want
    blocks = list(rng.uniform(-40.0, -10.0, 50)) + [-np.inf, -80.0]
    ji, ti = jn.IntegratedLoudness(), tn.IntegratedLoudness()
    for v in blocks:
        ji.push(v)
        ti.push(v)
    assert ti.value() == ji.value()
    assert tn.IntegratedLoudness().value() == -np.inf


@pytest.mark.parametrize("kind,cut", [("lowpass", 8000.0), ("highpass", 200.0),
                                      ("bandpass", (300.0, 3000.0)),
                                      ("bandstop", (50.0, 70.0))])
@pytest.mark.parametrize("window", ["hamming", "blackman", "rect"])
def test_design_windowed_sinc_equals_jax(kind, cut, window):
    np.testing.assert_array_equal(
        tn.design_windowed_sinc(kind, 255, SR, cut, window),
        jn.design_windowed_sinc(kind, 255, SR, cut, window))


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("per_channel", [False, True])
def test_fir_filter(mask_kind, per_channel):
    """The bus's 255-tap shelf (or a random pair of per-channel filters) on
    per-instance taps and gains, over two blocks."""
    rng = np.random.default_rng(14)
    taps = mixer.air_shelf_taps()
    if per_channel:
        taps = (rng.standard_normal((2, 255)) * 0.05).astype(np.float32)
    taps = np.atleast_2d(taps)
    params = {"taps": np.stack([taps * (1.0 + 0.1 * b) for b in range(B)]),
              "gain": rng.uniform(0.5, 1.5, B).astype(np.float32)}
    state = {"hist": (rng.standard_normal((B, 2, 254)) * 0.2).astype(np.float32)}
    state["hist"][0] = 0.0  # a quiet line: the mask passes through
    node_j, node_t = jn.FirFilterNode(taps), tn.FirFilterNode(taps)
    for _ in range(2):
        x = (rng.standard_normal((B, 2, F)) * 0.3).astype(np.float32)
        _, state, _ = run_both(node_j, node_t, 2, 2, params, state, x,
                               _mask(mask_kind, rng, (B, 2)))
