"""The port's convolution reverb (``nodes/reverb.py``) and its two engines
(``ops/direct_conv.py``, ``ops/fft_conv.py``), held against the JAX package
on the CPU.

Both packages get the same IR and input, made from a numpy seed; B
instances carry their own wet levels.  The JAX node kernel runs under
``jit(vmap(...))``, as ``BatchRenderer`` runs it.

Tolerances:

* Outputs 1e-6 absolute (≤ 6e-8 measured): the direct engine sums the FIR
  in another order than XLA's convolution; the FFT engine's transforms
  (pocketfft in both packages) round alike to an ulp or two.
* The FFT engine's delay line holds spectra, not samples: the bins of a
  block's transform reach ~20, where an f32 ulp is 2e-6, and each bin
  carries the rounding of the whole transform.  It is held to 1e-6 of its
  largest bin.
* Masks, ``fill`` and ``tfill`` equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from firewheel_tpu.core.node import BlockInfo as JBlockInfo
from firewheel_tpu.nodes import ConvolutionReverbNode as JReverb
from firewheel_tpu.ops import direct_conv as jdc
from firewheel_tpu.ops import fft_conv as jfc
from firewheel_tpu_torch.convert import params_from_jax, state_from_jax, state_to_numpy
from firewheel_tpu_torch.core.node import BlockInfo as TBlockInfo
from firewheel_tpu_torch.nodes import ConvolutionReverbNode as TReverb
from firewheel_tpu_torch.ops import direct_conv as tdc
from firewheel_tpu_torch.ops import fft_conv as tfc

SR = 48000
F = 128
B = 3
TOL = 1e-6
SCALED_TOL = 1e-6  # of the largest value, where rounding scales with it


def _ir(irch, n, seed=0):
    rng = np.random.default_rng(seed)
    ir = rng.standard_normal((irch, n)).astype(np.float32)
    ir *= np.exp(-np.arange(n, dtype=np.float32) / (n / 4))
    return ir / np.abs(ir).sum(axis=-1, keepdims=True)


def _batched(tree):
    return jax.tree.map(
        lambda x: np.broadcast_to(np.asarray(x), (B,) + np.shape(x)).copy(), tree)


def _np(tree):
    return state_to_numpy(state_from_jax(jax.tree.map(np.asarray, tree), "cpu"))


def _assert_state_close(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if a[k].dtype.kind != "f":
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            tol = TOL if k != "fdl" else max(TOL, SCALED_TOL * np.abs(b[k]).max())
            np.testing.assert_allclose(a[k], b[k], atol=tol, rtol=0, err_msg=k)


@pytest.mark.parametrize("irch", [1, 2])
@pytest.mark.parametrize("method,taps", [
    ("direct", 256), ("direct", 500), ("fft", 900), ("fft", 4000), ("auto", 256),
    ("auto", 700),
])
def test_node_matches_jax(method, taps, irch):
    """Six blocks: three audible, then three silent while the tail rings.
    Instance 0 starts silent on a fresh state (flagged silent); instance 2
    has one silent channel beside an audible one (its history rings)."""
    ir = _ir(irch, taps)
    jp = JReverb(ir, wet=0.35, method=method).activate(SR, F, 2, 2)
    tp = TReverb(ir, wet=0.35, method=method).activate(SR, F, 2, 2)
    assert tp._method == jp._method
    params = _batched(jax.tree.map(np.asarray, jp.collect_params()))
    params["wet"] = np.array([0.2, 0.35, 1.0], np.float32)
    tparams = _batched(jax.tree.map(np.asarray, tp.collect_params()))
    tparams["wet"] = params["wet"]
    _assert_state_close(state_to_numpy(params_from_jax(tparams, "cpu")), _np(params))
    jstate = _batched(jax.tree.map(np.asarray, jp.init_state()))
    tstate = state_from_jax(_batched(state_to_numpy(tp.init_state())), "cpu")
    _assert_state_close(state_to_numpy(tstate), _np(jstate))
    kernel = jax.jit(jax.vmap(jp.kernel, in_axes=(0, 0, 0, 0, None)))
    tparams = params_from_jax(tparams, "cpu")

    rng = np.random.default_rng(1)
    masks = []
    for blk in range(6):
        x = (0.3 * rng.standard_normal((B, 2, F))).astype(np.float32)
        m = np.zeros((B, 2), bool)
        if blk >= 3 or blk == 0:
            x[:] = 0.0 if blk >= 3 else x[:]
            m[:] = blk >= 3
            x[0], m[0] = 0.0, True
        if blk == 1:
            m[2, 1] = True  # a silent channel beside an audible one
            x[2, 1] = 0.0
        jo, jstate, jm = kernel(params, jstate, jnp.asarray(x), jnp.asarray(m),
                                JBlockInfo.make())
        to, tstate, tm = tp.kernel(tparams, tstate, torch.from_numpy(x),
                                   torch.from_numpy(m), TBlockInfo.make())
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=TOL, rtol=0)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        _assert_state_close(state_to_numpy(tstate), _np(jstate))
        masks.append(tm.numpy())
    assert masks[0][0].all() and not masks[0][1:].any()
    # the tail rings through silent input: masks stay clear
    assert not masks[1][2, 1] and not masks[3].any()


@pytest.mark.parametrize("taps,irch", [(17, 1), (64, 2), (300, 1), (1, 2)])
def test_direct_conv_step_mixed_hops(taps, irch):
    """Per-instance taps, hops of 1 to 128.  The taps are not normalised,
    so outputs reach ~11; the FIR sum in another order differs by a few ulp
    of the output's scale (4.5e-6 measured), so the op is held to 1e-6 of
    its largest output."""
    rng = np.random.default_rng(42)
    x = rng.standard_normal((2, 2, 512)).astype(np.float32)
    ir = (0.3 * rng.standard_normal((2, irch, taps))).astype(np.float32)
    jh = [jnp.asarray(jdc.direct_hist_init(2, taps)) for _ in range(2)]
    th = tdc.direct_hist_init(2, taps).expand(2, 2, max(taps - 1, 0))
    pos = 0
    for n in (128, 1, 37, 64, 128, 128, 26):
        xs = x[..., pos:pos + n]
        ty, th = tdc.direct_conv_step(torch.from_numpy(xs), th, torch.from_numpy(ir))
        for b in range(2):
            jy, jh[b] = jdc.direct_conv_step(jnp.asarray(xs[b]), jh[b],
                                             jnp.asarray(ir[b]))
            want = np.asarray(jy)
            np.testing.assert_allclose(ty[b].numpy(), want, rtol=0, atol=max(
                TOL, SCALED_TOL * np.abs(want).max()))
            np.testing.assert_array_equal(th[b].numpy(), np.asarray(jh[b]))
        pos += n


def test_fft_conv_step_partial_hops():
    """Hops shorter than a partition take the boundary branch only when
    they complete one.  The two instances start at different fills, so one
    completes a partition where the other does not: a per-instance select
    (the JAX package's ``lax.cond`` per instance)."""
    rng = np.random.default_rng(5)
    ir = (0.05 * rng.standard_normal((2, 900))).astype(np.float32)
    h_head, H_tail = jfc.conv_partition_ir(ir, F)
    t_head, t_tail = tfc.conv_partition_ir(ir, F)
    np.testing.assert_array_equal(t_head, h_head)
    np.testing.assert_array_equal(t_tail, H_tail)
    jh, jt = jnp.asarray(h_head), jnp.asarray(H_tail)
    jstates = [jfc.conv_state_init(8, 2, F) for _ in range(2)]
    _, jstates[1] = jfc.conv_step(
        jnp.asarray(rng.standard_normal((2, 37)), jnp.float32), jstates[1], jh, jt)
    tstate = state_from_jax(jax.tree.map(
        lambda *xs: np.stack([np.asarray(x) for x in xs]), *jstates), "cpu")
    th, tt = torch.from_numpy(h_head), torch.from_numpy(H_tail)
    fills = set()
    for n in (128, 37, 1, 64, 128, 100, 90, 101, 128):
        x = rng.standard_normal((2, 2, n)).astype(np.float32)
        ty, tstate = tfc.conv_step(torch.from_numpy(x), tstate, th, tt)
        for b in range(2):
            jy, jstates[b] = jfc.conv_step(jnp.asarray(x[b]), jstates[b], jh, jt)
            np.testing.assert_allclose(ty[b].numpy(), np.asarray(jy), atol=TOL,
                                       rtol=0)
            _assert_state_close({k: v[b] for k, v in state_to_numpy(
                tstate).items()}, _np(jstates[b]))
        fills.add(tuple(tstate["fill"].tolist()))
    assert any(a != b for a, b in fills) and len(fills) > 4


def test_fft_conv_step_one_instance_partial_hops():
    rng = np.random.default_rng(6)
    ir = (0.05 * rng.standard_normal((1, 700))).astype(np.float32)
    h_head, H_tail = tfc.conv_partition_ir(ir, F)
    jst, tst = jfc.conv_state_init(6, 2, F), tfc.conv_state_init(6, 2, F)
    for n in (128, 37, 1, 64, 128, 100, 90, 128, 5):
        x = rng.standard_normal((2, n)).astype(np.float32)
        jy, jst = jfc.conv_step(jnp.asarray(x), jst, jnp.asarray(h_head),
                                jnp.asarray(H_tail))
        ty, tst = tfc.conv_step(torch.from_numpy(x), tst, torch.from_numpy(h_head),
                                torch.from_numpy(H_tail))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL, rtol=0)
        _assert_state_close(state_to_numpy(tst), _np(jst))


def test_auto_engine_selection_matches_jax():
    assert tdc.DIRECT_CONV_MAX_TAPS == jdc.DIRECT_CONV_MAX_TAPS == 512
    for n in (1, 256, 512, 513, 28800):
        ir = _ir(1, n)
        t = TReverb(ir).activate(SR, F, 2, 2)
        j = JReverb(ir).activate(SR, F, 2, 2)
        assert (t._method, t._partitions) == (j._method, j._partitions)
