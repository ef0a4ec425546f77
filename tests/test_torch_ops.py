"""The port's ``ops`` namespace held against ``firewheel_tpu.ops`` on the CPU.

Every name of the JAX namespace imports from ``firewheel_tpu_torch.ops``.
The four functions this namespace added (``comb_step``; the fixed-hop
frequency-domain delay line ``partition_ir``, ``fdl_init``, ``fdl_step``)
run on the same seeded numpy inputs in both packages: ``partition_ir`` is
host numpy in both and equal exactly; the audio within 1e-6, and the delay
line's spectra within 1e-6 of their peak (torch's and JAX's CPU FFTs round
apart by an ulp).
"""

import numpy as np
import pytest
import torch

import firewheel_tpu.ops as jops
import firewheel_tpu_torch.ops as tops

TOL = 1e-6


def test_namespace_has_every_jax_name():
    assert len(jops.__all__) == 23
    assert set(tops.__all__) == set(jops.__all__)
    for name in jops.__all__:
        assert getattr(tops, name) is not None, name


@pytest.mark.parametrize("feedback", [0.6, "per_channel"])
def test_comb_step_matches_jax(feedback):
    rng = np.random.default_rng(3)
    ch, d, f = 2, 300, 128
    g = (np.array([[0.5], [-0.7]], np.float32) if feedback == "per_channel"
         else feedback)
    tbuf, jbuf = tops.comb_init(ch, d), jops.comb_init(ch, d)
    assert tuple(tbuf.shape) == tuple(jbuf.shape) == (ch, d)
    for _ in range(6):
        x = (0.3 * rng.standard_normal((ch, f))).astype(np.float32)
        ty, tbuf = tops.comb_step(torch.from_numpy(x), tbuf,
                                  torch.from_numpy(g) if isinstance(g, np.ndarray) else g)
        jy, jbuf = jops.comb_step(x, jbuf, g)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL, rtol=0)
        np.testing.assert_allclose(tbuf.numpy(), np.asarray(jbuf), atol=TOL, rtol=0)
    with pytest.raises(AssertionError, match="comb delay"):
        tops.comb_step(torch.zeros(2, 128), torch.zeros(2, 64), 0.5)


@pytest.mark.parametrize("ir_ch,length,f", [(1, 1000, 128), (2, 300, 64), (2, 64, 64)])
def test_fdl_matches_jax(ir_ch, length, f):
    """``partition_ir`` exactly; ``fdl_step`` over six blocks of a stereo
    signal, with one IR for both channels or one each."""
    rng = np.random.default_rng(length)
    decay = np.exp(-np.arange(length) / (length / 4))
    ir = (0.2 * rng.standard_normal((ir_ch, length)) * decay).astype(np.float32)
    H = tops.partition_ir(ir, f)
    np.testing.assert_array_equal(H, jops.partition_ir(ir, f))
    p = H.shape[0]
    assert H.shape == (-(-length // f), ir_ch, f + 1, 2) and H.dtype == np.float32
    tstate = tops.fdl_init(p, 2, f)
    jstate = jops.fdl_init(p, 2, f)
    for t, j in zip(tstate, jstate):
        assert isinstance(t, torch.Tensor) and t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), j)
    ys = []
    for _ in range(6):
        x = (0.3 * rng.standard_normal((2, f))).astype(np.float32)
        ty, tstate = tops.fdl_step(torch.from_numpy(x), tstate, H)
        jy, jstate = jops.fdl_step(x, jstate, H)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL, rtol=0)
        # the delay line holds spectra of 2F samples (peaks ~10): held at
        # 1e-6 of their peak, an ulp or two of each bin
        spec = np.asarray(jstate[0])
        np.testing.assert_allclose(tstate[0].numpy(), spec,
                                   atol=TOL * float(np.abs(spec).max()), rtol=0)
        np.testing.assert_array_equal(tstate[1].numpy(), np.asarray(jstate[1]))
        ys.append(ty.numpy())
    # the signal comes through the IR
    sig = np.concatenate(ys, axis=-1)
    assert float(np.abs(sig).max()) > 0.05


def test_fdl_step_takes_a_batch_dimension():
    """A leading batch dimension (instances) renders each instance as its
    own call does."""
    rng = np.random.default_rng(5)
    f, p = 64, 3
    H = torch.from_numpy(tops.partition_ir(
        (0.2 * rng.standard_normal((2, p * f))).astype(np.float32), f))
    x = torch.from_numpy((0.3 * rng.standard_normal((3, 2, f))).astype(np.float32))
    fdl, prev = tops.fdl_init(p, 2, f)
    batched = (torch.stack([fdl] * 3), torch.stack([prev] * 3))
    yb, _ = tops.fdl_step(x, batched, torch.stack([H] * 3))
    for i in range(3):
        yi, _ = tops.fdl_step(x[i], (fdl, prev), H)
        np.testing.assert_array_equal(yb[i].numpy(), yi.numpy())
