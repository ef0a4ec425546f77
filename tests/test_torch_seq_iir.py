"""The port's sequential biquad (kernel K1's plain version and wrapper)
and its RBJ coefficient designs, held against the JAX package on the CPU.

The reference is ``biquad_pallas(..., interpret=True)``: the literal
sequential float32 recurrence, which the port evaluates in the same order,
so the tolerance is 1e-6 (not ``biquad_scan``, which is reassociated).
The kernel itself runs only on a CUDA card; ``chip_smoke.py`` holds it
against the plain version there.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from firewheel_tpu.ops import iir as jiir
from firewheel_tpu.ops.pallas_iir import biquad_pallas
from firewheel_tpu_torch.ops import iir as tiir
from firewheel_tpu_torch.ops.seq_iir import (
    biquad_seq, biquad_seq_reference, lane_repeat,
)

SR = 48000
TOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _coeffs_np(c):
    return tuple(np.asarray(v, np.float32) for v in c)


def _jax_lowpass(freq, q):
    return jiir.biquad_lowpass(jnp.float32(freq), jnp.float32(q), SR)


@pytest.mark.parametrize(
    "lead,frames", [((3,), 128), ((5, 2), 100), ((1037,), 64), ((), 256),
                    ((33,), 1), ((33,), 127), ((32,), 4096)]
)
def test_plain_matches_pallas_interpret(lead, frames):
    """Ragged lane counts (not a multiple of the Pallas 1024-lane tile or
    of the CUDA kernel's 32 lanes a CTA), non-zero incoming state, and the
    frame counts the kernel treats apart: 1, 127 (not a multiple of 4: its
    4-byte copies) and 4096 (longer than its ring of stages in shared
    memory, which then turns over)."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal(lead + (frames,)).astype(np.float32)
    z1 = (0.1 * rng.standard_normal(lead)).astype(np.float32)
    z2 = (0.1 * rng.standard_normal(lead)).astype(np.float32)
    jc = _jax_lowpass(3000.0, 2.0)
    yj, (j1, j2) = biquad_pallas(jnp.asarray(x), (jnp.asarray(z1), jnp.asarray(z2)),
                                 jc, interpret=True)
    tc = tiir.BiquadCoeffs(*(_t(v) for v in _coeffs_np(jc)))
    yt, (t1, t2) = biquad_seq(_t(x), (_t(z1), _t(z2)), tc)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=TOL, rtol=0)
    np.testing.assert_allclose(t1.numpy(), np.asarray(j1), atol=TOL, rtol=0)
    np.testing.assert_allclose(t2.numpy(), np.asarray(j2), atol=TOL, rtol=0)


def test_state_carried_across_two_calls():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((4, 2, 256)).astype(np.float32)
    jc = _jax_lowpass(500.0, 4.0)  # resonant: rounding order matters most
    tc = tiir.BiquadCoeffs(*(_t(v) for v in _coeffs_np(jc)))
    zj = (jnp.zeros((4, 2)), jnp.zeros((4, 2)))
    zt = (torch.zeros((4, 2)), torch.zeros((4, 2)))
    for half in (slice(0, 128), slice(128, 256)):
        yj, zj = biquad_pallas(jnp.asarray(x[..., half]), zj, jc, interpret=True)
        yt, zt = biquad_seq(_t(x[..., half]), zt, tc)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=TOL, rtol=0)
    for a, b in zip(zt, zj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL, rtol=0)
    # and two calls == one call over both halves, exactly
    y_full, z_full = biquad_seq(_t(x), (torch.zeros((4, 2)),) * 2, tc)
    np.testing.assert_array_equal(y_full[..., 128:].numpy(), yt.numpy())
    for a, b in zip(z_full, zt):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("lanes,frames", [(6, 128), (33, 127), (3, 1), (2, 4096)])
def test_per_lane_coefficients_match_one_jax_call_per_lane(lanes, frames):
    """Every lane its own filter — what a batch of instances with their own
    cutoffs gives the kernel — against one scalar-coefficient JAX call per
    lane, at the kernel's ragged shapes too."""
    rng = np.random.default_rng(3)
    freqs = rng.uniform(200.0, 16000.0, lanes).astype(np.float32)
    qs = rng.uniform(0.5, 4.0, lanes).astype(np.float32)
    x = rng.standard_normal((lanes, frames)).astype(np.float32)
    z1 = (0.1 * rng.standard_normal(lanes)).astype(np.float32)
    z2 = (0.1 * rng.standard_normal(lanes)).astype(np.float32)
    tc = tiir.biquad_lowpass(_t(freqs), _t(qs), SR)
    yt, (t1, t2) = biquad_seq(_t(x), (_t(z1), _t(z2)), tc)
    for i in range(lanes):
        # the same coefficients, one filter per JAX call
        jc = jiir.BiquadCoeffs(*(jnp.float32(float(c[i])) for c in tc))
        yj, (j1, j2) = biquad_pallas(jnp.asarray(x[i]), (jnp.float32(z1[i]),
                                     jnp.float32(z2[i])), jc, interpret=True)
        np.testing.assert_allclose(yt[i].numpy(), np.asarray(yj), atol=TOL, rtol=0)
        np.testing.assert_allclose(float(t1[i]), float(j1), atol=TOL, rtol=0)
        np.testing.assert_allclose(float(t2[i]), float(j2), atol=TOL, rtol=0)


@pytest.mark.parametrize("kind", ["lowpass", "highpass", "bandpass", "notch",
                                  "allpass", "peaking", "low_shelf", "high_shelf"])
def test_rbj_designs_match_jax(kind):
    """Built in float32 per element.  torch's f32 sin/cos may differ from
    XLA's by an ulp, which moves a coefficient by ~1e-7: tolerance 1e-6."""
    rng = np.random.default_rng(5)
    freq = rng.uniform(20.0, 20000.0, 16).astype(np.float32)
    q = rng.uniform(0.3, 8.0, 16).astype(np.float32)
    gain = rng.uniform(-24.0, 24.0, 16).astype(np.float32)
    jb = getattr(jiir, f"biquad_{kind}")
    tb = getattr(tiir, f"biquad_{kind}")
    if kind in ("peaking", "low_shelf", "high_shelf"):
        jc = jb(jnp.asarray(freq), jnp.asarray(q), jnp.asarray(gain), SR)
        tc = tb(_t(freq), _t(q), _t(gain), SR)
    else:
        jc = jb(jnp.asarray(freq), jnp.asarray(q), SR)
        tc = tb(_t(freq), _t(q), SR)
    for a, b in zip(tc, jc):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL, rtol=1e-6)


@pytest.mark.parametrize("shape,lead,repeat", [
    ((), (4, 2), 8),          # one filter for every lane
    ((4, 1), (4, 2), 2),      # the filter node's per-instance coefficients
    ((4, 2), (4, 2), 1),      # per lane (the state)
    ((3, 1, 1), (3, 2, 5), 10),
    ((1,), (4, 2), 8),
    ((1, 2), (4, 2), None),   # the same per channel: no lane divisor
    ((2,), (4, 2), None),
])
def test_lane_repeat_gathers_what_broadcast_to_gives(shape, lead, repeat):
    """The kernel reads lane ``l``'s operand as ``c.reshape(-1)[l //
    repeat]``; every other broadcast is materialised by the wrapper."""
    assert lane_repeat(shape, lead) == repeat
    c = torch.arange(math.prod(shape), dtype=torch.float32).reshape(shape)
    want = c.broadcast_to(lead).reshape(-1)
    if repeat is not None:
        lanes = torch.arange(want.numel())
        assert torch.equal(c.reshape(-1)[lanes // repeat], want)
    else:
        assert not any(
            torch.equal(c.reshape(-1)[torch.arange(want.numel()) // r], want)
            for r in range(1, want.numel() + 1) if c.numel() * r >= want.numel())


def _args(x=None):
    x = torch.zeros((4, 128)) if x is None else x
    z = (torch.zeros(4), torch.zeros(4))
    c = tiir.biquad_lowpass(torch.tensor(1000.0), torch.tensor(0.7), SR)
    return x, z, c


def test_wrapper_rejects_wrong_dtype():
    x, z, c = _args(torch.zeros((4, 128), dtype=torch.float64))
    with pytest.raises(TypeError, match="float32"):
        biquad_seq(x, z, c)
    x, _, c = _args()
    with pytest.raises(TypeError, match="float32"):
        biquad_seq(x, (torch.zeros(4, dtype=torch.float64), torch.zeros(4)), c)


def test_wrapper_rejects_non_contiguous_input():
    x, z, c = _args(torch.zeros((128, 4)).T)
    assert not x.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        biquad_seq(x, z, c)


def test_wrapper_on_cpu_runs_the_plain_version_without_counting():
    rng = np.random.default_rng(9)
    x, z, c = _args(_t(rng.standard_normal((4, 128))))
    before = biquad_seq.launches
    y, (z1, z2) = biquad_seq(x, z, c)
    yr, (r1, r2) = biquad_seq_reference(x, z, c)
    assert biquad_seq.launches == before  # no kernel launched on the CPU
    assert torch.equal(y, yr) and torch.equal(z1, r1) and torch.equal(z2, r2)
