"""K7's wrappers (``ops/iir.py:biquad_scan``, ``one_pole_scan``) on the
CPU, where there is no card and no nvcc.

A CPU tensor runs the plain version (``biquad_scan_reference``,
``one_pole_scan_reference``; held against JAX bit for bit in
``test_torch_nodes.py`` and ``test_torch_spatial.py``) and never builds or
loads ``csrc/assoc_scan.cu``.  The rows the wrapper hands the kernel on the
card (``_operand``: each coefficient and state value as a number or a
tensor read in place at an outer and an inner stride) are checked here by
running the plain version row by row on them: each row gives what the whole
call gives for it, bit for bit.  The kernel itself is held against the
plain version on the card by ``chip_smoke.py`` (phase 3(c)).
"""

import math

import numpy as np
import pytest
import torch

from firewheel_tpu_torch.ops import cuda_build
from firewheel_tpu_torch.ops import iir

B, CH, F = 3, 2, 37


def _lowpass(shape, seed):
    g = torch.Generator().manual_seed(seed)
    freq = 200.0 + 15000.0 * torch.rand(shape, generator=g)
    q = 0.5 + 3.0 * torch.rand(shape, generator=g)
    return iir.biquad_lowpass(freq, q, 48000)


@pytest.fixture
def no_kernel(monkeypatch):
    """Any attempt to build or load the kernel library fails the test."""
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel library was built or loaded for a CPU tensor")

    monkeypatch.setattr(iir.LIBRARY, "load", refuse)
    monkeypatch.setattr(cuda_build, "_nvcc", refuse)
    monkeypatch.setattr(iir.biquad_cascade, "launches", 0)
    monkeypatch.setattr(iir.one_pole_scan, "launches", 0)


def staged_rows(value, lead):
    """The per-row values the kernel reads for one operand the wrapper
    stages (``iir._operand``), with the kernel's index: row ``r`` of
    ``[R // inner, inner]`` at ``(r // inner) * so + (r % inner) * si``."""
    t, so, si, v = iir._operand(value, lead, torch.device("cpu"))
    rows, inner = math.prod(lead), (lead[-1] if lead else 1)
    if t is None:
        return torch.full((rows,), v, dtype=torch.float32)
    return torch.as_strided(t, (rows // inner, inner), (so, si),
                            t.storage_offset()).reshape(-1)


def test_cpu_tensors_take_the_plain_path_without_the_kernel(no_kernel):
    x = torch.randn(B, CH, F)
    z = (torch.randn(B, CH), torch.randn(B, CH))
    c = iir.BiquadCoeffs(*(t[:, None] for t in _lowpass((B,), 1)))
    y, (z1, z2) = iir.biquad_scan(x, z, c)
    yr, (r1, r2) = iir.biquad_scan_reference(x, z, c)
    assert torch.equal(y, yr) and torch.equal(z1, r1) and torch.equal(z2, r2)
    b = torch.rand(B, CH, 1)
    y, last = iir.one_pole_scan(x, z[0], 1.0 - b, b)
    yr, lr = iir.one_pole_scan_reference(x, z[0], 1.0 - b, b)
    assert torch.equal(y, yr) and torch.equal(last, lr)
    assert iir.biquad_cascade.launches == 0 and iir.one_pole_scan.launches == 0
    assert iir.LIBRARY._lib is None


def test_other_devices_raise_rather_than_fall_back(no_kernel):
    x = torch.empty(B, F, device="meta")
    z = (torch.empty(B, device="meta"),) * 2
    with pytest.raises(ValueError, match="CUDA device or the CPU"):
        iir.biquad_scan(x, z, iir.BiquadCoeffs(*(1.0, 0.0, 0.0, 0.0, 0.0)))
    with pytest.raises(ValueError, match="CUDA device or the CPU"):
        iir.one_pole_scan(x, z[0], 0.5, 0.5)


# coefficient shapes the callers pass: one filter per instance [B, 1] (the
# filter node and the EQ), one per row [B, CH], one for all rows (numbers:
# the loudness meter's K-weighting), one per channel [CH]
COEF_SHAPES = {"per_instance": (B, 1), "per_row": (B, CH), "per_channel": (CH,),
               "numbers": None}


@pytest.mark.parametrize("frames", [1, 3, F, 128])
@pytest.mark.parametrize("shape", list(COEF_SHAPES))
def test_biquad_rows_are_the_kernels_layout(shape, frames):
    """The operands ``biquad_scan`` stages for the kernel, the coefficients
    and the state per row of ``x [B, CH, F]`` (numbers by value, tensors in
    place): the plain version row by row on them gives the whole call's
    output and state, bit for bit."""
    x = torch.randn(B, CH, frames)
    z = (torch.randn(B, CH), torch.randn(B, CH))
    if COEF_SHAPES[shape] is None:
        c = iir.BiquadCoeffs(*(np.float32(v) for v in (0.2, 0.3, 0.1, -0.5, 0.2)))
    else:
        c = _lowpass(COEF_SHAPES[shape], 2)
    lead = x.shape[:-1]
    coef = torch.stack([staged_rows(v, lead) for v in c])
    z_in = torch.stack([staged_rows(v, lead) for v in z])
    assert coef.shape == (5, B * CH) and z_in.shape == (2, B * CH)
    if COEF_SHAPES[shape] is None:
        assert all(iir._operand(v, lead, x.device)[0] is None for v in c)
    y, (z1, z2) = iir.biquad_scan_reference(
        x, z, iir.BiquadCoeffs(*(torch.as_tensor(v) for v in c)))
    rows = x.reshape(-1, frames)
    for r in range(rows.shape[0]):
        yr, (r1, r2) = iir.biquad_scan_reference(
            rows[r], (z_in[0, r], z_in[1, r]), iir.BiquadCoeffs(*coef[:, r]))
        assert torch.equal(yr, y.reshape(-1, frames)[r]), r
        assert torch.equal(r1, z1.reshape(-1)[r]) and torch.equal(r2, z2.reshape(-1)[r])


ONE_POLE_COEFS = {
    # the spatializer: one (a, b) per row, [..., 1]
    "per_row": lambda b: ((1.0 - b)[..., None], b[..., None]),
    # the binaural node: a = 1, b one per ear [CH, 1]
    "ear_column": lambda b: (1.0, b[0][:, None]),
    # the waveshaper's DC blocker: numbers
    "numbers": lambda b: (1.0, 0.9973857),
}


@pytest.mark.parametrize("frames", [1, 3, F, 128])
@pytest.mark.parametrize("case", list(ONE_POLE_COEFS))
def test_one_pole_rows_are_the_kernels_layout(case, frames):
    """``one_pole_scan``'s operands for the kernel, ``(a, b)`` and ``y_prev``
    per row: the plain version row by row on them gives the whole call's
    output and carry, bit for bit."""
    x = torch.randn(B, CH, frames)
    y0 = torch.randn(B, CH)
    a, b = ONE_POLE_COEFS[case](torch.rand(B, CH) * 0.98)
    lead = x.shape[:-1]
    coef = torch.stack([staged_rows(iir._per_row(v, x), lead) for v in (a, b)])
    y_in = staged_rows(y0, lead)[None]
    assert coef.shape == (2, B * CH) and y_in.shape == (1, B * CH)
    y, last = iir.one_pole_scan_reference(x, y0, a, b)
    rows = x.reshape(-1, frames)
    for r in range(rows.shape[0]):
        yr, lr = iir.one_pole_scan_reference(rows[r], y_in[0, r], coef[0, r], coef[1, r])
        assert torch.equal(yr, y.reshape(-1, frames)[r]), r
        assert torch.equal(lr, last.reshape(-1)[r])


def test_one_pole_refuses_a_coefficient_per_frame():
    x = torch.randn(B, F)
    with pytest.raises(ValueError, match="not one per row"):
        iir._per_row(torch.rand(B, F), x)


def test_frame_limits_fit_a_ctas_shared_memory():
    """A row's levels take ``n − 1`` maps of 24 bytes (biquad) or 8 (one
    pole): the kernel alone knows the 227 KB a CTA may take.  Past it the
    levels go to a device-memory workspace, the size of which the kernel
    gives (``fw_scan_workspace_bytes``, 0 while they fit) and the wrapper
    allocates, so no length but 0 frames is refused.  The register kernels
    (32, 64, 128 and 256 frames) need neither."""
    src = (cuda_build.CSRC / "assoc_scan.cu").read_text()
    assert "kMaxShared = 232448" in src
    assert "if (row_bytes > (size_t)kMaxShared) return Plan{true, kMaxWarps, 0};" in src
    assert "if (rows <= 0 || n < 1 || in_registers(n)) return 0;" in src
    assert "return n >= 32 && n <= 256 && (n & (n - 1)) == 0;" in src
    assert "if (frames < 1 || args->inner < 1) return (int)cudaErrorInvalidValue;" in src
    assert "plan.global ? biquad_scan_kernel<true> : biquad_scan_kernel<false>" in src
    assert "plan.global ? one_pole_scan_kernel<true> : one_pole_scan_kernel<false>" in src
    assert 'extern "C" int64_t fw_scan_workspace_bytes(' in src
    wrapper = (cuda_build.CSRC.parent / "ops" / "iir.py").read_text()
    assert "fw_scan_workspace_bytes(int(biquad), rows, frames, sections)" in wrapper
    assert f"kMaxSections = {iir.MAX_SECTIONS};" in src
    assert not hasattr(iir, "BIQUAD_MAX_FRAMES")
    header = (cuda_build.CSRC / "assoc_scan.cuh").read_text()
    assert "sizeof" not in header and "Affine2" in header and "Affine1" in header
    for entry in ("fw_biquad_cascade", "fw_one_pole_scan"):
        assert f'extern "C" int {entry}(' in src
    assert "--fmad=false" in cuda_build.NVCC_FLAGS


def test_rows_past_shared_memory_take_the_plain_path(no_kernel):
    """f32[2, 16384]: rows longer than a CTA's shared memory holds on the
    card (9686 frames for the biquad, 29 057 for the one-pole) run the plain
    versions on the CPU, and those equal the JAX package's scans bit for
    bit there: ``biquad_scan`` op by op, ``one_pole_scan`` under ``jit``
    (whose fused multiply-adds the plain version writes out)."""
    import jax
    import jax.numpy as jnp
    from firewheel_tpu.ops import iir as jiir

    rng = np.random.default_rng(16384)
    x = rng.standard_normal((2, 16384)).astype(np.float32)
    z = (0.1 * rng.standard_normal((2, 2))).astype(np.float32)
    coeffs = tuple(np.float32(c) for c in jiir.biquad_low_shelf(
        np.float32(150.0), np.float32(0.8), np.float32(4.0), 48000))
    jy, jz = jiir.biquad_scan(jnp.asarray(x), (jnp.asarray(z[0]), jnp.asarray(z[1])),
                              jiir.BiquadCoeffs(*coeffs))
    ty, tz = iir.biquad_scan(torch.from_numpy(x), (torch.from_numpy(z[0]),
                                                   torch.from_numpy(z[1])),
                             iir.BiquadCoeffs(*map(torch.tensor, coeffs)))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    for t, j in zip(tz, jz):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))

    b = rng.uniform(0.05, 0.99, 2).astype(np.float32)
    a = np.float32(1.0) - b
    y0 = rng.standard_normal(2).astype(np.float32)
    jy, jl = jax.jit(jax.vmap(jiir.one_pole_scan))(x, y0, a, b)
    ty, tl = iir.one_pole_scan(torch.from_numpy(x), torch.from_numpy(y0),
                               torch.from_numpy(a)[:, None], torch.from_numpy(b)[:, None])
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert iir.biquad_cascade.launches == 0 and iir.one_pole_scan.launches == 0
