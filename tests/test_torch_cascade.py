"""``ops/iir.py:biquad_cascade`` (K7's biquad sections in series over the
same rows, one launch on the card) on the CPU, where there is no card and
no nvcc.

A CPU tensor runs the plain version, the chain of ``biquad_scan_reference``
calls it replaces (each section's output the next one's input), bit for
bit, and never builds or loads ``csrc/assoc_scan.cu``.  The operands the
wrapper stages for the kernel (each section's five coefficients and two
state values per row, ``[S, 5, R]`` and ``[S, 2, R]`` as the kernel reads
them) give, row by row through the plain chain, what the whole call gives.
The parametric EQ's bands and the loudness meter's K-weighting run as one
cascade a block and still match the JAX package as ``test_torch_fx.py`` and
``test_torch_loudness.py`` hold them.  The kernel itself is held against
the plain chain on the card by ``chip_smoke.py`` (phase 3(c)).
"""

import math

import numpy as np
import pytest
import torch

from firewheel_tpu import nodes as jn
from firewheel_tpu_torch import nodes as tn
from firewheel_tpu_torch.nodes import eq as teq
from firewheel_tpu_torch.nodes import loudness as tloud
from firewheel_tpu_torch.ops import iir
from test_torch_assoc_scan import no_kernel, staged_rows  # noqa: F401
from test_torch_fx import _bands, _stack
from test_torch_loudness import _meter_state, meter_block
from test_torch_nodes import B, F, MASKS, _mask, run_both

CH = 2


def _section(kind, shape, g):
    """One section's coefficients: a lowpass, the EQ's 150 Hz low shelf or
    the meter's 38 Hz high-pass, per element of ``shape``; or numbers."""
    if kind == "numbers":
        return iir.BiquadCoeffs(*(np.float32(v) for v in (0.2, 0.3, 0.1, -0.5, 0.2)))
    freq = 200.0 + 15000.0 * torch.rand(shape, generator=g)
    q = 0.5 + 3.0 * torch.rand(shape, generator=g)
    if kind == "lowpass":
        return iir.biquad_lowpass(freq, q, 48000)
    if kind == "shelf":
        return iir.biquad_low_shelf(torch.full(shape, 150.0), q, torch.full(shape, 4.0),
                                    48000)
    return iir.biquad_highpass(torch.full(shape, 38.0), q, 48000)


def _cascade(sections, frames, seed, shape=(B, 1)):
    g = torch.Generator().manual_seed(seed)
    kinds = ("lowpass", "shelf", "highpass", "numbers")
    cs = [_section(kinds[s % 4], shape, g) for s in range(sections)]
    zs = [(0.1 * torch.randn(B, CH, generator=g), 0.1 * torch.randn(B, CH, generator=g))
          for _ in range(sections)]
    return torch.randn(B, CH, frames, generator=g), zs, cs


def _equal(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("frames", [1, 37, 128, 256])
@pytest.mark.parametrize("sections", [1, 2, 3, 9])
def test_cascade_is_the_chain_of_sections(no_kernel, sections, frames):  # noqa: F811
    """On a CPU tensor the cascade is the plain chain, section by section,
    bit for bit, states in the sections' order; no kernel is built, loaded
    or counted.  Nine sections pass the eight a launch takes on the card."""
    x, zs, cs = _cascade(sections, frames, seed=sections * 1000 + frames)
    y, states = iir.biquad_cascade(x, zs, cs)
    want = x
    assert len(states) == sections
    for (z1, z2), z, c in zip(states, zs, cs):
        want, (w1, w2) = iir.biquad_scan_reference(want, z, c)
        assert _equal(z1, w1) and _equal(z2, w2)
    assert _equal(y, want)
    ry, rstates = iir.biquad_cascade_reference(x, zs, cs)
    assert _equal(ry, y) and all(_equal(a, b) for s, r in zip(states, rstates)
                                  for a, b in zip(s, r))
    assert iir.biquad_cascade.launches == 0 and iir.LIBRARY._lib is None


def test_biquad_scan_is_the_one_section_cascade(no_kernel):  # noqa: F811
    x, zs, cs = _cascade(1, 37, seed=5)
    y, z = iir.biquad_scan(x, zs[0], cs[0])
    wy, (w,) = iir.biquad_cascade(x, zs, cs)
    assert _equal(y, wy) and all(map(_equal, z, w))
    assert iir.biquad_cascade.launches == 0


def test_cascade_refuses_states_that_do_not_match_its_sections():
    x, zs, cs = _cascade(2, 8, seed=6)
    with pytest.raises(ValueError, match="2 sections, 1 states"):
        iir.biquad_cascade(x, zs[:1], cs)
    with pytest.raises(ValueError, match="0 sections"):
        iir.biquad_cascade(x, (), ())
    with pytest.raises(ValueError, match="CUDA device or the CPU"):
        iir.biquad_cascade(torch.empty(B, 8, device="meta"),
                           ((torch.empty(B, device="meta"),) * 2,), cs[:1])


# coefficient shapes per section: one filter per instance [B, 1] (the EQ),
# one per row [B, CH], one per channel [CH], numbers (the meter)
SECTION_SHAPES = {"per_instance": (B, 1), "per_row": (B, CH), "per_channel": (CH,),
                  "numbers": None}


@pytest.mark.parametrize("frames", [3, 128])
@pytest.mark.parametrize("shapes", [("per_instance",) * 3, ("numbers", "numbers"),
                                    ("per_row", "per_channel", "numbers")])
def test_cascade_rows_are_the_kernels_layout(shapes, frames):
    """The operands ``biquad_cascade`` stages for the kernel, the
    coefficients ``[S, 5, R]`` and the states ``[S, 2, R]`` as the kernel
    reads them per row of ``x [B, CH, F]``: the plain chain row by row on
    them gives the whole call's output and every section's state, bit for
    bit."""
    g = torch.Generator().manual_seed(len(shapes) * 10 + frames)
    kinds = ("shelf", "lowpass", "highpass")
    cs = [_section("numbers" if s == "numbers" else kinds[i], SECTION_SHAPES[s], g)
          for i, s in enumerate(shapes)]
    zs = [(0.1 * torch.randn(B, CH, generator=g), 0.1 * torch.randn(B, CH, generator=g))
          for _ in shapes]
    x = torch.randn(B, CH, frames, generator=g)
    lead = x.shape[:-1]
    coef = torch.stack([torch.stack([staged_rows(v, lead) for v in c]) for c in cs])
    z_in = torch.stack([torch.stack([staged_rows(v, lead) for v in z]) for z in zs])
    assert coef.shape == (len(shapes), 5, B * CH) and z_in.shape == (len(shapes), 2, B * CH)
    y, states = iir.biquad_cascade_reference(
        x, zs, [iir.BiquadCoeffs(*(torch.as_tensor(v) for v in c)) for c in cs])
    rows = x.reshape(-1, frames)
    for r in range(rows.shape[0]):
        yr = rows[r]
        for s in range(len(shapes)):
            yr, (r1, r2) = iir.biquad_scan_reference(
                yr, (z_in[s, 0, r], z_in[s, 1, r]), iir.BiquadCoeffs(*coef[s, :, r]))
            assert _equal(r1, states[s][0].reshape(-1)[r])
            assert _equal(r2, states[s][1].reshape(-1)[r])
        assert _equal(yr, y.reshape(-1, frames)[r]), r


ROW_STRIDES = {
    # (operand shape, rows) → (outer, inner) strides, None: copied first
    "per_row": ((4, 2), (4, 2), (2, 1)),
    "per_instance": ((4, 1), (4, 2), (1, 0)),
    "per_channel": ((2,), (4, 2), (0, 1)),
    "scalar": ((), (4, 2), (0, 0)),
    "one_row": ((), (), (0, 0)),
    "folded_groups": ((4, 3, 1), (4, 3, 2), (1, 0)),
    "unfoldable": ((4, 1, 2), (4, 3, 2), None),
}


@pytest.mark.parametrize("case", list(ROW_STRIDES))
def test_row_strides_fold_the_leading_axes(case):
    """An operand is read in place when the leading axes of the rows fold
    into one stride; otherwise the wrapper reads a contiguous copy, whose
    rows are the broadcast operand's."""
    shape, lead, want = ROW_STRIDES[case]
    t = torch.arange(math.prod(shape), dtype=torch.float32).reshape(shape)
    assert iir._row_strides(t.shape, t.stride(), lead) == want
    np.testing.assert_array_equal(staged_rows(t, lead).numpy(),
                                  t.broadcast_to(lead).reshape(-1).numpy())


def test_row_strides_refuse_what_does_not_broadcast():
    with pytest.raises(ValueError, match="does not broadcast"):
        iir._row_strides((3,), (1,), (4, 2))
    with pytest.raises(ValueError, match="does not broadcast"):
        iir._row_strides((2, 4, 2), (8, 2, 1), (4, 2))


@pytest.fixture
def cascade_calls(monkeypatch):
    """Counts the nodes' calls of ``biquad_cascade`` (the plain chain here:
    one call is one launch on the card)."""
    calls = []

    def counted(x, states, sections):
        calls.append(len(tuple(sections)))
        return iir.biquad_cascade(x, states, sections)

    monkeypatch.setattr(teq, "biquad_cascade", counted)
    monkeypatch.setattr(tloud, "biquad_cascade", counted)
    return calls


@pytest.mark.parametrize("mask_kind", MASKS)
def test_eq_runs_its_bands_as_one_cascade(cascade_calls, mask_kind):
    """The example's 3-band EQ, every instance with its own gains: one
    cascade of three sections a block, against the JAX package's band by
    band scan as ``test_torch_fx.test_parametric_eq`` holds it."""
    rng = np.random.default_rng(31)
    jnode, tnode = jn.ParametricEQNode(_bands(jn)), tn.ParametricEQNode(_bands(tn))
    jnode.set_enabled(1, False)
    tnode.set_enabled(1, False)
    jp = jnode.activate(48000, F, 2, 2)
    snaps = []
    for _ in range(B):
        for i in (0, 2):
            jnode.set_band(i, gain_db=float(rng.uniform(-12.0, 12.0)))
        snaps.append(jp.collect_params())
    z = (0.05 * rng.standard_normal((6, B, 2))).astype(np.float32)
    state = {f"z{k}_{i}": z[2 * i + k - 1] for i in range(3) for k in (1, 2)}
    x = rng.standard_normal((B, 2, F)).astype(np.float32)
    run_both(jnode, tnode, 2, 2, _stack(snaps), state, x, _mask(mask_kind, rng, (B, 2)))
    assert cascade_calls == [3]


@pytest.mark.parametrize("nout", [2, 0])
def test_loudness_meter_runs_its_k_weighting_as_one_cascade(cascade_calls, nout):
    """The meter's shelf and high-pass: one cascade of two sections a block,
    against the JAX package's two scans as ``test_torch_loudness`` holds
    them."""
    rng = np.random.default_rng(32)
    state = _meter_state(rng, [100, 4750, 4672, 4790], [3, 0, 17, 30])
    x = (rng.standard_normal((B, 2, F)) * 0.3).astype(np.float32)
    meter_block(nout, state, x, _mask("mixed", rng, (B, 2)))
    assert cascade_calls == [2]
