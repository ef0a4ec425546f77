"""``ops/dynamics.py:scan_lanes`` (K5 on the card) on the CPU, where there is
no card and no nvcc.

A CPU tensor runs the plain version (``scan_reference``) and never builds or
loads ``csrc/sample_scan.cu``.  The operands the wrapper stages for the
kernel (``dynamics.stage``: x and y as ``[lanes, F]``, each carry leaf and
coefficient a number by value or a tensor read in place at an outer and an
inner stride of the lanes, the carry written at a leaf and a lane stride)
give, lane by lane through the plain version, what the whole call gives,
bit for bit, for numbers, per-lane tensors, 0-d tensors, broadcast
``[B, 1]`` views and the pink filter's poles read in place from the node's
``[..., 3]`` state.  The kernel itself is held against the plain version on
the card by ``chip_smoke.py`` (phase 3(b)).
"""

import math

import numpy as np
import pytest
import torch

from firewheel_tpu_torch.ops import cuda_build
from firewheel_tpu_torch.ops import dynamics as td

B, CH, F = 3, 2, 37
KINDS = {"envelope": td.ENVELOPE, "limiter": td.LIMITER, "gate": td.GATE, "pink": td.PINK}
#: ranges of x, the carry leaves and the coefficients, by kind
RANGES = {
    td.ENVELOPE: ((0.0, 1.0), ((0.0, 1.0),), ((0.9, 0.99), (0.99, 0.9999))),
    td.LIMITER: ((0.2, 1.0), ((0.2, 1.0),), ((0.99, 0.9999),)),
    td.GATE: ((0.0, 0.06), ((0.0, 1.0), (0.0, 60.0), (0.0, 1.0)),
              ((0.02, 0.05), (0.005, 0.02), (0.0, 0.5), (0.9, 0.99), (0.999, 0.9999),
               (0.0, 48.0))),
    td.PINK: ((-1.0, 1.0), ((-20.0, 20.0),) * 3, ()),
}
#: a coefficient per lane [B, CH], per instance [B, 1] (a broadcast view),
#: per channel [CH], a 0-d tensor, a number
FORMS = ("per_lane", "per_instance", "per_channel", "zero_d", "number")


@pytest.fixture
def no_kernel(monkeypatch):
    """Any attempt to build or load the kernel library fails the test."""
    def refuse(*args, **kwargs):
        raise AssertionError("the kernel library was built or loaded for a CPU tensor")

    monkeypatch.setattr(td.LIBRARY, "load", refuse)
    monkeypatch.setattr(cuda_build, "_nvcc", refuse)
    monkeypatch.setattr(td.scan_lanes, "launches", 0)


def _draw(g, lo, hi, shape):
    return lo + (hi - lo) * torch.rand(shape, generator=g)


def _operands(kind, form, seed, frames=F):
    g = torch.Generator().manual_seed(seed)
    (xlo, xhi), carry_r, coef_r = RANGES[kind]
    x = _draw(g, xlo, xhi, (B, CH, frames))
    carry = tuple(_draw(g, lo, hi, (B, CH)) for lo, hi in carry_r)
    if kind == td.GATE:  # the latch's open flag and its hold count
        carry = ((carry[0] > 0.5).float(), carry[1].floor(), carry[2])
    shape = {"per_lane": (B, CH), "per_instance": (B, 1), "per_channel": (CH,),
             "zero_d": ()}.get(form)
    coefs = tuple(float(np.float32(_draw(g, lo, hi, ()))) if shape is None
                  else _draw(g, lo, hi, shape) for lo, hi in coef_r)
    return x, carry, coefs


def _lane_values(op, lanes, inner):
    """One staged operand's value per lane, read as the kernel reads it:
    lane ``l`` of ``[lanes // inner, inner]`` at ``(l // inner)·so + (l %
    inner)·si``, or the number for every lane."""
    t, so, si, v = op
    if t is None:
        return torch.full((lanes,), v, dtype=torch.float32)
    return torch.as_strided(t, (lanes // inner, inner), (so, si),
                            t.storage_offset()).reshape(-1)


def _kernel_on_staged(kind, s):
    """The plain version lane by lane on what ``stage`` hands the kernel,
    its carry written into ``carry_out`` at the kernel's strides → y."""
    frames = s.x.shape[-1]
    rows = s.x.reshape(-1, frames)
    lanes = rows.shape[0]
    carry = [_lane_values(op, lanes, s.inner) for op in s.carry]
    coefs = [_lane_values(op, lanes, s.inner) for op in s.coefs]
    out = s.carry_out.view(-1)
    y = torch.empty_like(rows)
    for lane in range(lanes):
        c, y[lane] = td.scan_reference(kind, rows[lane], tuple(v[lane] for v in carry),
                                       tuple(v[lane] for v in coefs))
        for k, leaf in enumerate(c):
            out[k * s.out_leaf + lane * s.out_lane] = leaf
    return y.reshape(s.x.shape)


def _equal(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("kind,form", [(k, f) for k in KINDS for f in FORMS
                                       if k != "pink" or f == "per_lane"])
def test_staged_operands_are_the_kernels_layout(kind, form):
    """The operands ``stage`` hands the kernel give, lane by lane through the
    plain version, the whole call's output and carry, bit for bit; tensors
    are read where they lie and numbers go by value (the pink filter has no
    coefficients)."""
    code = KINDS[kind]
    x, carry, coefs = _operands(code, form, seed=len(form) * 7 + code)
    want_carry, want_y = td.scan_reference(code, x, carry, coefs)
    leaves, stacked = td._check(code, x, carry, coefs)
    s = td.stage(x, leaves, coefs, stacked)
    assert s.inner == CH and s.x.shape == x.shape and s.carry_out.shape == (len(carry), B, CH)
    for op, v in zip(s.carry + s.coefs, carry + coefs):
        if isinstance(v, torch.Tensor):
            assert op[0].data_ptr() == v.data_ptr()  # in place: no stack, no copy
        else:
            assert op[0] is None and op[3] == v  # by value
    y = _kernel_on_staged(code, s)
    assert _equal(y, want_y)
    for got, want in zip(s.carry_out.unbind(0), want_carry, strict=True):
        assert _equal(got, want)


@pytest.mark.parametrize("frames", [1, F, 128])
def test_pink_poles_are_read_and_written_in_place(frames):
    """The pink node's state ``[B, CH, 3]`` goes to the kernel as it lies
    (each pole a view at stride 3) and comes back in that layout: the
    kernel's writes at ``k·1 + lane·3`` are the plain version's carry."""
    g = torch.Generator().manual_seed(frames)
    x = _draw(g, -1.0, 1.0, (B, CH, frames))
    state = _draw(g, -20.0, 20.0, (B, CH, 3))
    want_poles, want_y = td.scan_reference(td.PINK, x, state.unbind(-1), ())
    leaves, stacked = td._check(td.PINK, x, state, ())
    assert stacked
    s = td.stage(x, leaves, (), stacked)
    for k, (t, so, si, _) in enumerate(s.carry):
        assert t.data_ptr() == state.data_ptr() + 4 * k and (so, si) == (3 * CH, 3)
    assert (s.out_leaf, s.out_lane) == (1, 3) and s.carry_out.shape == (B, CH, 3)
    assert _equal(_kernel_on_staged(td.PINK, s), want_y)
    assert _equal(s.carry_out, torch.stack(want_poles, dim=-1))


@pytest.mark.parametrize("kind", list(KINDS))
def test_stacked_carry_equals_the_leaves(no_kernel, kind):  # noqa: F811
    """A carry given as one tensor ``[..., n_carry]`` runs what its leaves
    run and comes back stacked the same way; a CPU tensor never reaches the
    kernel."""
    code = KINDS[kind]
    x, carry, coefs = _operands(code, "per_lane", seed=11)
    leaves_c, leaves_y = td.scan_lanes(code, x, carry, coefs)
    stacked_c, stacked_y = td.scan_lanes(code, x, torch.stack(carry, dim=-1), coefs)
    assert _equal(stacked_y, leaves_y)
    assert _equal(stacked_c, torch.stack(leaves_c, dim=-1))
    assert td.scan_lanes.launches == 0 and td.LIBRARY._lib is None


def test_scan_lanes_refuses_a_carry_of_the_wrong_width():
    x = torch.zeros((2, F))
    with pytest.raises(ValueError, match="3 carry leaves"):
        td.scan_lanes(td.PINK, x, torch.zeros((2, 2)), ())
    with pytest.raises(ValueError, match="float32"):
        td.scan_lanes(td.LIMITER, x, (torch.zeros(2, dtype=torch.float64),), (0.5,))


@pytest.mark.parametrize("lead", [(), (1,), (4,), (2, 3)])
def test_stage_folds_the_lanes(lead):
    """Lanes of any rank: x as ``[lanes, F]`` and ``inner`` the last axis
    (1 for a single lane), the outputs the whole call's."""
    g = torch.Generator().manual_seed(len(lead))
    x = _draw(g, 0.0, 1.0, lead + (F,))
    carry = (_draw(g, 0.0, 1.0, lead),)
    coefs = (torch.tensor(0.95), 0.999)
    want_c, want_y = td.scan_reference(td.ENVELOPE, x, carry, coefs)
    leaves, stacked = td._check(td.ENVELOPE, x, carry, coefs)
    s = td.stage(x, leaves, coefs, stacked)
    assert s.inner == (lead[-1] if lead else 1)
    assert s.x.numel() == math.prod(lead) * F
    assert _equal(_kernel_on_staged(td.ENVELOPE, s), want_y)
    assert _equal(s.carry_out[0], want_c[0])
