"""Biquad coefficients (the Audio-EQ-Cookbook designs), the
associative-scan biquad, and the one-pole lowpass scan.

PyTorch port of ``firewheel_tpu/ops/iir.py:125-333``.  The designs take
float32 tensors of any shape (one filter per element: every instance of a
batch carries its own frequency and Q) and evaluate the same float32 ops
in the same order as the JAX package; given host numbers instead, they
run in numpy float32, as the JAX package's do.  A section runs either through
:func:`biquad_scan` (the JAX package's default, ``FilterNode("auto")``) or
through the sequential kernel :func:`firewheel_tpu_torch.ops.seq_iir.
biquad_seq` (``FilterNode("pallas")``).

The scans, :func:`biquad_cascade` (biquad sections in series over the
same rows; :func:`biquad_scan` is its one-section call) and
:func:`one_pole_scan`, are wrappers: CPU tensors run their plain versions
(:func:`biquad_cascade_reference`, :func:`biquad_scan_reference`,
:func:`one_pole_scan_reference`, the recursion of ``lax.associative_scan``
op by op); CUDA tensors launch ``csrc/assoc_scan.cu`` (K7, one launch a
call, the same compositions rounded the same way, bit for bit, for rows of
any length) or raise.  Numbers go to the kernel by value and tensors in
place, so a call copies nothing from the host.

Their backwards, :func:`biquad_cascade_backward` and
:func:`one_pole_scan_backward`, are wrappers of the same kind: CPU tensors
run the plain reverse-time recurrences
(:func:`biquad_cascade_backward_reference`,
:func:`one_pole_scan_backward_reference`); CUDA tensors launch
``csrc/assoc_scan_bwd.cu`` (K8) or raise.  On the card, where autograd
records, the forward wrappers launch K7 inside a
``torch.autograd.Function`` whose backward launches K8; on the CPU
autograd differentiates the plain scans, as JAX differentiates its own.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from .cuda_build import CudaLibrary

__all__ = [
    "BiquadCoeffs",
    "biquad_lowpass",
    "biquad_highpass",
    "biquad_bandpass",
    "biquad_notch",
    "biquad_peaking",
    "biquad_low_shelf",
    "biquad_high_shelf",
    "biquad_allpass",
    "biquad_scan",
    "biquad_scan_reference",
    "biquad_cascade",
    "biquad_cascade_reference",
    "MAX_SECTIONS",
    "one_pole_coeffs",
    "one_pole_scan",
    "one_pole_scan_reference",
    "biquad_cascade_backward",
    "biquad_cascade_backward_reference",
    "one_pole_scan_backward",
    "one_pole_scan_backward_reference",
    "LIBRARY",
    "BWD_LIBRARY",
]

_TWO_PI_F32 = float(np.float32(2.0 * math.pi))


class BiquadCoeffs(NamedTuple):
    """Normalized biquad coefficients (a0 == 1)."""

    b0: torch.Tensor
    b1: torch.Tensor
    b2: torch.Tensor
    a1: torch.Tensor
    a2: torch.Tensor


def _wq(freq_hz, q, sample_rate):
    if _host(freq_hz, q):
        # the JAX package's host staging: numpy float32, op for op
        w0 = np.float32(2.0 * math.pi) * np.asarray(freq_hz, np.float32) / np.float32(
            sample_rate)
        sin_w0, cos_w0 = np.sin(w0), np.cos(w0)
        return w0, sin_w0, cos_w0, sin_w0 / (np.float32(2.0) * np.asarray(q, np.float32))
    w0 = _TWO_PI_F32 * freq_hz.to(torch.float32) / float(np.float32(sample_rate))
    sin_w0 = torch.sin(w0)
    cos_w0 = torch.cos(w0)
    alpha = sin_w0 / (2.0 * q.to(torch.float32))
    return w0, sin_w0, cos_w0, alpha


def _host(*vals) -> bool:
    """True for host numbers (no tensor among ``vals``): the designs then
    run in numpy float32, as the JAX package's do on concrete values
    (``firewheel_tpu/ops/iir.py:_xp``), so host-staged coefficients (the
    parametric EQ's) equal the JAX package's bit for bit; torch's and
    numpy's float32 sin, cos and pow differ by an ulp or a few."""
    return not any(isinstance(v, torch.Tensor) for v in vals)


def _norm(b0, b1, b2, a0, a1, a2) -> BiquadCoeffs:
    inv = 1.0 / a0
    return BiquadCoeffs(b0 * inv, b1 * inv, b2 * inv, a1 * inv, a2 * inv)


def _gain_a(gain_db):
    if _host(gain_db):
        return np.power(np.float32(10.0), np.asarray(gain_db, np.float32) / 40.0)
    return torch.pow(10.0, gain_db.to(torch.float32) / 40.0)


def _sqrt(a):
    return np.sqrt(a) if _host(a) else torch.sqrt(a)


def biquad_lowpass(freq_hz, q, sample_rate) -> BiquadCoeffs:
    w0, s, c, alpha = _wq(freq_hz, q, sample_rate)
    b1 = 1.0 - c
    b0 = b2 = b1 * 0.5
    return _norm(b0, b1, b2, 1.0 + alpha, -2.0 * c, 1.0 - alpha)


def biquad_highpass(freq_hz, q, sample_rate) -> BiquadCoeffs:
    w0, s, c, alpha = _wq(freq_hz, q, sample_rate)
    b1 = -(1.0 + c)
    b0 = b2 = (1.0 + c) * 0.5
    return _norm(b0, b1, b2, 1.0 + alpha, -2.0 * c, 1.0 - alpha)


def biquad_bandpass(freq_hz, q, sample_rate) -> BiquadCoeffs:
    """Constant 0 dB peak gain bandpass."""
    w0, s, c, alpha = _wq(freq_hz, q, sample_rate)
    return _norm(alpha, 0.0 * alpha, -alpha, 1.0 + alpha, -2.0 * c, 1.0 - alpha)


def biquad_notch(freq_hz, q, sample_rate) -> BiquadCoeffs:
    w0, s, c, alpha = _wq(freq_hz, q, sample_rate)
    one = np.ones_like(alpha) if _host(alpha) else torch.ones_like(alpha)
    return _norm(one, -2.0 * c, one, 1.0 + alpha, -2.0 * c, 1.0 - alpha)


def biquad_allpass(freq_hz, q, sample_rate) -> BiquadCoeffs:
    w0, s, c, alpha = _wq(freq_hz, q, sample_rate)
    return _norm(
        1.0 - alpha, -2.0 * c, 1.0 + alpha, 1.0 + alpha, -2.0 * c, 1.0 - alpha
    )


def biquad_peaking(freq_hz, q, gain_db, sample_rate) -> BiquadCoeffs:
    w0, s, c, alpha = _wq(freq_hz, q, sample_rate)
    A = _gain_a(gain_db)
    return _norm(
        1.0 + alpha * A,
        -2.0 * c,
        1.0 - alpha * A,
        1.0 + alpha / A,
        -2.0 * c,
        1.0 - alpha / A,
    )


def biquad_low_shelf(freq_hz, q, gain_db, sample_rate) -> BiquadCoeffs:
    w0, s, c, alpha = _wq(freq_hz, q, sample_rate)
    A = _gain_a(gain_db)
    sq = 2.0 * _sqrt(A) * alpha
    return _norm(
        A * ((A + 1.0) - (A - 1.0) * c + sq),
        2.0 * A * ((A - 1.0) - (A + 1.0) * c),
        A * ((A + 1.0) - (A - 1.0) * c - sq),
        (A + 1.0) + (A - 1.0) * c + sq,
        -2.0 * ((A - 1.0) + (A + 1.0) * c),
        (A + 1.0) + (A - 1.0) * c - sq,
    )


def biquad_high_shelf(freq_hz, q, gain_db, sample_rate) -> BiquadCoeffs:
    w0, s, c, alpha = _wq(freq_hz, q, sample_rate)
    A = _gain_a(gain_db)
    sq = 2.0 * _sqrt(A) * alpha
    return _norm(
        A * ((A + 1.0) + (A - 1.0) * c + sq),
        -2.0 * A * ((A - 1.0) + (A + 1.0) * c),
        A * ((A + 1.0) + (A - 1.0) * c - sq),
        (A + 1.0) - (A - 1.0) * c + sq,
        2.0 * ((A - 1.0) - (A + 1.0) * c),
        (A + 1.0) - (A - 1.0) * c - sq,
    )


# ---------------------------------------------------------------------------
# Biquad evaluation: associative scan over the TDF-II state recurrence
# ---------------------------------------------------------------------------

def _associative_scan(compose, elems):
    """Inclusive scan of ``elems`` (a tuple of equally shaped tensors) along
    the last axis, with ``compose(earlier, later)``: the recursion of
    ``jax.lax.associative_scan``, pair for pair, so every element is
    composed from the same partial products in the same order."""
    n = elems[0].shape[-1]
    if n < 2:
        return elems
    odd = _associative_scan(compose, compose(
        tuple(e[..., 0:n - 1:2] for e in elems),
        tuple(e[..., 1::2] for e in elems)))
    if n % 2 == 0:
        even = compose(tuple(e[..., :-1] for e in odd),
                       tuple(e[..., 2::2] for e in elems))
    else:
        even = compose(odd, tuple(e[..., 2::2] for e in elems))
    out = []
    for e, ev, od in zip(elems, even, odd):
        r = torch.empty_like(e)
        r[..., 0] = e[..., 0]
        r[..., 2::2] = ev
        r[..., 1::2] = od
        out.append(r)
    return tuple(out)


def _compose(e1, e2):
    """``e2 ∘ e1`` of two affine maps of the 2-vector state: ``M = M2·M1``,
    ``v = M2·v1 + v2``, the 2×2 products unrolled."""
    p11, p12, p21, p22, q1, q2 = e1
    r11, r12, r21, r22, s1, s2 = e2
    return (
        r11 * p11 + r12 * p21,
        r11 * p12 + r12 * p22,
        r21 * p11 + r22 * p21,
        r21 * p12 + r22 * p22,
        r11 * q1 + r12 * q2 + s1,
        r21 * q1 + r22 * q2 + s2,
    )


def biquad_scan_reference(x: torch.Tensor, z_prev, coeffs: BiquadCoeffs):
    """Plain version of :func:`biquad_scan`: one biquad section along the
    last axis as an associative scan, op by op.

    Transposed direct-form II::

        y[n]  = b0*x[n] + z1[n-1]
        z1[n] = (b1 - a1*b0)*x[n] - a1*z1[n-1] + z2[n-1]
        z2[n] = (b2 - a2*b0)*x[n] - a2*z1[n-1]

    The state ``z = (z1, z2)`` follows ``z[n] = A z[n-1] + B x[n]`` with
    ``A = [[-a1, 1], [-a2, 0]]``; the affine maps are composed by
    :func:`_associative_scan`, the carry is applied after the scan, and
    ``y`` reads the shifted ``z1``.

    ``x f32[..., n]``; ``z_prev = (z1, z2)`` each ``f32[...]``; each
    coefficient broadcasts to ``x.shape[:-1]``.  Returns ``(y f32[..., n],
    (z1_last, z2_last))``.
    """
    b0, b1, b2, a1, a2 = (
        torch.as_tensor(c, dtype=torch.float32, device=x.device)[..., None]
        for c in coeffs
    )
    z1p, z2p = z_prev
    shape = x.shape
    el = (
        (-a1).expand(shape),
        torch.ones_like(x),
        (-a2).expand(shape),
        torch.zeros_like(x),
        (b1 - a1 * b0) * x,
        (b2 - a2 * b0) * x,
    )
    c11, c12, c21, c22, w1, w2 = _associative_scan(_compose, el)
    z1 = c11 * z1p[..., None] + c12 * z2p[..., None] + w1
    z2 = c21 * z1p[..., None] + c22 * z2p[..., None] + w2
    n = shape[-1]
    z1_prev_seq = torch.cat([z1p[..., None].expand(z1[..., :1].shape),
                             z1[..., :n - 1]], dim=-1)
    y = b0 * x + z1_prev_seq
    return y, (z1[..., n - 1], z2[..., n - 1])


# ---------------------------------------------------------------------------
# One-pole lowpass (the smoother's filter, generalized)
# ---------------------------------------------------------------------------

def one_pole_coeffs(cutoff_hz, sample_rate):
    """``b = exp(-2π·fc/sr)``: the one-pole lowpass ``y = a·x + b·y_prev``
    with ``a = 1 - b``.  A tensor in gives tensors (float32); anything else
    numpy float32.  Returns ``(a, b)``."""
    if isinstance(cutoff_hz, torch.Tensor):
        b = torch.exp(-_TWO_PI_F32 * cutoff_hz.to(torch.float32)
                      / float(np.float32(sample_rate)))
        return 1.0 - b, b
    b = np.exp(np.float32(-2.0 * math.pi) * cutoff_hz / np.float32(sample_rate))
    return np.float32(1.0) - b, b


def _fma(a, b, c):
    """float32 ``a·b + c``, rounded as one fused multiply-add: the float64
    product of two float32 values is exact, so only the sum rounds, to
    float64 and then to float32.  That double rounding differs from a true
    FMA only when the float64 sum lands exactly halfway between two float32
    values (about one operation in 2^28), by one float32 ulp.  A number
    among the operands is a float32 constant."""
    a, b, c = (v.double() if isinstance(v, torch.Tensor) else v for v in (a, b, c))
    return (a * b + c).float()


def _one_pole_compose(e1, e2):
    """``e2 ∘ e1`` of two affine maps ``y ↦ m·y + v``; ``v1·m2 + v2`` is
    the fused multiply-add that XLA makes of it on the CPU."""
    m1, v1 = e1
    m2, v2 = e2
    return m1 * m2, _fma(v1, m2, v2)


def one_pole_scan_reference(x: torch.Tensor, y_prev: torch.Tensor, a, b):
    """Plain version of :func:`one_pole_scan`: ``y[n] = a·x[n] + b·y[n-1]``
    along the last axis as an associative scan, op by op.

    ``x f32[..., n]``; ``y_prev f32[...]`` (the carry, ``x.shape[:-1]``);
    ``a`` and ``b`` are Python floats or float32 tensors that broadcast to
    ``x`` (a scalar, or ``[..., 1]`` with one coefficient per row).  The
    affine maps ``(b, a·x[n])`` are composed by :func:`_associative_scan`,
    as ``lax.associative_scan`` composes them, and the carry is applied
    after the scan, with the fused multiply-adds that XLA makes on the CPU
    (equal to the JAX package's scan under ``jit`` at 2, 127, 128 and 1024
    frames; at 1 and 3 frames XLA fuses differently, an ulp apart).
    Returns ``(y f32[..., n], y_last f32[...])``."""
    m = torch.as_tensor(b, dtype=torch.float32, device=x.device).expand(x.shape)
    v = a * x
    mm, vv = _associative_scan(_one_pole_compose, (m, v))
    y = _fma(mm, y_prev[..., None], vv)
    return y, y[..., x.shape[-1] - 1]




def biquad_cascade_reference(x: torch.Tensor, states, sections):
    """Plain version of :func:`biquad_cascade`: the sections in series, each
    one :func:`biquad_scan_reference` on the output of the one before.
    Returns ``(y, ((z1, z2), ...))``, the states in the sections' order."""
    out = []
    for z, c in zip(states, sections, strict=True):
        x, z = biquad_scan_reference(x, z, c)
        out.append(z)
    return x, tuple(out)


# ---------------------------------------------------------------------------
# The backwards: reverse-time recurrences, frame by frame
# ---------------------------------------------------------------------------

def _rows(v, lead, device) -> torch.Tensor:
    """A per-row operand (a number, or a tensor that broadcasts to
    ``lead``) as float32 ``[*lead]``."""
    return torch.as_tensor(v, dtype=torch.float32, device=device).broadcast_to(lead)


def one_pole_scan_backward_reference(x, y, y_prev, a, b, g_y, g_y_last):
    """Plain version of :func:`one_pole_scan_backward`: the vector-Jacobian
    product of :func:`one_pole_scan` at ``(x, y_prev, a, b)``, whose output
    was ``y``, for the output gradients ``g_y f32[..., n]`` and ``g_y_last
    f32[...]``.

    The adjoint of ``y[n] = a·x[n] + b·y[n-1]`` runs backwards in time:
    ``λ[n] = g_y[n] + b·λ[n+1]`` (``g_y_last`` joins at the last frame),
    ``g_x[n] = a·λ[n]``, ``g_a = Σ λ·x``, ``g_b = Σ λ[n]·y[n-1]`` and the
    carry's ``g_y_prev = b·λ[0]``, in float32, one frame at a time.  ``a``
    and ``b`` broadcast as :func:`one_pole_scan` takes them; their gradients
    come out one a row.  Returns ``(g_x f32[..., n], g_y_prev f32[...],
    (g_a, g_b))``, each gradient but ``g_x`` shaped ``x.shape[:-1]``."""
    lead, n = x.shape[:-1], x.shape[-1]
    a, b = (_rows(_per_row(c, x), lead, x.device) for c in (a, b))
    lam = g_y_last.to(torch.float32).broadcast_to(lead)
    g_a = torch.zeros(lead, dtype=torch.float32, device=x.device)
    g_b = torch.zeros_like(g_a)
    g_x = torch.empty_like(x)
    for i in range(n - 1, -1, -1):
        lam = lam + g_y[..., i]
        g_x[..., i] = a * lam
        g_a = g_a + lam * x[..., i]
        g_b = g_b + lam * (y[..., i - 1] if i else y_prev)
        lam = b * lam
    return g_x, lam, (g_a, g_b)


def _seq_forward(x: torch.Tensor, z_prev, coeffs):
    """One TDF-II biquad section run frame by frame in float32 (``y = b0·x
    + z1``, ``z1 = (b1·x − a1·y) + z2``, ``z2 = b2·x − a2·y``), each
    coefficient broadcasting to ``x.shape[:-1]``: the inputs of a cascade's
    later sections as its backward recomputes them.  Returns ``y``."""
    lead = x.shape[:-1]
    b0, b1, b2, a1, a2 = (_rows(c, lead, x.device) for c in coeffs)
    z1, z2 = (_rows(z, lead, x.device) for z in z_prev)
    y = torch.empty_like(x)
    for i in range(x.shape[-1]):
        xi = x[..., i]
        yi = b0 * xi + z1
        z1 = (b1 * xi - a1 * yi) + z2
        z2 = b2 * xi - a2 * yi
        y[..., i] = yi
    return y


def _section_backward(x, y, coeffs, g_y, g_z_out):
    """The vector-Jacobian product of one biquad section (``biquad_scan``)
    whose input was ``x`` and output ``y``, for ``g_y f32[..., n]`` and the
    state out's ``g_z_out = (g_z1, g_z2)``.

    The adjoint ``μ = (μ1, μ2)`` of the state runs the transposed recurrence
    backwards: the output's adjoint is ``e = (g_y[n] − a1·μ1) − a2·μ2``;
    ``g_x[n] = (b0·e + b1·μ1) + b2·μ2``; ``g_b0 += e·x[n]``, ``g_b1 +=
    μ1·x[n]``, ``g_b2 += μ2·x[n]``, ``g_a1 −= μ1·y[n]``, ``g_a2 −=
    μ2·y[n]``; then ``μ ← (e, μ1)``.  The section's states are not needed.
    Returns ``(g_x, (g_z1_in, g_z2_in), BiquadCoeffs of per-row
    gradients)``."""
    lead = x.shape[:-1]
    b0, b1, b2, a1, a2 = (_rows(c, lead, x.device) for c in coeffs)
    mu1, mu2 = (g.to(torch.float32).broadcast_to(lead) for g in g_z_out)
    g = [torch.zeros(lead, dtype=torch.float32, device=x.device) for _ in range(5)]
    g_x = torch.empty_like(x)
    for i in range(x.shape[-1] - 1, -1, -1):
        xi, yi = x[..., i], y[..., i]
        e = (g_y[..., i] - a1 * mu1) - a2 * mu2
        g_x[..., i] = (b0 * e + b1 * mu1) + b2 * mu2
        g[0] = g[0] + e * xi
        g[1] = g[1] + mu1 * xi
        g[2] = g[2] + mu2 * xi
        g[3] = g[3] - mu1 * yi
        g[4] = g[4] - mu2 * yi
        mu1, mu2 = e, mu1
    return g_x, (mu1, mu2), BiquadCoeffs(*g)


def biquad_cascade_backward_reference(x, y, states, sections, g_y, g_states):
    """Plain version of :func:`biquad_cascade_backward`: the vector-Jacobian
    product of :func:`biquad_cascade` at ``(x, states, sections)``, whose
    output was ``y``, for ``g_y`` and each section's state-out gradients
    ``g_states = ((g_z1, g_z2), ...)``.

    The sections run in reverse order, each through
    :func:`_section_backward`.  Section ``s``'s input is
    recomputed from ``x`` and the initial states by running the sections
    before it frame by frame (:func:`_seq_forward`); the last
    section's output is ``y``.  Returns ``(g_x, ((g_z1_in, g_z2_in), ...),
    (BiquadCoeffs, ...))``, the per-row gradients in the sections' order."""
    states, sections = tuple(states), tuple(sections)
    ins = [x]
    for z, c in zip(states[:-1], sections[:-1]):
        ins.append(_seq_forward(ins[-1], z, c))
    outs = ins[1:] + [y]
    g_z, g_c = [None] * len(sections), [None] * len(sections)
    g = g_y
    for s in range(len(sections) - 1, -1, -1):
        g, g_z[s], g_c[s] = _section_backward(
            ins[s], outs[s], sections[s], g, g_states[s])
    return g, tuple(g_z), tuple(g_c)


# ---------------------------------------------------------------------------
# The wrappers: the plain versions on the CPU, K7 on the card
# ---------------------------------------------------------------------------

#: a cascade's sections a launch (``csrc/assoc_scan.cu:kMaxSections``)
MAX_SECTIONS = 8


class _Operand(ctypes.Structure):
    """``csrc/assoc_scan.cu:Operand``: row ``r`` of rows ``[outer, inner]``
    reads ``p[(r // inner) * so + (r % inner) * si]``, or ``v`` when ``p``
    is null."""

    _fields_ = [("p", ctypes.c_void_p), ("so", ctypes.c_int64), ("si", ctypes.c_int64),
                ("v", ctypes.c_float)]


class _BiquadArgs(ctypes.Structure):
    _fields_ = [("coef", (_Operand * 5) * MAX_SECTIONS),
                ("z_in", (_Operand * 2) * MAX_SECTIONS),
                ("z_out", ctypes.c_void_p), ("inner", ctypes.c_int64),
                ("sections", ctypes.c_int)]


class _OnePoleArgs(ctypes.Structure):
    _fields_ = [("a", _Operand), ("b", _Operand), ("y_in", _Operand),
                ("y_out", ctypes.c_void_p), ("inner", ctypes.c_int64)]


def _bind(lib):
    tail = [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lib.fw_biquad_cascade.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.POINTER(_BiquadArgs), *tail]
    lib.fw_one_pole_scan.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.POINTER(_OnePoleArgs), *tail]
    lib.fw_biquad_cascade.restype = lib.fw_one_pole_scan.restype = ctypes.c_int
    lib.fw_scan_workspace_bytes.argtypes = [ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                                            ctypes.c_int]
    lib.fw_scan_workspace_bytes.restype = ctypes.c_int64


#: ``csrc/assoc_scan.cu``, built with nvcc at first use
LIBRARY = CudaLibrary("fw_assoc_scan", "assoc_scan.cu", ("assoc_scan.cuh",), _bind)


def _row_strides(shape, strides, lead):
    """The element strides ``(outer, inner)`` with which the rows
    ``[prod(lead[:-1]), lead[-1]]`` read a tensor of ``shape`` and
    ``strides`` broadcast to ``lead``, or None when its leading axes do not
    fold into one stride.  Raises when it does not broadcast."""
    if len(shape) > len(lead) and any(s != 1 for s in shape[:len(shape) - len(lead)]):
        raise ValueError(f"an operand of shape {tuple(shape)} does not broadcast "
                         f"to the rows {tuple(lead)}")
    pad = len(lead) - len(shape)
    st = []
    for k, size in enumerate(lead):
        j = k - pad
        have = shape[j] if j >= 0 else 1
        if have == size and size != 1:
            st.append(strides[j])
        elif have == 1:
            st.append(0)
        else:
            raise ValueError(f"an operand of shape {tuple(shape)} does not "
                             f"broadcast to the rows {tuple(lead)}")
    if not st:
        return 0, 0
    outer = expect = None
    for k in range(len(lead) - 2, -1, -1):
        if lead[k] == 1:
            continue
        if outer is None:
            outer, expect = st[k], st[k] * lead[k]
        elif st[k] != expect:
            return None
        else:
            expect *= lead[k]
    return outer or 0, st[-1]


def _operand(v, lead, device):
    """A per-row operand (a number, or a tensor that broadcasts to
    ``lead``) as the kernel reads it → ``(tensor or None, outer stride,
    inner stride, value)``.  A number goes by value; a float32 tensor is
    read in place where its leading axes fold into one stride, else from a
    contiguous copy on the device.  Host arrays of more than one value cross
    in one copy."""
    if isinstance(v, (float, int, np.floating)):
        return None, 0, 0, float(np.float32(v))
    if not isinstance(v, torch.Tensor):
        a = np.asarray(v, np.float32)
        if a.size == 1:
            return None, 0, 0, float(a.reshape(()))
        v = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    if v.device != device:
        raise ValueError(f"an operand is on {v.device}, x is on {device}")
    if v.dtype != torch.float32:
        v = v.float()
    if lead and v.ndim == len(lead) and v.shape[:-1] == lead[:-1] and v.is_contiguous():
        if v.shape[-1] == lead[-1]:  # one value a row, in order
            return v, lead[-1], 1, 0.0
        if v.shape[-1] == 1:  # one value for the last axis (a filter an instance)
            return v, 1, 0, 0.0
    strides = _row_strides(v.shape, v.stride(), lead)
    if strides is None:
        v = v.broadcast_to(lead).contiguous()
        strides = _row_strides(v.shape, v.stride(), lead)
    return (v, *strides, 0.0)


def _c_operand(op, keep) -> _Operand:
    t, so, si, v = op
    if t is None:
        return _Operand(None, 0, 0, v)
    keep.append(t)
    return _Operand(t.data_ptr(), so, si, v)


def _check(x: torch.Tensor, name: str) -> torch.Tensor:
    """x for the kernel: float32 on a CUDA device, contiguous, aligned to 16
    bytes (the register kernels' vector loads)."""
    if x.device.type != "cuda" or x.dtype != torch.float32:
        raise ValueError(f"{name}: x must be float32 on a CUDA device or the CPU, "
                         f"got {x.dtype} on {x.device}")
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


@contextlib.contextmanager
def _on_device(device: torch.device):
    """Make ``device`` the current CUDA device for a launch of K5, K7, K8
    or K9 (CUDA refuses a launch onto another device's stream) and yield
    its current stream, as the kernels take it."""
    with torch.cuda.device(device):
        yield torch.cuda.current_stream().cuda_stream


def _launch(entry: str, wrapper, x, args, biquad: bool, sections: int, rows: int):
    """Launch ``entry`` (``fw_biquad_cascade`` or ``fw_one_pole_scan``) over
    the rows of ``x`` with ``args`` → y; counts the launch on ``wrapper``.
    Rows the shared design runs past a CTA's shared memory, and a cascade's
    intermediate outputs there, get the device-memory workspace the kernel
    asks for (``fw_scan_workspace_bytes``).  The kernel refuses rows of no
    frames (cudaErrorInvalidValue, raised here)."""
    frames = x.shape[-1]
    y = torch.empty_like(x)
    if rows:
        lib = LIBRARY.load()
        ws_bytes = lib.fw_scan_workspace_bytes(int(biquad), rows, frames, sections)
        ws = (torch.empty((ws_bytes // 4,), dtype=torch.float32, device=x.device)
              if ws_bytes else None)
        with _on_device(x.device) as stream:
            err = getattr(lib, entry)(x.data_ptr(), y.data_ptr(), ctypes.byref(args), rows,
                                      frames, ws.data_ptr() if ws is not None else None, stream)
        if err != 0:
            raise RuntimeError(f"{wrapper.__name__}: kernel launch failed on rows of "
                               f"{frames} frames (cudaError {err})")
        wrapper.launches += 1
    return y


def _cascade_launch(x, states, sections):
    """One launch of K7 over up to :data:`MAX_SECTIONS` sections on a
    checked ``x`` (:func:`_check`) → ``(y, z_out f32[2·S, *lead])``, the
    states out in the sections' order."""
    lead = x.shape[:-1]
    keep = []
    # [S, 2, rows] for the kernel; each state a view of one row
    z_out = torch.empty((2 * len(sections),) + lead, dtype=torch.float32, device=x.device)
    args = _BiquadArgs(z_out=z_out.data_ptr(), inner=lead[-1] if lead else 1,
                       sections=len(sections))
    for s, (c, z) in enumerate(zip(sections, states)):
        coef, z_in = args.coef[s], args.z_in[s]
        for k, v in enumerate(c):
            coef[k] = _c_operand(_operand(v, lead, x.device), keep)
        for k, v in enumerate(z):
            z_in[k] = _c_operand(_operand(v, lead, x.device), keep)
    y = _launch("fw_biquad_cascade", biquad_cascade, x, args, True, len(sections),
                math.prod(lead))
    return y, z_out


def _one_pole_launch(x, y_prev, a, b):
    """One launch of K7's one-pole on a checked ``x``, ``a`` and ``b`` one a
    row (:func:`_per_row`) → ``(y, y_out f32[*lead])``."""
    lead = x.shape[:-1]
    rows = math.prod(lead)
    keep = []
    y_out = torch.empty((rows,), dtype=torch.float32, device=x.device)
    args = _OnePoleArgs(*(_c_operand(_operand(v, lead, x.device), keep)
                          for v in (a, b, y_prev)),
                        y_out=y_out.data_ptr(), inner=lead[-1] if lead else 1)
    y = _launch("fw_one_pole_scan", one_pole_scan, x, args, False, 1, rows)
    return y, y_out.view(lead)


def _wants_grad(*values) -> bool:
    """True when autograd records: grad mode is on and a tensor among
    ``values`` requires a gradient."""
    return torch.is_grad_enabled() and any(
        isinstance(v, torch.Tensor) and v.requires_grad for v in values)


def _sum_to(g: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A per-row gradient ``g`` summed to the shape of the operand ``v``
    that was broadcast to its rows (leading axes of 1 beyond the rows'
    included)."""
    shape = v.shape[max(v.ndim - g.ndim, 0):]
    return g.sum_to_size(shape).reshape(v.shape).to(v.dtype)


def _input_grads(ctx, first: int, values, per_row):
    """The gradients an autograd Function returns for its operand inputs
    ``values`` (inputs ``first``, ``first + 1``, ...): each tensor's
    per-row gradient summed to its shape where autograd asks for it, None
    for numbers."""
    return tuple(
        _sum_to(g, v) if isinstance(v, torch.Tensor) and ctx.needs_input_grad[first + i]
        else None
        for i, (v, g) in enumerate(zip(values, per_row)))


def _saved(ctx, values):
    """Keep the numbers among ``values`` on ``ctx`` and return the tensors,
    for ``save_for_backward``; :func:`_restored` puts them back in order."""
    ctx.numbers = [None if isinstance(v, torch.Tensor) else v for v in values]
    return [v for v in values if isinstance(v, torch.Tensor)]


def _restored(ctx, tensors):
    it = iter(tensors)
    return [next(it) if v is None else v for v in ctx.numbers]


def _split_sections(flat):
    """``(sections, states)`` from the flat operands: each section's five
    coefficients and then its two states."""
    sections = tuple(BiquadCoeffs(*flat[i:i + 5]) for i in range(0, len(flat), 7))
    states = tuple(tuple(flat[i + 5:i + 7]) for i in range(0, len(flat), 7))
    return sections, states


class _CascadeFn(torch.autograd.Function):
    """Up to :data:`MAX_SECTIONS` biquad sections on the card: K7 forward
    (:func:`_cascade_launch`, its counts and bits unchanged), K8 backward
    (:func:`biquad_cascade_backward`).  Inputs ``(x, *flat)``: each
    section's ``b0, b1, b2, a1, a2, z1, z2``, tensors or numbers.  Outputs
    ``(y, z_out)``; the state-out gradient reaches the backward through
    ``z_out``, so a render of K blocks differentiates through its
    states."""

    @staticmethod
    def forward(ctx, x, *flat):
        sections, states = _split_sections(flat)
        y, z_out = _cascade_launch(x, states, sections)
        ctx.save_for_backward(x, y, *_saved(ctx, flat))
        return y, z_out

    @staticmethod
    def backward(ctx, g_y, g_z):
        x, y, *tensors = ctx.saved_tensors
        flat = _restored(ctx, tensors)
        sections, states = _split_sections(flat)
        zs = g_z.unbind(0)
        g_x, g_states, g_coeffs = biquad_cascade_backward(
            x, y, states, sections, g_y, tuple(zip(zs[0::2], zs[1::2])))
        per_row = [g for c, z in zip(g_coeffs, g_states) for g in (*c, *z)]
        return (g_x if ctx.needs_input_grad[0] else None,
                *_input_grads(ctx, 1, flat, per_row))


class _OnePoleFn(torch.autograd.Function):
    """The one-pole on the card: K7 forward (:func:`_one_pole_launch`), K8
    backward (:func:`one_pole_scan_backward`).  Inputs ``(x, y_prev, a,
    b)``, ``a`` and ``b`` one a row; outputs ``(y, y_last)``."""

    @staticmethod
    def forward(ctx, x, y_prev, a, b):
        y, y_last = _one_pole_launch(x, y_prev, a, b)
        ctx.save_for_backward(x, y, *_saved(ctx, (y_prev, a, b)))
        return y, y_last

    @staticmethod
    def backward(ctx, g_y, g_last):
        x, y, *tensors = ctx.saved_tensors
        y_prev, a, b = operands = _restored(ctx, tensors)
        # a and b as one_pole_scan takes them: one a row, against the frames
        a_f, b_f = (c[..., None] if isinstance(c, torch.Tensor) and c.ndim else c
                    for c in (a, b))
        g_x, g_prev, (g_a, g_b) = one_pole_scan_backward(x, y, y_prev, a_f, b_f, g_y, g_last)
        return (g_x if ctx.needs_input_grad[0] else None,
                *_input_grads(ctx, 1, operands, (g_prev, g_a, g_b)))


def biquad_cascade(x: torch.Tensor, states, sections):
    """Run biquad sections in series along the last axis: section ``s + 1``
    filters section ``s``'s output, as :func:`biquad_cascade_reference`
    does (its contract: bit for bit the calls of :func:`biquad_scan` it
    replaces).  ``states``: each section's ``(z1, z2)``; ``sections``: each
    section's :class:`BiquadCoeffs`; tensors or numbers, each broadcasting
    to ``x.shape[:-1]``.  Returns ``(y, ((z1, z2), ...))``.

    CPU tensors run :func:`biquad_cascade_reference` (autograd
    differentiates its scan, as JAX differentiates its own).  On a CUDA
    tensor K7 runs up to :data:`MAX_SECTIONS` sections a launch, each one's
    output kept on chip as the next one's input, and adds one to
    ``biquad_cascade.launches`` a launch; where autograd records, each
    launch is a :class:`_CascadeFn` whose backward launches K8."""
    states, sections = tuple(states), tuple(sections)
    if not sections or len(states) != len(sections):
        raise ValueError(f"biquad_cascade: {len(sections)} sections, {len(states)} states")
    if x.device.type == "cpu":
        return biquad_cascade_reference(x, states, sections)
    x = _check(x, "biquad_cascade")
    out = []
    for i in range(0, len(sections), MAX_SECTIONS):
        part, zpart = sections[i:i + MAX_SECTIONS], states[i:i + MAX_SECTIONS]
        flat = [v for c, z in zip(part, zpart) for v in (*c, *z)]
        if _wants_grad(x, *flat):
            x, z_out = _CascadeFn.apply(x, *flat)
        else:
            x, z_out = _cascade_launch(x, zpart, part)
        zs = z_out.unbind(0)
        out.extend(zip(zs[0::2], zs[1::2]))
    return x, tuple(out)


def biquad_scan(x: torch.Tensor, z_prev, coeffs: BiquadCoeffs):
    """Run one biquad section along the last axis, as
    :func:`biquad_scan_reference` does (its contract): the one-section
    :func:`biquad_cascade` (CPU tensors run the plain version; on a CUDA
    tensor one launch of K7, counted on ``biquad_cascade.launches``)."""
    y, (z,) = biquad_cascade(x, (z_prev,), (coeffs,))
    return y, z


def _per_row(c, x):
    """A one-pole coefficient as the plain version broadcasts it (a number,
    or a tensor that broadcasts to ``x`` with a last axis of 1) → its value
    per row, broadcasting to ``x.shape[:-1]``."""
    if not isinstance(c, torch.Tensor) or c.ndim == 0:
        return c
    if c.shape[-1] != 1:
        raise ValueError(f"one_pole_scan: a coefficient of shape {tuple(c.shape)} "
                         f"is not one per row of x {tuple(x.shape)}")
    return c[..., 0]


def one_pole_scan(x: torch.Tensor, y_prev: torch.Tensor, a, b):
    """Run ``y[n] = a·x[n] + b·y[n-1]`` along the last axis, as
    :func:`one_pole_scan_reference` does (its contract).

    CPU tensors run :func:`one_pole_scan_reference`.  On a CUDA tensor K7
    runs the scan in one launch and adds one to ``one_pole_scan.launches``;
    where autograd records, the launch is a :class:`_OnePoleFn` whose
    backward launches K8."""
    if x.device.type == "cpu":
        return one_pole_scan_reference(x, y_prev, a, b)
    x = _check(x, "one_pole_scan")
    a, b = _per_row(a, x), _per_row(b, x)
    if _wants_grad(x, y_prev, a, b):
        return _OnePoleFn.apply(x, y_prev, a, b)
    return _one_pole_launch(x, y_prev, a, b)


# ---------------------------------------------------------------------------
# K8: the backwards on the card (csrc/assoc_scan_bwd.cu)
# ---------------------------------------------------------------------------

class _BiquadBwdArgs(ctypes.Structure):
    """``csrc/assoc_scan_bwd.cu:k8::BiquadBwdArgs``."""

    _fields_ = [("coef", (_Operand * 5) * MAX_SECTIONS),
                ("z_in", (_Operand * 2) * MAX_SECTIONS),
                ("g_z_out", (_Operand * 2) * MAX_SECTIONS),
                ("x", ctypes.c_void_p), ("y", ctypes.c_void_p), ("g_y", ctypes.c_void_p),
                ("g_x", ctypes.c_void_p), ("g_coef", ctypes.c_void_p),
                ("g_z_in", ctypes.c_void_p), ("ckpt", ctypes.c_void_p),
                ("inner", ctypes.c_int64), ("rows", ctypes.c_int64),
                ("frames", ctypes.c_int), ("sections", ctypes.c_int)]


class _OnePoleBwdArgs(ctypes.Structure):
    """``csrc/assoc_scan_bwd.cu:k8::OnePoleBwdArgs``."""

    _fields_ = [("a", _Operand), ("b", _Operand), ("y_in", _Operand),
                ("g_y_out", _Operand),
                ("x", ctypes.c_void_p), ("y", ctypes.c_void_p), ("g_y", ctypes.c_void_p),
                ("g_x", ctypes.c_void_p), ("g_coef", ctypes.c_void_p),
                ("g_y_in", ctypes.c_void_p),
                ("inner", ctypes.c_int64), ("rows", ctypes.c_int64), ("frames", ctypes.c_int)]


def _bind_bwd(lib):
    lib.fw_biquad_cascade_bwd.argtypes = [ctypes.POINTER(_BiquadBwdArgs), ctypes.c_void_p]
    lib.fw_one_pole_scan_bwd.argtypes = [ctypes.POINTER(_OnePoleBwdArgs), ctypes.c_void_p]
    lib.fw_biquad_cascade_bwd.restype = lib.fw_one_pole_scan_bwd.restype = ctypes.c_int


#: ``csrc/assoc_scan_bwd.cu`` (K8), built with nvcc at first use
BWD_LIBRARY = CudaLibrary("fw_assoc_scan_bwd", "assoc_scan_bwd.cu", ("reverse_stage.cuh",),
                          _bind_bwd)


def _bwd_launch(entry: str, wrapper, args, x) -> None:
    lib = BWD_LIBRARY.load()
    with _on_device(x.device) as stream:
        err = getattr(lib, entry)(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"{wrapper.__name__}: kernel launch failed on rows of "
                           f"{x.shape[-1]} frames (cudaError {err})")
    wrapper.launches += 1


def biquad_cascade_backward(x, y, states, sections, g_y, g_states):
    """The vector-Jacobian product of :func:`biquad_cascade` at ``(x,
    states, sections)`` whose output was ``y``, for the gradients ``g_y``
    and ``g_states`` (each section's ``(g_z1, g_z2)`` out), as
    :func:`biquad_cascade_backward_reference` computes it (its contract,
    to rounding).  Returns ``(g_x, ((g_z1_in, g_z2_in), ...),
    (BiquadCoeffs, ...))``, the coefficient gradients one a row.

    CPU tensors run the plain version.  On a CUDA tensor K8 runs up to
    :data:`MAX_SECTIONS` sections in one launch (more raise) and adds one
    to ``biquad_cascade_backward.launches``: the earlier sections' inputs
    are recomputed on chip, a stage of 32 frames at a time, from their
    states at each stage's start, which a first sweep over ``x`` writes to
    a ``[S − 1, 2, stages, rows]`` array allocated here."""
    states, sections = tuple(states), tuple(sections)
    if not sections or not len(states) == len(sections) == len(g_states):
        raise ValueError(f"biquad_cascade_backward: {len(sections)} sections, "
                         f"{len(states)} states, {len(g_states)} state gradients")
    if x.device.type == "cpu":
        return biquad_cascade_backward_reference(x, y, states, sections, g_y, g_states)
    if len(sections) > MAX_SECTIONS:
        raise ValueError(f"biquad_cascade_backward: {len(sections)} sections, K8 takes "
                         f"at most {MAX_SECTIONS} a launch")
    x, y, g_y = (_check(t, "biquad_cascade_backward") for t in (x, y, g_y))
    if not x.shape == y.shape == g_y.shape:
        raise ValueError(f"biquad_cascade_backward: x {tuple(x.shape)}, y "
                         f"{tuple(y.shape)}, g_y {tuple(g_y.shape)}")
    lead, frames = x.shape[:-1], x.shape[-1]
    rows, n = math.prod(lead), len(sections)
    g_x = torch.empty_like(x)
    g_coef = torch.empty((n, 5) + lead, dtype=torch.float32, device=x.device)
    g_zin = torch.empty((n, 2) + lead, dtype=torch.float32, device=x.device)
    if rows:
        ckpt = (torch.empty((n - 1, 2, -(-frames // 32), rows), dtype=torch.float32,
                            device=x.device) if n > 1 else None)
        args = _BiquadBwdArgs(
            x=x.data_ptr(), y=y.data_ptr(), g_y=g_y.data_ptr(), g_x=g_x.data_ptr(),
            g_coef=g_coef.data_ptr(), g_z_in=g_zin.data_ptr(),
            ckpt=ckpt.data_ptr() if ckpt is not None else None,
            inner=lead[-1] if lead else 1, rows=rows, frames=frames, sections=n)
        keep = []
        for s, (c, z, gz) in enumerate(zip(sections, states, g_states)):
            for k, v in enumerate(c):
                args.coef[s][k] = _c_operand(_operand(v, lead, x.device), keep)
            for k in range(2):
                args.z_in[s][k] = _c_operand(_operand(z[k], lead, x.device), keep)
                args.g_z_out[s][k] = _c_operand(_operand(gz[k], lead, x.device), keep)
        _bwd_launch("fw_biquad_cascade_bwd", biquad_cascade_backward, args, x)
    return (g_x, tuple((g[0], g[1]) for g in g_zin),
            tuple(BiquadCoeffs(*g) for g in g_coef))


def one_pole_scan_backward(x, y, y_prev, a, b, g_y, g_y_last):
    """The vector-Jacobian product of :func:`one_pole_scan` at ``(x,
    y_prev, a, b)`` whose output was ``y``, for ``g_y`` and ``g_y_last``,
    as :func:`one_pole_scan_backward_reference` computes it (its contract,
    to rounding).  Returns ``(g_x, g_y_prev, (g_a, g_b))``, the
    coefficient gradients one a row.

    CPU tensors run the plain version.  On a CUDA tensor K8 runs it in one
    launch and adds one to ``one_pole_scan_backward.launches``."""
    if x.device.type == "cpu":
        return one_pole_scan_backward_reference(x, y, y_prev, a, b, g_y, g_y_last)
    x, y, g_y = (_check(t, "one_pole_scan_backward") for t in (x, y, g_y))
    if not x.shape == y.shape == g_y.shape:
        raise ValueError(f"one_pole_scan_backward: x {tuple(x.shape)}, y "
                         f"{tuple(y.shape)}, g_y {tuple(g_y.shape)}")
    lead = x.shape[:-1]
    rows = math.prod(lead)
    g_x = torch.empty_like(x)
    g_coef = torch.empty((2,) + lead, dtype=torch.float32, device=x.device)
    g_prev = torch.empty(lead, dtype=torch.float32, device=x.device)
    if rows:
        keep = []
        args = _OnePoleBwdArgs(
            *(_c_operand(_operand(v, lead, x.device), keep)
              for v in (_per_row(a, x), _per_row(b, x), y_prev, g_y_last)),
            x=x.data_ptr(), y=y.data_ptr(), g_y=g_y.data_ptr(), g_x=g_x.data_ptr(),
            g_coef=g_coef.data_ptr(), g_y_in=g_prev.data_ptr(),
            inner=lead[-1] if lead else 1, rows=rows, frames=x.shape[-1])
        _bwd_launch("fw_one_pole_scan_bwd", one_pole_scan_backward, args, x)
    return g_x, g_prev, (g_coef[0], g_coef[1])


#: kernel launches since the counter was last set to 0
biquad_cascade.launches = 0
one_pole_scan.launches = 0
biquad_cascade_backward.launches = 0
one_pole_scan_backward.launches = 0
