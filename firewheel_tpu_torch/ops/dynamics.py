"""Dynamics primitives: per-sample recurrences, envelope following, gain
computing, sliding maxima.

PyTorch port of ``firewheel_tpu/ops/dynamics.py``.

* :func:`sample_scan` — a per-sample recurrence along the last axis as a
  plain loop (the JAX package's ``lax.scan``; its Mosaic branch has no
  counterpart here).
* :func:`scan_lanes` — the recurrences that the nodes run, by kind
  (:data:`ENVELOPE`, :data:`LIMITER`, :data:`GATE`, :data:`PINK`), one lane
  per row of ``x``.  CPU tensors run :func:`scan_reference` (the kind's
  step through :func:`sample_scan`); CUDA tensors launch
  ``csrc/sample_scan.cu`` (K5: a warp's 32 lanes a CTA, their frames
  staged through shared memory) or raise, with the operands where they
  lie (:func:`stage`, K7's ``iir._operand``).  Each step
  writes out the fused multiply-adds that XLA makes of the JAX package's
  scan body on the CPU (``ops/iir.py:_fma``), and the kernel the same
  ``fmaf``, so the two agree to the bit and both match the JAX package.
* :func:`scan_lanes_backward` — its vector-Jacobian product, a wrapper of
  the same kind: CPU tensors run :func:`scan_lanes_backward_reference`
  (each kind's adjoint, backwards in time); CUDA tensors launch
  ``csrc/sample_scan_bwd.cu`` (K9) or raise.  On the card, where autograd
  records, :func:`scan_lanes` launches K5 inside a
  ``torch.autograd.Function`` whose backward launches K9.
* :func:`envelope_follow`, :func:`compressor_gain_db`, :func:`sliding_max`
  — the JAX package's functions; the sliding maximum is a ``max_pool1d``
  (a ``reduce_window`` there, outside any kernel).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .cuda_build import CudaLibrary
from .iir import (
    _c_operand, _check as _check_cuda, _input_grads, _Operand, _operand, _restored, _rows,
    _on_device, _saved, _wants_grad,
)

__all__ = [
    "ENVELOPE", "LIMITER", "GATE", "PINK",
    "sample_scan",
    "scan_reference",
    "scan_lanes",
    "scan_lanes_backward",
    "scan_lanes_backward_reference",
    "envelope_follow",
    "compressor_gain_db",
    "sliding_max",
    "LIBRARY",
    "BWD_LIBRARY",
]

#: step kinds of :func:`scan_lanes` (the kernel's ``kind``)
ENVELOPE, LIMITER, GATE, PINK = 0, 1, 2, 3


def _bind(lib):
    fn = lib.fw_sample_scan
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(_Args), ctypes.c_void_p]
    fn.restype = ctypes.c_int


#: ``csrc/sample_scan.cu``, built with nvcc at first use
LIBRARY = CudaLibrary("fw_sample_scan", "sample_scan.cu", (), _bind)


def sample_scan(step, carry, xs):
    """Per-sample recurrence along the last axis with per-step emissions.

    ``step(carry, x) -> (carry', y)`` consumes one sample ``x = xs[..., i]``
    and emits ``y`` shaped like ``xs[..., 0]``.  Returns ``(carry_last,
    ys)`` with ``ys.shape == xs.shape``."""
    ys = []
    for x in xs.unbind(-1):
        carry, y = step(carry, x)
        ys.append(y)
    if not ys:
        return carry, torch.empty_like(xs)
    return carry, torch.stack(ys, dim=-1)


# -- the steps, by kind: (coefs, carry, x) -> (carry', y) -----------------------

def _f32(v: float) -> float:
    return float(np.float32(v))


def _fma(a, b, c):
    """float32 ``a·b + c`` rounded once, as ``ops/iir.py:_fma`` computes it
    (the float64 product of two float32 values is exact), with a float32
    constant allowed for ``a`` or ``b``."""
    if not isinstance(a, torch.Tensor):
        a, b = b, a
    if not isinstance(b, torch.Tensor):
        return torch.add(c.double(), a.double(), alpha=b).float()
    return torch.addcmul(c.double(), a.double(), b.double()).float()


def _envelope_step(coefs, carry, x):
    att, rel = coefs
    (env,) = carry
    b = torch.where(x > env, att, rel)
    env = _fma(b, env, (1.0 - b) * x)
    return (env,), env


def _limiter_step(coefs, carry, g):
    (rel,) = coefs
    (env,) = carry
    env = torch.minimum(g, _fma(rel, env, (1.0 - rel) * g))
    return (env,), env


def _gate_step(coefs, carry, lvl):
    open_lin, close_lin, floor, att, rel, hold_n = coefs
    opn, hold, g = carry
    above = lvl >= open_lin
    below = lvl < close_lin
    expired = hold <= 0.0
    opn = torch.where(above, 1.0, torch.where(below & expired, 0.0, opn))
    # jnp.maximum's tie rule under autograd: half the gradient each way
    hold = torch.where(above, hold_n, torch.maximum(hold - 1.0, torch.zeros_like(hold)))
    target = opn + (1.0 - opn) * floor
    b = torch.where(target > g, att, rel)
    g = _fma(b, g, (1.0 - b) * target)
    return (opn, hold, g), g


_A = tuple(_f32(v) for v in (0.99765, 0.96300, 0.57000))
_C = tuple(_f32(v) for v in (0.0990460, 0.2965164, 1.0526913))


def _pink_step(coefs, carry, w):
    # the carry is fma(a, z, w·c) a pole; the output's sum takes poles 1
    # and 2 as fma(w, c, a·z): XLA contracts the two uses apart on the CPU
    z0, z1, z2 = carry
    b0 = _fma(_A[0], z0, w * _C[0])
    o1 = _fma(w, _C[1], _A[1] * z1)
    o2 = _fma(w, _C[2], _A[2] * z2)
    y = _fma(w, _f32(0.1848), (b0 + o1) + o2) * 0.25
    b1 = _fma(_A[1], z1, w * _C[1])
    b2 = _fma(_A[2], z2, w * _C[2])
    return (b0, b1, b2), y


#: kind -> (step, carry leaves, coefficients)
_KINDS = {
    ENVELOPE: (_envelope_step, 1, 2),
    LIMITER: (_limiter_step, 1, 1),
    GATE: (_gate_step, 3, 6),
    PINK: (_pink_step, 3, 0),
}


def _check(kind, x, carry, coefs):
    """Validate the call → ``(carry leaves, stacked)``: ``carry`` is a tuple
    of leaves, or one tensor ``[..., n_carry]`` whose last axis holds them
    (``stacked``)."""
    if kind not in _KINDS:
        raise ValueError(f"scan_lanes: unknown kind {kind!r}")
    _, n_carry, n_coef = _KINDS[kind]
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
        raise TypeError("scan_lanes: x must be a float32 tensor")
    stacked = isinstance(carry, torch.Tensor)
    if stacked and (carry.ndim == 0 or carry.shape[-1] != n_carry):
        raise ValueError(f"scan_lanes: kind {kind} takes {n_carry} carry leaves, got "
                         f"a tensor of shape {tuple(carry.shape)}")
    leaves = tuple(carry[..., k] for k in range(n_carry)) if stacked else tuple(carry)
    if len(leaves) != n_carry or len(coefs) != n_coef:
        raise ValueError(f"scan_lanes: kind {kind} takes {n_carry} carry leaves "
                         f"and {n_coef} coefficients, got {len(leaves)}, {len(coefs)}")
    for t in leaves + tuple(coefs):
        if isinstance(t, torch.Tensor) and (t.dtype != torch.float32
                                            or t.device != x.device):
            raise ValueError(f"scan_lanes: the carry and the coefficients must be "
                             f"float32 on {x.device}")
    return leaves, stacked


def scan_reference(kind, x, carry, coefs):
    """Plain version of :func:`scan_lanes`: the kind's step through
    :func:`sample_scan`, on the tensors' device."""
    leaves, stacked = _check(kind, x, carry, coefs)
    lead = x.shape[:-1]

    def lanes(t):
        if not isinstance(t, torch.Tensor):
            t = torch.tensor(_f32(t), dtype=torch.float32, device=x.device)
        return t.broadcast_to(lead)

    coefs = tuple(map(lanes, coefs))
    step = _KINDS[kind][0]
    out, y = sample_scan(lambda c, xv: step(coefs, c, xv), tuple(map(lanes, leaves)), x)
    return (torch.stack(out, dim=-1) if stacked else out), y


class _Args(ctypes.Structure):
    """``csrc/sample_scan.cu:k5::Args``."""

    _fields_ = [("x", ctypes.c_void_p), ("y", ctypes.c_void_p),
                ("carry", _Operand * 3), ("coef", _Operand * 6),
                ("carry_out", ctypes.c_void_p), ("out_leaf", ctypes.c_int64),
                ("out_lane", ctypes.c_int64), ("inner", ctypes.c_int64),
                ("lanes", ctypes.c_int64), ("frames", ctypes.c_int)]


class Staged(NamedTuple):
    """What :func:`scan_lanes` hands the kernel: ``x`` and ``y`` as
    ``[lanes, F]``; each carry leaf and coefficient as ``iir._operand``
    stages it, ``(tensor or None, outer stride, inner stride, value)``
    over the lanes ``[lanes // inner, inner]``; and ``carry_out``, where
    the kernel writes leaf ``k`` of lane ``l`` at element ``k·out_leaf +
    l·out_lane``."""

    x: torch.Tensor
    y: torch.Tensor
    carry: tuple
    coefs: tuple
    carry_out: torch.Tensor
    out_leaf: int
    out_lane: int
    inner: int


def stage(x, leaves, coefs, stacked: bool) -> Staged:
    """The kernel's operands (:class:`Staged`) for checked ``leaves`` and
    ``coefs``: numbers by value, tensors in place where their leading axes
    fold into one stride; no stack, no copy from the host.  The carry goes
    out as one tensor ``[..., n_carry]`` when ``stacked``, else as
    ``[n_carry, ...]`` whose rows are the leaves."""
    lead = x.shape[:-1]
    x = x.contiguous()
    n = len(leaves)
    if stacked:
        carry_out = torch.empty(lead + (n,), dtype=torch.float32, device=x.device)
        out_leaf, out_lane = 1, n
    else:
        carry_out = torch.empty((n,) + lead, dtype=torch.float32, device=x.device)
        out_leaf, out_lane = lead.numel(), 1
    staged = lambda vs: tuple(_operand(v, lead, x.device) for v in vs)  # noqa: E731
    return Staged(x, torch.empty_like(x), staged(leaves), staged(coefs), carry_out,
                  out_leaf, out_lane, lead[-1] if lead else 1)


def _scan_launch(kind, x, leaves, coefs, stacked: bool):
    """One launch of K5 → ``(y, carry_out)``: the carry out stacked
    ``[..., n_carry]`` when ``stacked``, else ``[n_carry, ...]``."""
    s = stage(x, leaves, coefs, stacked)
    lanes = s.x.shape[:-1].numel()
    if lanes:
        keep = []
        args = _Args(x=s.x.data_ptr(), y=s.y.data_ptr(), carry_out=s.carry_out.data_ptr(),
                     out_leaf=s.out_leaf, out_lane=s.out_lane, inner=s.inner,
                     lanes=lanes, frames=s.x.shape[-1])
        for k, op in enumerate(s.carry):
            args.carry[k] = _c_operand(op, keep)
        for k, op in enumerate(s.coefs):
            args.coef[k] = _c_operand(op, keep)
        lib = LIBRARY.load()
        with _on_device(x.device) as stream:
            err = lib.fw_sample_scan(kind, ctypes.byref(args), stream)
        if err != 0:
            raise RuntimeError(f"scan_lanes: kernel launch failed (cudaError {err})")
        scan_lanes.launches += 1
    return s.y, s.carry_out


class _ScanFn(torch.autograd.Function):
    """A recurrence on the card: K5 forward (:func:`_scan_launch`, its
    counts and bits unchanged), K9 backward (:func:`scan_lanes_backward`).
    Inputs ``(kind, stacked, x, *leaves, *coefs)``, tensors or numbers;
    outputs ``(y, carry_out)``, the carry out as :func:`_scan_launch`
    gives it."""

    @staticmethod
    def forward(ctx, kind, stacked, x, *operands):
        n_carry = _KINDS[kind][1]
        leaves, coefs = operands[:n_carry], operands[n_carry:]
        y, carry_out = _scan_launch(kind, x, leaves, coefs, stacked)
        ctx.kind, ctx.stacked = kind, stacked
        ctx.save_for_backward(x, y, *_saved(ctx, operands))
        return y, carry_out

    @staticmethod
    def backward(ctx, g_y, g_carry):
        x, y, *tensors = ctx.saved_tensors
        operands = _restored(ctx, tensors)
        n_carry = _KINDS[ctx.kind][1]
        leaves, coefs = operands[:n_carry], operands[n_carry:]
        g_out = g_carry.unbind(-1 if ctx.stacked else 0)
        g_x, g_leaves, g_coefs = scan_lanes_backward(ctx.kind, x, tuple(leaves), coefs,
                                                     y, g_y, g_out)
        return (None, None, g_x if ctx.needs_input_grad[2] else None,
                *_input_grads(ctx, 3, operands, (*g_leaves, *g_coefs)))


def scan_lanes(kind, x, carry, coefs):
    """Run the recurrence ``kind`` along the last axis of ``x f32[..., F]``,
    one lane per row.  ``carry`` is a tuple of float32 tensors (or numbers)
    that broadcast to ``x.shape[:-1]``, or one tensor ``[..., n_carry]``
    that holds them along its last axis; ``coefs`` a tuple of such leaves:

    * :data:`ENVELOPE`: carry ``(env,)``, coefs ``(attack_b, release_b)``;
    * :data:`LIMITER`: carry ``(env,)``, coefs ``(release_b,)``;
    * :data:`GATE`: carry ``(open, hold, gain)``, coefs ``(open_lin,
      close_lin, floor, attack_b, release_b, hold_n)``;
    * :data:`PINK`: carry the three poles, no coefs.

    Returns ``(carry', y f32[..., F])``, the carry in the form it came in:
    a tuple of leaves shaped ``x.shape[:-1]``, or one tensor
    ``x.shape[:-1] + (n_carry,)``.  CPU tensors run :func:`scan_reference`
    (autograd differentiates its steps); CUDA tensors launch K5 on the
    operands where they lie (:func:`stage`) and add one to
    ``scan_lanes.launches``, inside a :class:`_ScanFn` whose backward
    launches K9 where autograd records."""
    leaves, stacked = _check(kind, x, carry, coefs)
    if x.device.type == "cpu":
        return scan_reference(kind, x, carry, coefs)
    if x.device.type != "cuda":
        raise ValueError(f"scan_lanes: unsupported device {x.device}")
    if _wants_grad(x, *leaves, *coefs):
        y, carry_out = _ScanFn.apply(kind, stacked, x, *leaves, *coefs)
    else:
        y, carry_out = _scan_launch(kind, x, leaves, coefs, stacked)
    return (carry_out if stacked else carry_out.unbind(0)), y


# -- the backwards: reverse-time recurrences, frame by frame --------------------

def _envelope_backward(x, y, carry, coefs, g_y, g_out, g_x):
    att, rel = coefs
    (env0,) = carry
    lam = g_out[0]
    g_att = torch.zeros_like(lam)
    g_rel = torch.zeros_like(lam)
    for i in range(x.shape[-1] - 1, -1, -1):
        lam = lam + g_y[..., i]
        prev = y[..., i - 1] if i else env0
        xi = x[..., i]
        up = xi > prev
        b = torch.where(up, att, rel)
        g_x[..., i] = lam * (1.0 - b)
        g_b = lam * (prev - xi)
        g_att = g_att + torch.where(up, g_b, 0.0)
        g_rel = g_rel + torch.where(up, 0.0, g_b)
        lam = lam * b
    return (lam,), (g_att, g_rel)


def _limiter_backward(x, y, carry, coefs, g_y, g_out, g_x):
    (rel,) = coefs
    (env0,) = carry
    omb = 1.0 - rel
    lam = g_out[0]
    g_rel = torch.zeros_like(lam)
    for i in range(x.shape[-1] - 1, -1, -1):
        lam = lam + g_y[..., i]
        prev = y[..., i - 1] if i else env0
        g = x[..., i]
        u = _fma(rel, prev, omb * g)  # the step's release, as it was computed
        # torch.minimum (and jnp.minimum): the lesser side takes the
        # gradient, a tie half each way
        to_u = torch.where(u < g, lam, torch.where(u == g, 0.5 * lam, 0.0))
        g_x[..., i] = (lam - to_u) + to_u * omb
        g_rel = g_rel + to_u * (prev - g)
        lam = to_u * rel
    return (lam,), (g_rel,)


def _gate_backward(x, y, carry, coefs, g_y, g_out, g_x):
    open_lin, close_lin, floor, att, rel, hold_n = coefs
    opn, hold, g0 = carry
    n = x.shape[-1]
    g_x.zero_()  # the level enters comparisons only
    # the latch recomputed forward from the level and the carry: each
    # frame's open value and the hold it started from (comparisons only)
    opens, holds = [], []
    for i in range(n):
        lvl = x[..., i]
        above = lvl >= open_lin
        holds.append(hold)
        opn = torch.where(above, 1.0, torch.where((lvl < close_lin) & (hold <= 0.0), 0.0, opn))
        hold = torch.where(above, hold_n, torch.maximum(hold - 1.0, torch.zeros_like(hold)))
        opens.append(opn)
    lam_o, lam_h, lam_g = g_out
    g_floor = torch.zeros_like(lam_g)
    g_att, g_rel, g_hold_n = (torch.zeros_like(lam_g) for _ in range(3))
    for i in range(n - 1, -1, -1):
        lam_g = lam_g + g_y[..., i]
        lvl, o, h = x[..., i], opens[i], holds[i]
        above = lvl >= open_lin
        keep = ~above & ~((lvl < close_lin) & (h <= 0.0))
        prev = y[..., i - 1] if i else g0
        target = o + (1.0 - o) * floor
        up = target > prev
        b = torch.where(up, att, rel)
        g_b = lam_g * (prev - target)
        g_att = g_att + torch.where(up, g_b, 0.0)
        g_rel = g_rel + torch.where(up, 0.0, g_b)
        lam_t = lam_g * (1.0 - b)
        g_floor = g_floor + lam_t * (1.0 - o)
        lam_o = torch.where(keep, lam_o + lam_t * (1.0 - floor), 0.0)
        g_hold_n = g_hold_n + torch.where(above, lam_h, 0.0)
        d = h - 1.0
        lam_h = torch.where(above | (d < 0.0), 0.0, torch.where(d == 0.0, 0.5 * lam_h, lam_h))
        lam_g = lam_g * b
    zero = torch.zeros_like(lam_g)
    return (lam_o, lam_h, lam_g), (zero, zero, g_floor, g_att, g_rel, g_hold_n)


def _pink_backward(x, y, carry, coefs, g_y, g_out, g_x):
    lam = list(g_out)
    c_sum = _f32(_f32(_f32(_C[0] + _C[1]) + _C[2]) + _f32(0.1848))
    for i in range(x.shape[-1] - 1, -1, -1):
        q = g_y[..., i] * 0.25
        nu = [lam[k] + q for k in range(3)]
        g_x[..., i] = ((_C[0] * lam[0] + _C[1] * lam[1]) + _C[2] * lam[2]) + c_sum * q
        lam = [_A[k] * nu[k] for k in range(3)]
    return tuple(lam), ()


_BACKWARDS = {ENVELOPE: _envelope_backward, LIMITER: _limiter_backward,
              GATE: _gate_backward, PINK: _pink_backward}


def scan_lanes_backward_reference(kind, x, carry, coefs, y, g_y, g_carry_out):
    """Plain version of :func:`scan_lanes_backward`: the vector-Jacobian
    product of :func:`scan_lanes` at ``(x, carry, coefs)``, whose output
    was ``y``, for ``g_y f32[..., F]`` and the carry-out gradients
    ``g_carry_out`` (a tuple of leaves, or one tensor ``[..., n_carry]``).

    Each kind's adjoint runs backwards in time, frame by frame in float32,
    and is the gradient autograd takes through the plain steps: the
    envelope's and the gate's attack/release choice carries no gradient;
    the limiter's ``minimum`` and the gate's hold ``maximum`` split a tie
    half and half, as ``jnp.minimum``/``jnp.maximum`` do; the gate's latch
    and hold are recomputed forward from the level and the carry, and its
    thresholds get no gradient; the pink filter is linear.  Returns
    ``(g_x, g_carry, g_coefs)``: the carry's gradient in the form ``carry``
    came in, each coefficient's one a lane (shaped ``x.shape[:-1]``)."""
    leaves, stacked = _check(kind, x, carry, coefs)
    lead = x.shape[:-1]
    lanes = lambda vs: tuple(_rows(v, lead, x.device) for v in vs)  # noqa: E731
    if isinstance(g_carry_out, torch.Tensor):
        g_carry_out = g_carry_out.unbind(-1)
    g_x = torch.empty_like(x)
    g_carry, g_coefs = _BACKWARDS[kind](x, y, lanes(leaves), lanes(coefs), g_y,
                                        lanes(g_carry_out), g_x)
    return g_x, (torch.stack(g_carry, dim=-1) if stacked else g_carry), g_coefs


class _BwdArgs(ctypes.Structure):
    """``csrc/sample_scan_bwd.cu:k9::Args``."""

    _fields_ = [("x", ctypes.c_void_p), ("y", ctypes.c_void_p), ("g_y", ctypes.c_void_p),
                ("g_x", ctypes.c_void_p),
                ("carry", _Operand * 3), ("coef", _Operand * 6), ("g_carry_out", _Operand * 3),
                ("g_carry", ctypes.c_void_p), ("g_coef", ctypes.c_void_p),
                ("ckpt", ctypes.c_void_p),
                ("inner", ctypes.c_int64), ("lanes", ctypes.c_int64), ("frames", ctypes.c_int)]


def _bind_bwd(lib):
    fn = lib.fw_sample_scan_bwd
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(_BwdArgs), ctypes.c_void_p]
    fn.restype = ctypes.c_int


#: ``csrc/sample_scan_bwd.cu`` (K9), built with nvcc at first use
BWD_LIBRARY = CudaLibrary("fw_sample_scan_bwd", "sample_scan_bwd.cu", ("reverse_stage.cuh",),
                          _bind_bwd)


def scan_lanes_backward(kind, x, carry, coefs, y, g_y, g_carry_out):
    """The vector-Jacobian product of :func:`scan_lanes`, as
    :func:`scan_lanes_backward_reference` computes it (its contract, to
    rounding) → ``(g_x, g_carry, g_coefs)``, the carry's gradient in the
    form ``carry`` came in, the coefficients' one a lane.

    CPU tensors run the plain version.  On a CUDA tensor K9 runs it in one
    launch and adds one to ``scan_lanes_backward.launches``; the gate's
    latch is recomputed on chip, a stage of 32 frames at a time, from its
    ``(open, hold)`` at each stage's start, which a first sweep over ``x``
    writes to a ``[2, stages, lanes]`` array allocated here."""
    leaves, stacked = _check(kind, x, carry, coefs)
    if x.device.type == "cpu":
        return scan_lanes_backward_reference(kind, x, carry, coefs, y, g_y, g_carry_out)
    if x.device.type != "cuda":
        raise ValueError(f"scan_lanes_backward: unsupported device {x.device}")
    if not x.shape == y.shape == g_y.shape:
        raise ValueError(f"scan_lanes_backward: x {tuple(x.shape)}, y {tuple(y.shape)}, "
                         f"g_y {tuple(g_y.shape)}")
    if isinstance(g_carry_out, torch.Tensor):
        g_carry_out = g_carry_out.unbind(-1)
    n_carry, n_coef = _KINDS[kind][1:]
    if len(g_carry_out) != n_carry:
        raise ValueError(f"scan_lanes_backward: kind {kind} takes {n_carry} carry "
                         f"gradients, got {len(g_carry_out)}")
    lead, frames = x.shape[:-1], x.shape[-1]
    x, y, g_y = (_check_cuda(t, "scan_lanes_backward") for t in (x, y, g_y))
    g_x = torch.empty_like(x)
    g_carry = torch.empty((n_carry,) + lead, dtype=torch.float32, device=x.device)
    g_coef = torch.empty((n_coef,) + lead, dtype=torch.float32, device=x.device)
    lanes = lead.numel()
    if lanes:
        ckpt = (torch.empty((2, -(-frames // 32), lanes), dtype=torch.float32,
                            device=x.device) if kind == GATE and frames else None)
        args = _BwdArgs(x=x.data_ptr(), y=y.data_ptr(), g_y=g_y.data_ptr(),
                        g_x=g_x.data_ptr(), g_carry=g_carry.data_ptr(),
                        g_coef=g_coef.data_ptr(),
                        ckpt=ckpt.data_ptr() if ckpt is not None else None,
                        inner=lead[-1] if lead else 1, lanes=lanes, frames=frames)
        keep = []
        for k, v in enumerate(leaves):
            args.carry[k] = _c_operand(_operand(v, lead, x.device), keep)
        for k, v in enumerate(coefs):
            args.coef[k] = _c_operand(_operand(v, lead, x.device), keep)
        for k, v in enumerate(g_carry_out):
            args.g_carry_out[k] = _c_operand(_operand(v, lead, x.device), keep)
        lib = BWD_LIBRARY.load()
        with _on_device(x.device) as stream:
            err = lib.fw_sample_scan_bwd(kind, ctypes.byref(args), stream)
        if err != 0:
            raise RuntimeError(f"scan_lanes_backward: kernel launch failed (cudaError {err})")
        scan_lanes_backward.launches += 1
    g_leaves = g_carry.unbind(0)
    return (g_x, torch.stack(g_leaves, dim=-1) if stacked else g_leaves,
            g_coef.unbind(0))


#: kernel launches since the counter was last set to 0
scan_lanes.launches = 0
scan_lanes_backward.launches = 0


def envelope_follow(level, env0, attack_b, release_b):
    """Attack/release envelope follower along the last axis:
    ``env[n] = b·env[n-1] + (1-b)·level[n]`` with ``b = attack_b`` while the
    signal is above the envelope and ``release_b`` while below.  ``level
    f32[..., n]``; ``env0`` and the coefficients broadcast to
    ``level.shape[:-1]``.  Returns ``(env f32[..., n], env_last)``."""
    (env_last,), env = scan_lanes(ENVELOPE, level, (env0,), (attack_b, release_b))
    return env, env_last


def compressor_gain_db(level_db, threshold_db, ratio, knee_db):
    """Soft-knee downward-compression gain (dB in → dB gain out), with the
    params broadcasting against ``level_db``.  Below ``threshold − knee/2``
    unity; above ``threshold + knee/2`` ``(1/ratio − 1)·(level −
    threshold)``; inside the knee the standard quadratic."""
    over = level_db - threshold_db
    slope = 1.0 / ratio - 1.0
    half_knee = knee_db * 0.5
    in_knee = torch.minimum(torch.clamp_min(over + half_knee, 0.0), knee_db)
    knee_gain = slope * in_knee * in_knee / (2.0 * torch.clamp_min(knee_db, 1e-9))
    hard = slope * over
    zero = torch.zeros((), dtype=level_db.dtype, device=level_db.device)
    return torch.where(over <= -half_knee, zero,
                       torch.where(over >= half_knee, hard, knee_gain))


def sliding_max(x, window: int):
    """Causal-future sliding maximum: ``out[t] = max(x[t : t+window])``.
    ``x f32[..., n]`` already carries ``window − 1`` frames of lookahead
    tail; the output has ``n − window + 1`` frames."""
    if window <= 1:
        return x
    lead, n = x.shape[:-1], x.shape[-1]
    out = F.max_pool1d(x.reshape(-1, 1, n), window, stride=1)
    return out.reshape(*lead, n - window + 1)
