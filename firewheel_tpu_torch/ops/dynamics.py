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
  ``csrc/sample_scan.cu`` (K5, one thread a lane) or raise.  Each step
  writes out the fused multiply-adds that XLA makes of the JAX package's
  scan body on the CPU (``ops/iir.py:_fma``), and the kernel the same
  ``fmaf``, so the two agree to the bit and both match the JAX package.
* :func:`envelope_follow`, :func:`compressor_gain_db`, :func:`sliding_max`
  — the JAX package's functions; the sliding maximum is a ``max_pool1d``
  (a ``reduce_window`` there, outside any kernel).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from .cuda_build import CudaLibrary

__all__ = [
    "ENVELOPE", "LIMITER", "GATE", "PINK",
    "sample_scan",
    "scan_reference",
    "scan_lanes",
    "envelope_follow",
    "compressor_gain_db",
    "sliding_max",
    "LIBRARY",
]

#: step kinds of :func:`scan_lanes` (the kernel's ``kind``)
ENVELOPE, LIMITER, GATE, PINK = 0, 1, 2, 3


def _bind(lib):
    fn = lib.fw_sample_scan
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [
        ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
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
    hold = torch.where(above, hold_n, torch.clamp_min(hold - 1.0, 0.0))
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


def _operands(kind, x, carry, coefs):
    """Validate and broadcast: the carry and the coefficients, each to the
    lanes ``x.shape[:-1]``."""
    if kind not in _KINDS:
        raise ValueError(f"scan_lanes: unknown kind {kind!r}")
    _, n_carry, n_coef = _KINDS[kind]
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32:
        raise TypeError("scan_lanes: x must be a float32 tensor")
    if len(carry) != n_carry or len(coefs) != n_coef:
        raise ValueError(f"scan_lanes: kind {kind} takes {n_carry} carry leaves "
                         f"and {n_coef} coefficients, got {len(carry)}, {len(coefs)}")
    lead = x.shape[:-1]

    def lanes(t, what):
        if not isinstance(t, torch.Tensor):
            t = torch.tensor(_f32(t), dtype=torch.float32, device=x.device)
        if t.dtype != torch.float32 or t.device != x.device:
            raise ValueError(f"scan_lanes: {what} must be float32 on {x.device}")
        return t.broadcast_to(lead)

    return (tuple(lanes(c, "carry") for c in carry),
            tuple(lanes(c, "coefficients") for c in coefs))


def scan_reference(kind, x, carry, coefs):
    """Plain version of :func:`scan_lanes`: the kind's step through
    :func:`sample_scan`, on the tensors' device."""
    carry, coefs = _operands(kind, x, carry, coefs)
    step = _KINDS[kind][0]
    return sample_scan(lambda c, xv: step(coefs, c, xv), carry, x)


def scan_lanes(kind, x, carry, coefs):
    """Run the recurrence ``kind`` along the last axis of ``x f32[..., F]``,
    one lane per row.  ``carry`` and ``coefs`` are tuples of float32
    tensors (or floats) that broadcast to ``x.shape[:-1]``:

    * :data:`ENVELOPE`: carry ``(env,)``, coefs ``(attack_b, release_b)``;
    * :data:`LIMITER`: carry ``(env,)``, coefs ``(release_b,)``;
    * :data:`GATE`: carry ``(open, hold, gain)``, coefs ``(open_lin,
      close_lin, floor, attack_b, release_b, hold_n)``;
    * :data:`PINK`: carry the three poles, no coefs.

    Returns ``(carry', y f32[..., F])``, each carry leaf shaped
    ``x.shape[:-1]``.  CPU tensors run :func:`scan_reference`; CUDA tensors
    launch K5 and add one to ``scan_lanes.launches``."""
    if x.device.type == "cpu":
        return scan_reference(kind, x, carry, coefs)
    carry, coefs = _operands(kind, x, carry, coefs)
    if x.device.type != "cuda":
        raise ValueError(f"scan_lanes: unsupported device {x.device}")
    lead = x.shape[:-1]
    lanes = lead.numel()
    x = x.contiguous()
    y = torch.empty_like(x)
    carry_in = torch.stack(carry).reshape(len(carry), lanes).contiguous()
    coef = (torch.stack(coefs).reshape(len(coefs), lanes).contiguous() if coefs
            else carry_in)  # PINK reads none
    carry_out = torch.empty_like(carry_in)
    if lanes == 0:
        return tuple(c.reshape(lead) for c in carry_out), y
    lib = LIBRARY.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fw_sample_scan(kind, x.data_ptr(), y.data_ptr(), carry_in.data_ptr(),
                                 carry_out.data_ptr(), coef.data_ptr(), lanes,
                                 x.shape[-1], stream)
    if err != 0:
        raise RuntimeError(f"scan_lanes: kernel launch failed (cudaError {err})")
    scan_lanes.launches += 1
    return tuple(c.reshape(lead) for c in carry_out), y


#: kernel launches since the counter was last set to 0
scan_lanes.launches = 0


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
