"""Batched sequential biquad: a CUDA kernel and its plain PyTorch version.

Port of ``firewheel_tpu/ops/pallas_iir.py`` (kernel K1).  Both versions
evaluate the sequential float32 transposed-direct-form-II recurrence per
lane, frame by frame, with three fused multiply-adds::

    y = fma(b0, x, z1);  z1' = fma(b1, x, −(a1·y)) + z2;  z2' = fma(b2, x, −(a2·y))

That is the rounding XLA gives the Pallas kernel's body on the CPU (the
JAX package's interpret mode), so the port matches it sample for sample;
at a resonant section (Q = 4) separately rounded products would drift from
it by ~1e-5.

* :func:`biquad_seq_reference` — the plain version: a torch loop over
  frames.  It runs wherever its tensors are; the CPU tests hold it against
  the JAX package's Pallas kernel in interpret mode.
* :func:`biquad_seq` — the wrapper.  For CPU tensors it runs the plain
  version; for CUDA tensors it launches ``csrc/biquad.cu`` (built with
  ``nvcc`` for ``sm_90a`` at first use, loaded with ``ctypes``) or raises.
  It never falls back from the card to the plain version.

Unlike the JAX wrapper, which takes one filter per call, the coefficients
here are per lane: each broadcasts to ``x.shape[:-1]``, so a batch of
instances runs a batch of different filters in one launch.  The kernel
reads each of the seven per-lane operands through a lane divisor
(:func:`lane_repeat`), so the filter node's per-instance coefficients
``[B, 1]`` serve both channels of ``[B, 2]`` lanes without a copy.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .cuda_build import CudaLibrary
from .grad import refuse_gradients
from .iir import BiquadCoeffs, _fma

__all__ = ["biquad_seq", "biquad_seq_reference", "lane_repeat", "LIBRARY"]


def _bind(lib):
    fn = lib.fw_biquad_seq
    fn.argtypes = (
        [ctypes.c_void_p] * 3                     # x, y, z_out
        + [ctypes.c_void_p, ctypes.c_int64] * 7   # z1, z2, b0, b1, b2, a1, a2
        + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]  # lanes, frames, stream
    )
    fn.restype = ctypes.c_int


#: ``csrc/biquad.cu``, built with nvcc at first use
LIBRARY = CudaLibrary("fw_biquad", "biquad.cu", ("biquad_step.cuh",), _bind)


def biquad_seq_reference(x: torch.Tensor, z_prev, coeffs: BiquadCoeffs):
    """Plain PyTorch version: the sequential f32 recurrence as a loop over
    frames, with the kernel's rounding.  Same contract as
    :func:`biquad_seq`."""
    lead = x.shape[:-1]
    b0, b1, b2, a1, a2 = (c.broadcast_to(lead) for c in coeffs)
    z1, z2 = (z.broadcast_to(lead) for z in z_prev)
    y = torch.empty_like(x)
    for f in range(x.shape[-1]):
        xf = x[..., f]
        yf = _fma(b0, xf, z1)
        y[..., f] = yf
        z1, z2 = _fma(b1, xf, -(a1 * yf)) + z2, _fma(b2, xf, -(a2 * yf))
    return y, (z1.clone(), z2.clone())


def lane_repeat(shape, lead):
    """The lane divisor ``r`` of an operand of ``shape`` broadcast to the
    lanes ``lead``: ``broadcast_to(t, lead).reshape(-1)[l] ==
    t.reshape(-1)[l // r]`` for every lane ``l``.  That holds when the
    shape, padded with leading 1s, matches ``lead`` on its leading axes and
    is 1 on the rest (a scalar, ``[B, 1]`` against ``[B, 2]``, or ``lead``
    itself); any other broadcast gives ``None``."""
    shape, lead = tuple(shape), tuple(lead)
    if len(shape) > len(lead):
        return None
    shape = (1,) * (len(lead) - len(shape)) + shape
    k = 0
    while k < len(lead) and shape[k] == lead[k]:
        k += 1
    if any(d != 1 for d in shape[k:]):
        return None
    return max(math.prod(lead[k:]), 1)


def _lane_operand(t, lead):
    """``(contiguous tensor, lane divisor)`` for the kernel; a broadcast that
    no divisor expresses is materialised."""
    rep = lane_repeat(t.shape, lead)
    if rep is None:
        t, rep = t.broadcast_to(lead), 1
    return t.contiguous(), rep


def _check(name, t, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"biquad_seq: {name} must be a torch.Tensor")
    if t.dtype != torch.float32:
        raise TypeError(f"biquad_seq: {name} must be float32, got {t.dtype}")
    if t.device != device:
        raise ValueError(
            f"biquad_seq: {name} is on {t.device}, x is on {device}"
        )


def biquad_seq(x: torch.Tensor, z_prev, coeffs: BiquadCoeffs):
    """Run one biquad section per lane along the last axis.

    ``x``: contiguous ``f32[..., F]``; ``z_prev = (z1, z2)`` and each of the
    five coefficients (``BiquadCoeffs``): float32 tensors on ``x``'s device
    that broadcast to ``x.shape[:-1]``.  Returns ``(y f32[..., F],
    (z1', z2'))`` with the states shaped ``x.shape[:-1]``.

    CPU tensors run :func:`biquad_seq_reference`; CUDA tensors launch the
    kernel and add one to ``biquad_seq.launches``.  Where autograd records
    and an operand requires a gradient it raises ``NotImplementedError``, on
    either device: the kernel has no backward.
    """
    _check("x", x, x.device)
    if not x.is_contiguous():
        raise ValueError("biquad_seq: x must be contiguous")
    for name, t in zip(("z1", "z2"), z_prev):
        _check(name, t, x.device)
    for name, t in zip(BiquadCoeffs._fields, coeffs):
        _check(name, t, x.device)
    refuse_gradients("biquad_seq (K1)", x, *z_prev, *coeffs)
    if x.device.type == "cpu":
        return biquad_seq_reference(x, z_prev, coeffs)
    if x.device.type != "cuda":
        raise ValueError(f"biquad_seq: unsupported device {x.device}")

    lead = x.shape[:-1]
    frames = x.shape[-1]
    lanes = lead.numel()
    y = torch.empty_like(x)
    z_out = torch.empty((2, lanes), dtype=torch.float32, device=x.device)
    if lanes == 0:
        return y, (z_out[0].reshape(lead), z_out[1].reshape(lead))
    # z1, z2, b0, b1, b2, a1, a2: each a pointer and its lane divisor; the
    # copies some need live until the launch is enqueued
    operands = [_lane_operand(t, lead) for t in (*z_prev, *coeffs)]
    lib = LIBRARY.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fw_biquad_seq(
            x.data_ptr(), y.data_ptr(), z_out.data_ptr(),
            *(v for t, rep in operands for v in (t.data_ptr(), rep)),
            lanes, frames, stream,
        )
    del operands
    if err != 0:
        raise RuntimeError(f"biquad_seq: kernel launch failed (cudaError {err})")
    biquad_seq.launches += 1
    return y, (z_out[0].reshape(lead), z_out[1].reshape(lead))


#: kernel launches since the counter was last set to 0
biquad_seq.launches = 0
