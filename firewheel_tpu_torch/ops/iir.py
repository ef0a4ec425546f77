"""Biquad coefficients: the Audio-EQ-Cookbook (RBJ) designs.

PyTorch port of ``firewheel_tpu/ops/iir.py:155-257``.  The designs take
float32 tensors of any shape (one filter per element: every instance of a
batch carries its own frequency and Q) and evaluate the same float32 ops
in the same order as the JAX package.  The sections are run by
:func:`firewheel_tpu_torch.ops.seq_iir.biquad_seq`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

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
    w0 = _TWO_PI_F32 * freq_hz.to(torch.float32) / float(np.float32(sample_rate))
    sin_w0 = torch.sin(w0)
    cos_w0 = torch.cos(w0)
    alpha = sin_w0 / (2.0 * q.to(torch.float32))
    return w0, sin_w0, cos_w0, alpha


def _norm(b0, b1, b2, a0, a1, a2) -> BiquadCoeffs:
    inv = 1.0 / a0
    return BiquadCoeffs(b0 * inv, b1 * inv, b2 * inv, a1 * inv, a2 * inv)


def _gain_a(gain_db):
    return torch.pow(10.0, gain_db.to(torch.float32) / 40.0)


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
    one = torch.ones_like(alpha)
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
    sq = 2.0 * torch.sqrt(A) * alpha
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
    sq = 2.0 * torch.sqrt(A) * alpha
    return _norm(
        A * ((A + 1.0) + (A - 1.0) * c + sq),
        -2.0 * A * ((A - 1.0) + (A + 1.0) * c),
        A * ((A + 1.0) + (A - 1.0) * c - sq),
        (A + 1.0) - (A - 1.0) * c + sq,
        2.0 * ((A - 1.0) - (A + 1.0) * c),
        (A + 1.0) - (A - 1.0) * c - sq,
    )
