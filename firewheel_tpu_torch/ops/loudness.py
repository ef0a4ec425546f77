"""ITU-R BS.1770 / EBU R128 loudness primitives.

The K-weighting pre-filter (a +4 dB high shelf near 1.68 kHz followed by a
~38 Hz high-pass) expressed with the standard's analog-prototype bilinear
design equations, so any sample rate matches the reference filter exactly
(the published coefficient tables are the fs=48k evaluation of these).

Filters run through the engine's biquad machinery (``ops/iir.py``); the
mean-square integration and LUFS conversion are plain elementwise math.
"""

from __future__ import annotations

import numpy as np

from .iir import BiquadCoeffs

__all__ = ["k_weighting_coeffs", "lufs_from_mean_square"]


def k_weighting_coeffs(sample_rate: int) -> tuple[BiquadCoeffs, BiquadCoeffs]:
    """The two BS.1770 pre-filter biquads for ``sample_rate``.

    Returns ``(shelf, highpass)`` coefficient sets.
    """
    fs = float(sample_rate)

    # stage 1: spherical-head high shelf
    f0 = 1681.974450955533
    g_db = 3.999843853973347
    q = 0.7071752369554196
    k = np.tan(np.pi * f0 / fs)
    vh = 10.0 ** (g_db / 20.0)
    vb = vh ** 0.4996667741545416
    a0_ = 1.0 + k / q + k * k
    shelf = BiquadCoeffs(
        b0=(vh + vb * k / q + k * k) / a0_,
        b1=2.0 * (k * k - vh) / a0_,
        b2=(vh - vb * k / q + k * k) / a0_,
        a1=2.0 * (k * k - 1.0) / a0_,
        a2=(1.0 - k / q + k * k) / a0_,
    )

    # stage 2: high-pass
    f0 = 38.13547087602444
    q = 0.5003270373238773
    k = np.tan(np.pi * f0 / fs)
    a0_ = 1.0 + k / q + k * k
    highpass = BiquadCoeffs(
        b0=1.0,
        b1=-2.0,
        b2=1.0,
        a1=2.0 * (k * k - 1.0) / a0_,
        a2=(1.0 - k / q + k * k) / a0_,
    )
    return shelf, highpass


def lufs_from_mean_square(weighted_mean_square) -> float:
    """BS.1770: ``-0.691 + 10 log10(sum_c G_c z_c)`` for the summed,
    channel-weighted mean square."""
    return -0.691 + 10.0 * np.log10(max(float(weighted_mean_square), 1e-12))
