"""Offline high-quality sample-rate conversion (polyphase windowed sinc).

The playback path resamples on device (``nodes/sampler.py`` linear/
cubic/sinc8 — reference sampler.rs:359-522's resampling TODO); this
module is the *asset tooling* counterpart: mastering-grade offline
conversion for encode pipelines (``encode_opus`` only accepts Opus
rates; game asset bakes convert 44.1 kHz sources to 48 kHz once,
offline).  Pure NumPy — a rational-ratio polyphase filter bank built
from a Kaiser-windowed sinc, fully vectorized (one gather + one
einsum per output block; no Python per-sample loops).

Design: conversion ratio L/M in lowest terms; the prototype low-pass
cuts at ``rolloff ·  min(fs_in, fs_out)/2`` with a Kaiser window sized
for ~100 dB stopband (beta 9.5, 32 zero crossings at the lower rate).
Each of the L phases is one row of the bank; output n gathers
``taps`` input samples at ``floor(n·M/L)`` and dots its phase row —
identical math to upsample-filter-downsample, without materializing
the upsampled signal.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np

__all__ = ["resample"]

_NUM_ZEROS = 32  # sinc zero crossings each side (at the lower rate)
_KAISER_BETA = 9.54  # ~100 dB stopband (Kaiser's formula, A=100)


def _design_bank(L: int, M: int, rolloff: float):
    """Polyphase bank ``h[L, taps]`` for ratio L/M (output/input)."""
    # cutoff relative to the INPUT Nyquist; when downsampling the
    # anti-alias cutoff is the OUTPUT Nyquist
    cut = rolloff * min(1.0, L / M)
    # taps per phase: enough for _NUM_ZEROS sinc zeros at the cutoff
    half = int(np.ceil(_NUM_ZEROS / cut))
    taps = 2 * half
    # phase p of output n: input position = floor(n·M/L) + frac, where
    # frac = (n·M mod L)/L.  Tap k weights input sample base + k - half + 1.
    k = np.arange(taps)[None, :] - (half - 1)  # [1, taps]
    # row p serves outputs with n·M ≡ p (mod L): frac = p/L
    frac = np.arange(L)[:, None] / L  # [L, 1]
    x = k - frac  # distance (input samples) from the ideal point
    h = cut * np.sinc(cut * x)
    # analytic Kaiser over exactly the tap support [-half, half] (a
    # window sampled on a wider grid under-tapers the edges → ripple)
    arg = np.maximum(1.0 - (x / half) ** 2, 0.0)
    wx = np.i0(_KAISER_BETA * np.sqrt(arg)) / np.i0(_KAISER_BETA)
    h = (h * wx).astype(np.float64)
    # normalize each phase to unity DC gain (flat passband to <0.01 dB)
    h /= h.sum(axis=1, keepdims=True)
    return h.astype(np.float32), half


def resample(audio: np.ndarray, sr_in: int, sr_out: int,
             rolloff: float = 0.945) -> np.ndarray:
    """Convert f32 ``[channels, frames]`` (or ``[frames]``) from
    ``sr_in`` to ``sr_out`` → f32 ``[channels, ceil(frames·out/in)]``.

    Mastering-grade: ~100 dB stopband, <0.01 dB passband ripple,
    linear phase (constant group delay, compensated — output sample 0
    aligns with input sample 0)."""
    audio = np.atleast_2d(np.asarray(audio, np.float32))
    ch, n = audio.shape
    if sr_in == sr_out or n == 0:
        return audio.copy()
    fr = Fraction(int(sr_out), int(sr_in))
    L, M = fr.numerator, fr.denominator
    h, half = _design_bank(L, M, rolloff)
    taps = h.shape[1]
    n_out = -(-n * L // M)  # ceil
    pad = half + 1
    padded = np.pad(audio, ((0, 0), (pad, pad)), mode="constant")
    out = np.empty((ch, n_out), np.float32)
    # blocked over output samples: the [ch, B, taps] window gather is
    # the peak allocation (a whole-signal gather would be taps× the
    # signal size — ~12 GB for a 3-minute stereo 44.1→48 k bake)
    B = max(1, (1 << 24) // (ch * taps))  # ≈64 MB f32 of windows
    koff = np.arange(taps, dtype=np.int64)[None, :] + (pad - (half - 1))
    for s in range(0, n_out, B):
        idx = np.arange(s, min(s + B, n_out), dtype=np.int64)
        base = idx * M // L  # input integer position per output sample
        phase = (idx * M % L).astype(np.int64)
        windows = padded[:, base[:, None] + koff]  # [ch, B, taps]
        out[:, s:s + len(idx)] = np.einsum("cnt,nt->cn", windows, h[phase])
    return out
