"""Decibel/linear-gain conversions and volume curves.

PyTorch port of ``firewheel_tpu/core/units.py`` (util.rs:7-41,
range.rs:32-35), evaluated in float32.  These run on the host, where
nodes stage their params, so they take scalars or numpy arrays and use
numpy: the same arithmetic as the JAX package's host path.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "db_to_gain",
    "gain_to_db",
    "db_to_gain_clamped_neg_100_db",
    "gain_to_db_clamped_neg_100_db",
    "percent_volume_to_raw_gain",
    "raw_gain_to_percent_volume",
]


def db_to_gain(db):
    """``10^(db/20)`` (util.rs:7-9)."""
    db = np.asarray(db, dtype=np.float32)
    return np.power(np.float32(10.0), np.float32(0.05) * db)


def gain_to_db(amp):
    """``20*log10(amp)`` (util.rs:13-15)."""
    amp = np.asarray(amp, dtype=np.float32)
    return np.float32(20.0) * np.log10(amp)


def db_to_gain_clamped_neg_100_db(db):
    """dB→gain with ``db <= -100`` treated as -inf gain (util.rs:21-27)."""
    db = np.asarray(db, dtype=np.float32)
    return np.where(db <= np.float32(-100.0), np.float32(0.0), db_to_gain(db))


def gain_to_db_clamped_neg_100_db(amp):
    """gain→dB with ``amp <= 1e-5`` clamped to -100 dB (util.rs:35-41)."""
    amp = np.asarray(amp, dtype=np.float32)
    floor = amp <= np.float32(0.00001)
    # guard log10(0); the select picks -100 for those lanes anyway
    safe = np.where(floor, np.float32(1.0), amp)
    return np.where(floor, np.float32(-100.0), gain_to_db(safe))


def raw_gain_to_percent_volume(raw_gain):
    """``100 * sqrt(max(g, 0))``, the inverse of
    :func:`percent_volume_to_raw_gain`."""
    g = np.asarray(raw_gain, dtype=np.float32)
    return np.float32(100.0) * np.sqrt(np.maximum(g, np.float32(0.0)))


def percent_volume_to_raw_gain(percent_volume):
    """``(max(p,0)/100)^2`` — perceptual volume curve (range.rs:32-35)."""
    p = np.asarray(percent_volume, dtype=np.float32)
    n = np.maximum(p, np.float32(0.0)) * np.float32(1.0 / 100.0)
    return n * n
