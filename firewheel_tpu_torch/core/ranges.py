"""Parameter ranges: linear, log-frequency, and power-curve mappings.

Mirrors ``crates/firewheel-core/src/param/range.rs:1-125``.  Pure functions /
frozen dataclasses; usable on host (numpy) or on tensors (torch, on any
device).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

__all__ = ["LinearRange", "NormToFreqRange", "NormToPowRange"]


class _TorchOps:
    """The numpy names this module uses, as float32 torch ops on one
    device."""

    def __init__(self, device):
        self.device = device

    def float32(self, v):
        return torch.tensor(v, dtype=torch.float32, device=self.device)

    def asarray(self, v, dtype=None):
        return torch.as_tensor(v, dtype=torch.float32, device=self.device)

    maximum = staticmethod(torch.maximum)
    minimum = staticmethod(torch.minimum)
    power = staticmethod(torch.pow)
    where = staticmethod(torch.where)


def _np_like(x):
    if isinstance(x, torch.Tensor):
        return _TorchOps(x.device)
    return np


@dataclasses.dataclass(frozen=True)
class LinearRange:
    """A clamped linear parameter range (range.rs:3-22)."""

    min: float = 0.0
    max: float = 1.0

    def clamp(self, val):
        xp = _np_like(val)
        val = xp.asarray(val, dtype=xp.float32)
        if self.min > self.max:
            # Reference quirk: when min > max the clamp order flips
            # (range.rs:15-19).
            return xp.maximum(xp.minimum(val, xp.float32(self.min)), xp.float32(self.max))
        return xp.maximum(xp.minimum(val, xp.float32(self.max)), xp.float32(self.min))


@dataclasses.dataclass(frozen=True)
class NormToFreqRange:
    """Normalized [0,1] → frequency in Hz via a log2 curve (range.rs:48-86)."""

    min_hz: float
    max_hz: float

    def __post_init__(self):
        assert self.min_hz < self.max_hz
        assert self.min_hz != 0.0 and self.max_hz != 0.0

    @property
    def _min_log2(self) -> float:
        return float(np.float32(math.log2(self.min_hz)))

    @property
    def _range(self) -> float:
        return float(np.float32(math.log2(self.max_hz)) - np.float32(self._min_log2))

    def to_hz(self, normalized):
        xp = _np_like(normalized)
        n = xp.asarray(normalized, dtype=xp.float32)
        hz = xp.power(
            xp.float32(2.0), n * xp.float32(self._range) + xp.float32(self._min_log2)
        )
        hz = xp.where(n <= xp.float32(0.0), xp.float32(self.min_hz), hz)
        return xp.where(n >= xp.float32(1.0), xp.float32(self.max_hz), hz)


@dataclasses.dataclass(frozen=True)
class NormToPowRange:
    """Normalized [0,1] → value via a power curve (range.rs:97-125)."""

    min: float
    max: float
    exponent: float

    def __post_init__(self):
        assert self.min <= self.max

    def to_dsp(self, normalized):
        xp = _np_like(normalized)
        n = xp.asarray(normalized, dtype=xp.float32)
        v = xp.power(n, xp.float32(self.exponent)) * xp.float32(
            self.max - self.min
        ) + xp.float32(self.min)
        v = xp.where(n <= xp.float32(0.0), xp.float32(self.min), v)
        return xp.where(n >= xp.float32(1.0), xp.float32(self.max), v)
