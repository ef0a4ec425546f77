"""Panning laws.  PyTorch port of ``firewheel_tpu/ops/pan.py``
(``equal_power_gains``; the spatial helpers wait for the spatial slice)."""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["equal_power_gains"]

_QUARTER_PI_F32 = float(np.float32(math.pi / 4.0))


def equal_power_gains(pan: torch.Tensor):
    """Equal-power (−3 dB center) pan law.

    ``pan`` in [-1, 1] (−1 = hard left).  Returns ``(gain_l, gain_r)``:
    ``gl = cos((pan+1)·π/4)``, ``gr = sin((pan+1)·π/4)``.
    """
    theta = (pan.to(torch.float32) + 1.0) * _QUARTER_PI_F32
    return torch.cos(theta), torch.sin(theta)
