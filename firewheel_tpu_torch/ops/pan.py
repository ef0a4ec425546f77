"""Panning laws and stereo field math (pan, mid/side, 3D spatial
projection).  PyTorch port of ``firewheel_tpu/ops/pan.py``: pure functions
shared by the pan and spatializer nodes."""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["equal_power_gains", "mid_side_split", "mid_side_merge", "spatial_params"]

_QUARTER_PI_F32 = float(np.float32(math.pi / 4.0))


def equal_power_gains(pan: torch.Tensor):
    """Equal-power (−3 dB center) pan law.

    ``pan`` in [-1, 1] (−1 = hard left).  Returns ``(gain_l, gain_r)``:
    ``gl = cos((pan+1)·π/4)``, ``gr = sin((pan+1)·π/4)``.
    """
    theta = (pan.to(torch.float32) + 1.0) * _QUARTER_PI_F32
    return torch.cos(theta), torch.sin(theta)


def mid_side_split(left, right):
    """``mid = (L+R)/2``, ``side = (L−R)/2``."""
    return (left + right) * 0.5, (left - right) * 0.5


def mid_side_merge(mid, side):
    """Inverse of :func:`mid_side_split`."""
    return mid + side, mid - side


def spatial_params(
    rel_pos,
    ref_distance: float = 1.0,
    rolloff: float = 1.0,
    min_distance: float = 0.1,
):
    """Distance/direction → (distance_gain, pan, distance).

    ``rel_pos``: ``f32[..., 3]`` emitter positions relative to the listener,
    in a left-handed listener frame: +x right, +y up, −z forward.

    * distance gain: inverse-distance law
      ``ref / (ref + rolloff·(d − ref))``, clamped at ``min_distance``;
    * pan: azimuth folded into [-1, 1] via ``sin(azimuth)`` so sounds
      behind the listener keep their left/right placement.

    Backend-matched: a torch tensor in gives torch math; anything else
    numpy float32 math (the host staging of the spatial nodes, which runs
    per emitter per dispatch: device round trips here would dominate large
    scenes).  The squares sum left to right, as the JAX package's sum of
    three does.
    """
    if isinstance(rel_pos, torch.Tensor):
        p = rel_pos.to(torch.float32)
        x, y, z = p[..., 0], p[..., 1], p[..., 2]
        d = torch.sqrt(x * x + y * y + z * z)
        d_eff = torch.clamp_min(d, float(np.float32(min_distance)))
        ref = float(np.float32(ref_distance))
        # a tensor numerator: torch computes `float / tensor` as a
        # reciprocal times the float, which rounds differently
        gain = torch.full_like(d_eff, ref) / (
            ref + float(np.float32(rolloff)) * torch.clamp_min(d_eff - ref, 0.0))
        horiz = torch.sqrt(x * x + z * z)
        pan = torch.where(horiz > 1e-6, x / torch.clamp_min(d_eff, 1e-6),
                          torch.zeros_like(x))
        return gain, torch.clamp(pan, -1.0, 1.0), d_eff
    p = np.asarray(rel_pos, np.float32)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    d = np.sqrt(x * x + y * y + z * z)
    d_eff = np.maximum(d, np.float32(min_distance))
    gain = np.float32(ref_distance) / (
        np.float32(ref_distance)
        + np.float32(rolloff) * np.maximum(d_eff - np.float32(ref_distance), 0.0)
    )
    horiz = np.sqrt(x * x + z * z)
    pan = np.where(horiz > 1e-6, x / np.maximum(d_eff, 1e-6), 0.0)
    return gain, np.clip(pan, -1.0, 1.0), d_eff
