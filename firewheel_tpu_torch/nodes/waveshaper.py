"""Waveshaper node: memoryless nonlinear distortion with an optional DC
blocker.

PyTorch port of ``firewheel_tpu/nodes/waveshaper.py``.  Five transfer
curves, drive/output gains and dry/wet mix as live params, the curve itself
structural:

* ``tanh``  — ``y = tanh(g·x)``
* ``atan``  — ``y = (2/π)·atan(g·x)``
* ``soft``  — cubic soft clip ``y = 1.5t − 0.5t³, t = clip(g·x, ±1)``
* ``hard``  — ``y = clip(g·x, ±1)``
* ``fold``  — triangle wavefolder into [−1, 1] (``jnp.mod``'s floor sign:
  ``torch.remainder``)

``dc_block=True`` adds the one-pole DC blocker ``y[n] = x[n] − x[n−1] +
R·y[n−1]`` (−3 dB ≈ 20 Hz), run by :func:`~firewheel_tpu_torch.ops.iir.
one_pole_scan` (K7 on the card; in K2/K3 the waveshaper's row runs the same
scan).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.node import (
    gate,
    AudioNode,
    AudioNodeInfo,
    NodeActivationError,
    NodeProcessor,
    MAX_PORTS,
)
from ..core.units import db_to_gain
from ..ops.iir import one_pole_scan
from .filter import _QUIET_F32

__all__ = ["WaveshaperNode", "WaveshaperProcessor", "SHAPES"]

SHAPES = ("tanh", "atan", "soft", "hard", "fold")

_TWO_OVER_PI_F32 = float(np.float32(2.0 / math.pi))


def _shape(curve: str, x):
    if curve == "tanh":
        return torch.tanh(x)
    if curve == "atan":
        return _TWO_OVER_PI_F32 * torch.atan(x)
    if curve == "soft":
        t = torch.clamp(x, -1.0, 1.0)
        return 1.5 * t - 0.5 * t * t * t
    if curve == "hard":
        return torch.clamp(x, -1.0, 1.0)
    if curve == "fold":
        # period 4, the identity on [-1, 1], every excursion folded back
        return torch.abs(torch.remainder(x - 1.0, 4.0) - 2.0) - 1.0
    raise AssertionError(curve)


class WaveshaperProcessor(NodeProcessor):
    def __init__(self, node, sample_rate, max_block_frames, num_inputs, num_outputs):
        super().__init__(sample_rate, max_block_frames, num_inputs, num_outputs)
        self._node = node
        # one-pole DC-blocker pole for ~20 Hz highpass
        self._dc_r = float(np.exp(-2.0 * math.pi * 20.0 / sample_rate))

    def group_key(self):
        return (self._node.curve, self._node._dc_block)

    def init_state(self):
        if not self._node._dc_block:
            return {}
        ch = self.num_inputs
        return {
            "x1": torch.zeros((ch,), dtype=torch.float32),
            "y1": torch.zeros((ch,), dtype=torch.float32),
        }

    def collect_params(self):
        n = self._node
        return {
            "drive": np.float32(db_to_gain(np.float32(n._drive_db))),
            "out": np.float32(db_to_gain(np.float32(n._output_db))),
            "mix": np.float32(n._mix),
        }

    def kernel(self, params, state, inputs, in_mask, info):
        drive, out, mix = (params[k][..., None, None] for k in ("drive", "out", "mix"))
        shaped = _shape(self._node.curve, inputs * drive)
        frames = inputs.shape[-1]

        if self._node._dc_block:
            # y[n] = (x[n] - x[n-1]) + R·y[n-1]: the one-pole scan of Δx
            x_prev = torch.cat([state["x1"][..., None], shaped[..., : frames - 1]], dim=-1)
            y, y_last = one_pole_scan(shaped - x_prev, state["y1"], 1.0, self._dc_r)
            new_state = {"x1": shaped[..., frames - 1], "y1": y_last}
            # a silent input still drains the blocker's tail
            state_quiet = (torch.abs(state["x1"]) < _QUIET_F32) & (
                torch.abs(state["y1"]) < _QUIET_F32)
            out_mask = in_mask & state_quiet
            shaped = y
        else:
            new_state = {}
            out_mask = in_mask  # every curve maps 0 -> 0

        y = (inputs + mix * (shaped - inputs)) * out
        return gate(y, out_mask), new_state, out_mask


class WaveshaperNode(AudioNode):
    """Memoryless distortion/saturation (see the module docstring).

    ``drive_db``/``output_db``/``mix`` are live params; ``curve`` and
    ``dc_block`` are structural.
    """

    debug_name = "waveshaper"

    def __init__(self, curve: str = "tanh", drive_db: float = 0.0,
                 output_db: float = 0.0, mix: float = 1.0, dc_block: bool = False):
        assert curve in SHAPES, f"unknown curve {curve!r}; one of {SHAPES}"
        self.curve = curve
        self._drive_db = float(drive_db)
        self._output_db = float(output_db)
        self._mix = min(max(float(mix), 0.0), 1.0)
        self._dc_block = bool(dc_block)
        # 0 in -> 0 out and (without the blocker) no tail: prunable
        self.silence_transparent = not dc_block

    def drive_db(self) -> float:
        return self._drive_db

    def set_drive_db(self, db: float):
        self._drive_db = float(db)

    def set_output_db(self, db: float):
        self._output_db = float(db)

    def set_mix(self, mix: float):
        self._mix = min(max(float(mix), 0.0), 1.0)

    def info(self) -> AudioNodeInfo:
        return AudioNodeInfo(
            num_min_supported_inputs=1,
            num_max_supported_inputs=MAX_PORTS,
            num_min_supported_outputs=1,
            num_max_supported_outputs=MAX_PORTS,
        )

    def activate(self, sample_rate, max_block_frames, num_inputs, num_outputs):
        if num_inputs != num_outputs:
            raise NodeActivationError(
                "WaveshaperNode requires num_inputs == num_outputs; "
                f"got {num_inputs} in, {num_outputs} out"
            )
        return WaveshaperProcessor(
            self, sample_rate, max_block_frames, num_inputs, num_outputs
        )
