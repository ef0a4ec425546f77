"""Stereo pan node: smoothed equal-power panning.

PyTorch port of ``firewheel_tpu/nodes/pan.py``.  2-in/2-out (or
1-in/2-out): the input is collapsed to mid and panned with the equal-power
law; the pan position is smoothed like the volume node's gain.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.node import (
    gate,
    AudioNode,
    AudioNodeInfo,
    NodeActivationError,
    NodeProcessor,
)
from ..core.smoother import (
    SmootherConfig,
    smoother_coeffs,
    smoother_init,
    smoother_set_and_process,
)
from ..ops.pan import equal_power_gains

__all__ = ["StereoPanNode", "StereoPanProcessor"]


class StereoPanProcessor(NodeProcessor):
    def __init__(self, node, sample_rate, max_block_frames, num_inputs, num_outputs):
        super().__init__(sample_rate, max_block_frames, num_inputs, num_outputs)
        self._node = node
        self._coeffs = smoother_coeffs(sample_rate, SmootherConfig())

    def init_state(self):
        return {"pan": smoother_init(np.float32(self._node.pan()))}

    def collect_params(self):
        return {"pan": np.float32(self._node.pan())}

    def group_key(self):
        return ()

    def kernel(self, params, state, inputs, in_mask, info):
        frames = inputs.shape[-1]
        ramp, pan_state, _ = smoother_set_and_process(
            state["pan"], params["pan"], frames, self._coeffs
        )
        gl, gr = equal_power_gains(ramp)

        if self.num_inputs == 1:
            mid = inputs[..., 0, :]
        else:
            mid = (inputs[..., 0, :] + inputs[..., 1, :]) * 0.5

        all_silent = in_mask.all(dim=-1)
        out = gate(torch.stack([mid * gl, mid * gr], dim=-2), all_silent)
        out_mask = all_silent[..., None].expand(*all_silent.shape, 2)

        st_reset = smoother_init(params["pan"])
        new_pan = {
            k: torch.where(all_silent, st_reset[k], pan_state[k])
            for k in pan_state
        }
        return out, {"pan": new_pan}, out_mask


class StereoPanNode(AudioNode):

    #: silence in => silence out, no self-generated signal
    silence_transparent = True
    debug_name = "stereo_pan"

    def __init__(self, pan: float = 0.0):
        self._pan = float(np.clip(pan, -1.0, 1.0))

    def pan(self) -> float:
        return self._pan

    def set_pan(self, pan: float):
        self._pan = float(np.clip(pan, -1.0, 1.0))

    def info(self) -> AudioNodeInfo:
        return AudioNodeInfo(
            num_min_supported_inputs=1,
            num_max_supported_inputs=2,
            num_min_supported_outputs=2,
            num_max_supported_outputs=2,
        )

    def activate(self, sample_rate, max_block_frames, num_inputs, num_outputs):
        if num_outputs != 2 or num_inputs not in (1, 2):
            raise NodeActivationError(
                "StereoPanNode requires 1 or 2 inputs and exactly 2 outputs; "
                f"got {num_inputs} in, {num_outputs} out"
            )
        return StereoPanProcessor(
            self, sample_rate, max_block_frames, num_inputs, num_outputs
        )
