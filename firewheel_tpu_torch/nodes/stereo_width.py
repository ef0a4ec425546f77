"""Stereo width node: mid/side balance control.

PyTorch port of ``firewheel_tpu/nodes/stereo_width.py``.  ``width = 0``
collapses to mono, ``1`` is unchanged, ``> 1`` widens; the width rides a
10 ms smoother, reset to its target when every input is silent.
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
from ..ops.pan import mid_side_merge, mid_side_split

__all__ = ["StereoWidthNode", "StereoWidthProcessor"]


class StereoWidthProcessor(NodeProcessor):
    def __init__(self, node, sample_rate, max_block_frames, num_inputs, num_outputs):
        super().__init__(sample_rate, max_block_frames, num_inputs, num_outputs)
        self._node = node
        self._coeffs = smoother_coeffs(sample_rate, SmootherConfig())

    def init_state(self):
        return {"width": smoother_init(np.float32(self._node.width()))}

    def collect_params(self):
        return {"width": np.float32(self._node.width())}

    def group_key(self):
        return ()

    def kernel(self, params, state, inputs, in_mask, info):
        frames = inputs.shape[-1]
        ramp, width_state, _ = smoother_set_and_process(
            state["width"], params["width"], frames, self._coeffs
        )
        mid, side = mid_side_split(inputs[..., 0, :], inputs[..., 1, :])
        left, right = mid_side_merge(mid, side * ramp)

        all_silent = in_mask.all(dim=-1)
        out = gate(torch.stack([left, right], dim=-2), all_silent)
        out_mask = all_silent[..., None].expand(*all_silent.shape, 2)

        st_reset = smoother_init(params["width"])
        new_width = {k: torch.where(all_silent, st_reset[k], width_state[k])
                     for k in width_state}
        return out, {"width": new_width}, out_mask


class StereoWidthNode(AudioNode):
    debug_name = "stereo_width"

    def __init__(self, width: float = 1.0):
        self._width = max(float(width), 0.0)

    def width(self) -> float:
        return self._width

    def set_width(self, width: float):
        self._width = max(float(width), 0.0)

    def info(self) -> AudioNodeInfo:
        return AudioNodeInfo(
            num_min_supported_inputs=2,
            num_max_supported_inputs=2,
            num_min_supported_outputs=2,
            num_max_supported_outputs=2,
        )

    def activate(self, sample_rate, max_block_frames, num_inputs, num_outputs):
        if num_inputs != 2 or num_outputs != 2:
            raise NodeActivationError(
                "StereoWidthNode is strictly stereo (2 in / 2 out); "
                f"got {num_inputs} in, {num_outputs} out"
            )
        return StereoWidthProcessor(
            self, sample_rate, max_block_frames, num_inputs, num_outputs
        )
