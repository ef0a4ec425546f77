"""Hard clip node: clamp samples to ±threshold.

PyTorch port of ``firewheel_tpu/nodes/hard_clip.py`` (reference:
``basic_nodes/hard_clip.rs:3-101``): ``out = min(max(in, -t), t)``; the
out mask copies the in mask.  ``clip_count`` (int32) counts the samples
over the threshold on audible channels, for host-side clip events.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.node import (
    expand_like,
    AudioNode,
    AudioNodeInfo,
    NodeActivationError,
    NodeProcessor,
    MAX_PORTS,
)
from ..core.units import db_to_gain_clamped_neg_100_db

__all__ = ["HardClipNode", "HardClipProcessor"]


class HardClipProcessor(NodeProcessor):
    def __init__(self, threshold_gain, sample_rate, max_block_frames, num_inputs, num_outputs):
        super().__init__(sample_rate, max_block_frames, num_inputs, num_outputs)
        self.threshold_gain = np.float32(threshold_gain)

    def collect_params(self):
        return {"threshold": np.float32(self.threshold_gain)}

    def group_key(self):
        return ()

    def init_state(self):
        return {"clip_count": torch.zeros((), dtype=torch.int32)}

    def event_counters(self):
        """``clipped``: number of samples that exceeded the threshold."""
        return {"clipped": "clip_count"}

    def kernel(self, params, state, inputs, in_mask, info):
        t = expand_like(params["threshold"], inputs)
        out = torch.maximum(torch.minimum(inputs, t), -t)
        # count strictly-over-threshold samples on audible channels only
        over = (torch.abs(inputs) > t) & ~in_mask[..., None]
        new_state = {
            "clip_count": state["clip_count"]
            + over.sum(dim=(-2, -1), dtype=torch.int32)
        }
        return out, new_state, in_mask


class HardClipNode(AudioNode):

    #: silence in => silence out, no self-generated signal
    silence_transparent = True
    debug_name = "hard_clip"

    def __init__(self, threshold_db: float):
        self.threshold_gain = float(
            db_to_gain_clamped_neg_100_db(np.float32(threshold_db))
        )

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
                "The number of inputs on a HardClip node must equal the "
                f"number of outputs. Got num_inputs: {num_inputs}, "
                f"num_outputs: {num_outputs}"
            )
        return HardClipProcessor(
            self.threshold_gain, sample_rate, max_block_frames, num_inputs, num_outputs
        )
