"""Volume node: smoothed gain multiply with silence/mute short-circuits.

PyTorch port of ``firewheel_tpu/nodes/volume.py`` (reference:
``basic_nodes/volume.rs:8-151``), the scalar-param path: the gain is one
value per dispatch.  As branch-free selects:

* all input channels silent → reset the smoother to the target gain, output
  silence (volume.rs:94-100);
* settled and gain < 1e-5 → muted, output silence (volume.rs:104-107);
* otherwise → ``out = in * gain_ramp`` and the out mask copies the in mask.
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
    MAX_PORTS,
)
from ..core.smoother import (
    SmootherConfig,
    smoother_coeffs,
    smoother_init,
    smoother_reset,
    smoother_set_and_process,
)
from ..core.units import percent_volume_to_raw_gain

__all__ = ["VolumeNode", "VolumeProcessor"]

_MUTE_F32 = float(np.float32(0.00001))


class VolumeProcessor(NodeProcessor):
    def __init__(self, node, sample_rate, max_block_frames, num_inputs, num_outputs):
        super().__init__(sample_rate, max_block_frames, num_inputs, num_outputs)
        self._node = node
        self._coeffs = smoother_coeffs(sample_rate, SmootherConfig())
        self._eps = SmootherConfig().settle_epsilon

    def init_state(self):
        return {"gain": smoother_init(np.float32(self._node.raw_gain()))}

    def collect_params(self):
        return {"raw_gain": np.float32(self._node.raw_gain())}

    def group_key(self):
        return ()

    def kernel(self, params, state, inputs, in_mask, info):
        frames = inputs.shape[-1]
        raw_gain = params["raw_gain"]

        ramp, st_processed, smoothing = smoother_set_and_process(
            state["gain"], raw_gain, frames, self._coeffs, self._eps
        )

        all_silent = in_mask.all(dim=-1)
        muted = ~smoothing & (ramp[..., 0] < _MUTE_F32)
        silence_out = all_silent | muted

        out = gate(inputs * ramp[..., None, :], silence_out)
        out_mask = silence_out[..., None] | in_mask

        # all-silent resets the smoother (volume.rs:95-97); muted does not.
        st_reset = smoother_reset(st_processed, raw_gain)
        new_gain_state = {
            k: torch.where(all_silent, st_reset[k], st_processed[k])
            for k in st_processed
        }
        return out, {"gain": new_gain_state}, out_mask


class VolumeNode(AudioNode):

    #: silence in => silence out, no self-generated signal
    silence_transparent = True
    debug_name = "volume"

    def __init__(self, percent_volume: float):
        self._percent_volume = max(float(percent_volume), 0.0)
        self._raw_gain = float(percent_volume_to_raw_gain(np.float32(percent_volume)))

    def percent_volume(self) -> float:
        return self._percent_volume

    def set_percent_volume(self, percent_volume: float):
        """Live control (volume.rs:28-34), applied at the next dispatch."""
        self._percent_volume = max(float(percent_volume), 0.0)
        self._raw_gain = float(percent_volume_to_raw_gain(np.float32(percent_volume)))

    def raw_gain(self) -> float:
        return self._raw_gain

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
                "The number of inputs on a VolumeNode node must equal the "
                f"number of outputs. Got num_inputs: {num_inputs}, "
                f"num_outputs: {num_outputs}"
            )
        return VolumeProcessor(
            self, sample_rate, max_block_frames, num_inputs, num_outputs
        )
