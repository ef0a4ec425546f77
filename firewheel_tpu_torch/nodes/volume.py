"""Volume node: smoothed gain multiply with silence/mute short-circuits.

PyTorch port of ``firewheel_tpu/nodes/volume.py`` (reference:
``basic_nodes/volume.rs:8-151``).  The gain is one value a block: a change
scheduled with ``set_percent_volume(..., at_sample=)`` rides a per-block
timeline (``executor.PerBlock``) and lands on its exact block inside a
chunked dispatch.  As branch-free selects:

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
    #: scheduled gain changes ride per-block param timelines
    collect_timeline = True

    def __init__(self, node, sample_rate, max_block_frames, num_inputs, num_outputs):
        super().__init__(sample_rate, max_block_frames, num_inputs, num_outputs)
        self._node = node
        self._coeffs = smoother_coeffs(sample_rate, SmootherConfig())
        self._eps = SmootherConfig().settle_epsilon

    def init_state(self):
        return {"gain": smoother_init(np.float32(self._node.raw_gain()))}

    def collect_params(self, blocks=1, start_sample=None, frames=None,
                       consume=True):
        from ..executor import PerBlock

        node = self._node
        if start_sample is None:
            # batched paths (BatchRenderer, the megakernel): one scalar
            return {"raw_gain": np.float32(node.raw_gain())}
        f = int(frames or self.max_block_frames)
        timeline = np.full(max(1, int(blocks)), node.raw_gain(), np.float32)
        if consume and node._scheduled:
            base, base_pct = node._raw_gain, node._percent_volume
            remaining = []
            for at, g, pct in node._scheduled:
                b = (at - int(start_sample)) // f
                if b >= blocks:
                    remaining.append((at, g, pct))
                    continue
                timeline[max(0, int(b)):] = g
                base, base_pct = g, pct
            node._raw_gain, node._percent_volume = base, base_pct
            node._scheduled = remaining
        return {"raw_gain": PerBlock(timeline)}

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
        #: (at_sample, raw_gain, percent) changes awaiting their block, sorted
        self._scheduled: list[tuple[int, float, float]] = []

    def percent_volume(self) -> float:
        return self._percent_volume

    def cancel_scheduled(self) -> None:
        """Drop every ``at_sample=`` change not yet consumed by a dispatch."""
        self._scheduled.clear()

    def set_percent_volume(self, percent_volume: float, at_sample: int | None = None):
        """Live control (volume.rs:28-34).

        ``at_sample``: the absolute stream sample at which the change lands,
        on that sample's block even inside a chunked dispatch.  ``None``
        applies at the next dispatch and drops any scheduled change."""
        g = float(percent_volume_to_raw_gain(np.float32(percent_volume)))
        pct = max(float(percent_volume), 0.0)
        if at_sample is None:
            self._percent_volume, self._raw_gain = pct, g
            self._scheduled.clear()
        else:
            # percent_volume() reports the audible value until the change
            # lands (the timeline updates both fields together)
            self._scheduled.append((int(at_sample), g, pct))
            self._scheduled.sort(key=lambda p: p[0])

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
