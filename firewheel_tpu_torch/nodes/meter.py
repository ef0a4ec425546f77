"""dB meter node: per-channel peak and RMS metering with host readback.

PyTorch port of ``firewheel_tpu/nodes/meter.py``.  The kernel is a
passthrough that folds peak (per-block max |x|, ~300 ms release) and a
one-pole mean square (~125 ms window) into its state; with 0 outputs the
node is a pure sink that only meters.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.node import AudioNode, AudioNodeInfo, NodeActivationError, NodeProcessor, MAX_PORTS
from ..core.units import gain_to_db_clamped_neg_100_db

__all__ = ["DbMeterNode", "DbMeterProcessor"]


class DbMeterProcessor(NodeProcessor):
    PEAK_RELEASE_SECS = 0.3
    RMS_WINDOW_SECS = 0.125

    def __init__(self, sample_rate, max_block_frames, num_inputs, num_outputs):
        super().__init__(sample_rate, max_block_frames, num_inputs, num_outputs)
        block_secs = max_block_frames / sample_rate
        self._peak_decay = float(np.float32(
            math.exp(-block_secs / self.PEAK_RELEASE_SECS)
        ))
        self._rms_alpha = float(np.float32(
            1.0 - math.exp(-block_secs / self.RMS_WINDOW_SECS)
        ))

    def init_state(self):
        ch = self.num_inputs
        return {
            "peak": torch.zeros((ch,), dtype=torch.float32),
            "rms_sq": torch.zeros((ch,), dtype=torch.float32),
        }

    def group_key(self):
        return ()

    def kernel(self, params, state, inputs, in_mask, info):
        block_peak = torch.abs(inputs).amax(dim=-1)
        peak = torch.maximum(block_peak, state["peak"] * self._peak_decay)
        block_ms = (inputs * inputs).mean(dim=-1)
        rms_sq = state["rms_sq"] + self._rms_alpha * (block_ms - state["rms_sq"])
        return inputs, {"peak": peak, "rms_sq": rms_sq}, in_mask


class DbMeterNode(AudioNode):
    debug_name = "db_meter"

    def info(self) -> AudioNodeInfo:
        return AudioNodeInfo(
            num_min_supported_inputs=1,
            num_max_supported_inputs=MAX_PORTS,
            num_min_supported_outputs=0,
            num_max_supported_outputs=MAX_PORTS,
        )

    def activate(self, sample_rate, max_block_frames, num_inputs, num_outputs):
        if num_outputs not in (0, num_inputs):
            raise NodeActivationError(
                "DbMeterNode passes audio through: num_outputs must equal "
                f"num_inputs (or 0 for a pure sink); got {num_inputs} in, "
                f"{num_outputs} out"
            )
        if num_outputs == 0:
            return _SinkMeterProcessor(
                sample_rate, max_block_frames, num_inputs, num_outputs
            )
        return DbMeterProcessor(
            sample_rate, max_block_frames, num_inputs, num_outputs
        )

    @staticmethod
    def read(meter_state) -> dict:
        """Meter state (tensors or arrays) → ``{"peak_db": f32[ch],
        "rms_db": f32[ch]}``, −100 dB floor."""
        peak = np.asarray(torch.as_tensor(meter_state["peak"]).cpu(), np.float32)
        rms = np.sqrt(np.asarray(torch.as_tensor(meter_state["rms_sq"]).cpu(), np.float32))
        return {
            "peak_db": gain_to_db_clamped_neg_100_db(peak),
            "rms_db": gain_to_db_clamped_neg_100_db(rms),
        }


class _SinkMeterProcessor(DbMeterProcessor):
    """Meter as a graph sink (0 outputs)."""

    def kernel(self, params, state, inputs, in_mask, info):
        _, st, _ = super().kernel(params, state, inputs, in_mask, info)
        lead = inputs.shape[:-2]
        return (
            inputs.new_zeros(lead + (0, inputs.shape[-1])),
            st,
            in_mask.new_zeros(lead + (0,)),
        )
