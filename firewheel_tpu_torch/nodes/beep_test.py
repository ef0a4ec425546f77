"""Beep-test node: a sine generator with a live enable switch.

PyTorch port of ``firewheel_tpu/nodes/beep_test.py`` (reference:
``basic_nodes/beep_test.rs:8-103``).  The phase is 32-bit fixed point
(2^32 == one cycle) with natural wraparound.  torch has no uint32
arithmetic on the CPU, so the phase and its increment ride as int64 masked
to 32 bits; the signed reinterpretation (phase in [-0.5, 0.5)) goes
through the int32 range → f32 → × 2^-32, exactly as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.node import (
    gate,
    AudioNode,
    AudioNodeInfo,
    NodeProcessor,
    MAX_PORTS,
    UINT32_MASK,
)
from ..core.units import db_to_gain_clamped_neg_100_db

__all__ = ["BeepTestNode", "BeepTestProcessor", "phase_inc_fixed"]

_TAU_F32 = float(np.float32(6.283185307179586))


def phase_inc_fixed(freq_hz: float, sample_rate: int) -> int:
    """Per-sample phase increment in uint32 fixed point (2^32 = one cycle)."""
    return int(round(float(freq_hz) / float(sample_rate) * 2.0**32)) & 0xFFFFFFFF


def _signed_phase(phase_q: torch.Tensor) -> torch.Tensor:
    """uint32 phase (int64 carrier) → f32 cycles in [-0.5, 0.5)."""
    signed = torch.where(phase_q >= 1 << 31, phase_q - (1 << 32), phase_q)
    return signed.to(torch.float32) * 2.0**-32


class BeepTestProcessor(NodeProcessor):
    def __init__(self, node: "BeepTestNode", sample_rate, max_block_frames, num_inputs, num_outputs):
        super().__init__(sample_rate, max_block_frames, num_inputs, num_outputs)
        self._node = node

    def init_state(self):
        return {"phase": torch.zeros((), dtype=torch.int64)}

    def collect_params(self):
        return {
            "enabled": np.asarray(self._node.enabled(), bool),
            "inc": np.uint32(
                phase_inc_fixed(self._node.freq_hz, self.sample_rate)
            ),
            "gain": np.float32(self._node.gain),
        }

    def group_key(self):
        return ()

    def kernel(self, params, state, inputs, in_mask, info):
        frames = inputs.shape[-1]
        enabled = params["enabled"]
        inc = params["inc"]
        phase = state["phase"]
        k = torch.arange(frames, dtype=torch.int64, device=inc.device)
        phases_q = (phase[..., None] + k * inc[..., None]) & UINT32_MASK
        tone = torch.sin(_signed_phase(phases_q) * _TAU_F32) * params["gain"][..., None]

        out_row = gate(tone, ~enabled)
        outputs = out_row[..., None, :].expand(
            *out_row.shape[:-1], self.num_outputs, frames
        )
        out_mask = (~enabled)[..., None].expand(
            *enabled.shape, self.num_outputs
        )

        new_phase = (phase + frames * inc) & UINT32_MASK
        # the reference freezes its phasor while disabled
        new_phase = torch.where(enabled, new_phase, phase)
        return outputs, {"phase": new_phase}, out_mask


class BeepTestNode(AudioNode):
    debug_name = "beep_test"

    def __init__(self, freq_hz: float, gain_db: float, enabled: bool = True):
        # Clamps mirror beep_test.rs:16-17.
        self.freq_hz = float(np.clip(freq_hz, 20.0, 20_000.0))
        self.gain = float(
            np.clip(db_to_gain_clamped_neg_100_db(np.float32(gain_db)), 0.0, 1.0)
        )
        self._enabled = bool(enabled)

    def enabled(self) -> bool:
        return self._enabled

    def set_enabled(self, enabled: bool):
        """Live control; staged into the next dispatch (beep_test.rs:30-32)."""
        self._enabled = bool(enabled)

    def is_dormant(self) -> bool:
        return not self._enabled

    def set_frequency(self, freq_hz: float):
        """Live frequency change (same clamp as construction)."""
        self.freq_hz = float(np.clip(freq_hz, 20.0, 20_000.0))

    def info(self) -> AudioNodeInfo:
        return AudioNodeInfo(
            num_min_supported_outputs=1, num_max_supported_outputs=MAX_PORTS
        )

    def activate(self, sample_rate, max_block_frames, num_inputs, num_outputs):
        return BeepTestProcessor(
            self, sample_rate, max_block_frames, num_inputs, num_outputs
        )
