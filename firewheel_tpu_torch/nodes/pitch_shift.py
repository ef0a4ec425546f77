"""Real-time pitch shifter: a dual-tap crossfading delay line.

PyTorch port of ``firewheel_tpu/nodes/pitch_shift.py``.  The input rolls
through a shift-left ring of ``W`` frames (the newest sample last, the JAX
package's layout); two read taps half a wrap cycle apart advance at the
pitch ratio ``r = 2^(semitones/12)``, each weighted by a triangular
crossfade of its wrap phase, so one tap is always silent when it jumps.
The block is two fractional gathers at per-sample positions and a blend.

``W`` is a power of two of at least ``8·max_block_frames``: the taps keep
``W/8`` of slack from the region written this block, so the output does
not depend on how a stream is cut into blocks.  ``semitones`` is live; the
state carries the tap phase, so glides are phase-continuous.  An all-silent
block with a quiet ring resets the ring and the phase.
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

__all__ = ["PitchShiftNode", "PitchShiftProcessor"]

_QUIET_RING = float(np.float32(1e-12))


class PitchShiftProcessor(NodeProcessor):
    def __init__(self, node, sample_rate, max_block_frames, num_inputs, num_outputs):
        super().__init__(sample_rate, max_block_frames, num_inputs, num_outputs)
        self._node = node
        w = max(int(node.window_secs * sample_rate), 8 * max_block_frames)
        self._window = 1 << (w - 1).bit_length()

    def group_key(self):
        return (self._window,)

    def init_state(self):
        return {
            # shift-left ring: ring[..., -1] is the newest sample
            "ring": torch.zeros((self.num_inputs, self._window), dtype=torch.float32),
            # tap A's position in its wrap cycle, in [0, 1); B rides half a
            # cycle away
            "phase": torch.zeros((), dtype=torch.float32),
        }

    def collect_params(self):
        n = self._node
        ratio = float(2.0 ** (n._semitones / 12.0))
        return {"ratio": np.float32(ratio), "mix": np.float32(n._mix)}

    def kernel(self, params, state, inputs, in_mask, info):
        ch, frames = inputs.shape[-2:]
        w = self._window
        ring = torch.cat([state["ring"][..., frames:], inputs], dim=-1)

        # phase p in [0, 1) is the delay p·span, span = W − W/8; both taps
        # advance phase at (1 − ratio)/span a sample, so the delay drifts at
        # (1 − ratio): the pitch ratio
        span = float(w - w // 8)
        t = torch.arange(1, frames + 1, dtype=torch.float32, device=inputs.device)
        # a tensor divisor: torch divides a tensor by a Python number on the
        # card as a product with the number's float32 reciprocal, an ulp from
        # the division the CPU (and the JAX package) computes, and the phase
        # carries that ulp from block to block
        dphase = (1.0 - params["ratio"]) / torch.full_like(params["ratio"], span)
        phases_a = torch.remainder(state["phase"][..., None] + t * dphase[..., None], 1.0)
        phases_b = torch.remainder(phases_a + 0.5, 1.0)

        # output sample k reads at now − delay, now = ring index w − F + k;
        # pos stays in [w/8 − F, w − 1]
        now = (float(w - frames) + t) - 1.0

        def tap(phases):
            pos = now - phases * span  # [..., F]
            i0 = torch.floor(pos)
            frac = pos - i0
            i0 = i0.to(torch.int64)
            # pos == w − 1 gives i1 == w with frac == 0: clamp
            i1 = torch.clamp_max(i0 + 1, w - 1)
            lanes = ring.shape[:-1] + (frames,)
            s0 = torch.gather(ring, -1, i0[..., None, :].expand(lanes))
            s1 = torch.gather(ring, -1, i1[..., None, :].expand(lanes))
            y = s0 + (s1 - s0) * frac[..., None, :]
            # triangular crossfade: silent at the wrap, loudest mid-cycle
            gain = 1.0 - torch.abs(2.0 * phases - 1.0)
            return y * gain[..., None, :]

        shifted = tap(phases_a) + tap(phases_b)
        y = inputs + params["mix"][..., None, None] * (shifted - inputs)

        line_quiet = (torch.abs(state["ring"]) < _QUIET_RING).flatten(-2).all(dim=-1)
        all_silent = in_mask.all(dim=-1) & line_quiet
        out_mask = all_silent[..., None].expand(*all_silent.shape, ch)
        new_state = {
            "ring": torch.where(all_silent[..., None, None], 0.0, ring),
            "phase": torch.where(all_silent, 0.0, phases_a[..., frames - 1]),
        }
        return gate(y, all_silent), new_state, out_mask


class PitchShiftNode(AudioNode):
    debug_name = "pitch_shift"

    def __init__(self, semitones: float = 0.0, mix: float = 1.0,
                 window_secs: float = 0.05):
        """``semitones``: the shift (live; ±12 is an octave).  ``mix``:
        dry/wet (1.0 = fully shifted).  ``window_secs``: the grain window
        (structural; larger = less comb coloration, more transient smear)."""
        self._semitones = float(semitones)
        self._mix = min(max(float(mix), 0.0), 1.0)
        self.window_secs = float(window_secs)

    def semitones(self) -> float:
        return self._semitones

    def set_semitones(self, semitones: float):
        self._semitones = float(semitones)

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
                "PitchShiftNode requires num_inputs == num_outputs; "
                f"got {num_inputs} in, {num_outputs} out"
            )
        return PitchShiftProcessor(
            self, sample_rate, max_block_frames, num_inputs, num_outputs
        )
