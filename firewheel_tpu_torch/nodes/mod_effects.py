"""Modulation effects: chorus / flanger / vibrato (a modulated fractional
delay) and tremolo / ring modulation (amplitude modulation).

PyTorch port of ``firewheel_tpu/nodes/mod_effects.py``.

* :class:`ModDelayNode` — one LFO-swept fractional-delay tap per channel
  (sine LFO, a per-channel phase spread), dry/wet mix, optional feedback.
  Presets: :meth:`ModDelayNode.chorus`, :meth:`ModDelayNode.flanger`
  (feedback), :meth:`ModDelayNode.vibrato` (100 % wet).
* :class:`TremoloNode` — LFO gain modulation; ``bipolar=True`` turns it
  into a ring modulator.

Without feedback the block is one fractional gather, ``torch.gather`` over
``cat(line, x)`` at per-sample positions.  With feedback the line's input
depends on its own delayed output; since every tap lies at least
``_SUB + 1`` samples back (``collect_params`` clamps the base delay), the
recurrence runs exactly as a loop over sub-blocks of ``_SUB = 32`` frames,
each one gather.  The line is a shift-left ring (the newest sample last),
the JAX package's layout.
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

__all__ = [
    "ModDelayNode",
    "ModDelayProcessor",
    "TremoloNode",
    "TremoloProcessor",
]

# feedback sub-block length: the exactness bound for the feedback loop
# (see the module docstring); also the minimum enforced base delay - 1
_SUB = 32

_TWO_PI_F32 = float(np.float32(2.0 * math.pi))
_QUIET_LINE = float(np.float32(1e-10))


def _lfo_phases(phase, rate, spread, ch, frames):
    """Per-channel, per-sample LFO phases ``[..., ch, F]`` and the carried
    phase ``[...]``; ``phase``, ``rate`` and ``spread`` are per instance
    ``[...]``."""
    t = torch.arange(1, frames + 1, dtype=torch.float32, device=phase.device)
    ph = phase[..., None] + t * rate[..., None]  # [..., F]
    # a tensor divisor, so that the card divides as the CPU does (torch
    # multiplies by a Python number's reciprocal on the card)
    offs = (spread[..., None]
            * torch.arange(ch, dtype=torch.float32, device=phase.device)
            / torch.full_like(spread[..., None], float(max(ch, 1))))  # [..., ch]
    phases = torch.remainder(ph[..., None, :] + offs[..., :, None], 1.0)
    phase_last = torch.remainder(phase + float(frames) * rate, 1.0)
    return phases, phase_last


def _lfo_delay(phases, base, depth):
    """Sine-swept delay in samples: ``base + depth·(0.5 − 0.5·cos)`` (the
    shortest delay at phase 0); ``base`` and ``depth`` broadcast."""
    return base + depth * (0.5 - 0.5 * torch.cos(_TWO_PI_F32 * phases))


def _tap(seq, pos):
    """Linear interpolation of ``seq [..., ch, W]`` at ``pos [..., ch, F]``
    (in bounds: ``0 <= floor(pos)`` and ``floor(pos) + 1 < W``)."""
    i0 = torch.floor(pos)
    frac = pos - i0
    i0 = i0.to(torch.int64)
    s0 = torch.gather(seq, -1, i0)
    s1 = torch.gather(seq, -1, i0 + 1)
    return s0 + (s1 - s0) * frac


class ModDelayProcessor(NodeProcessor):
    def __init__(self, node, sample_rate, max_block_frames, num_inputs, num_outputs):
        super().__init__(sample_rate, max_block_frames, num_inputs, num_outputs)
        self._node = node
        self._fb_mode = node._fb_mode
        # the feedback program's sub-block loop has no row in K2/K3: a torch
        # stage on the hybrid lowering
        self.supports_megakernel = not self._fb_mode
        # line length: the largest reachable delay + interpolation headroom
        self._window = int(math.ceil(node._max_delay_secs * sample_rate)) + 2
        if self._fb_mode:
            # feedback needs base >= SUB+1 and base <= w-2: grow a line
            # shorter than SUB+3 rather than invert the clamp
            self._window = max(self._window, _SUB + 3)

    def group_key(self):
        return (self._window, self._fb_mode)

    def init_state(self):
        return {
            "line": torch.zeros((self.num_inputs, self._window), dtype=torch.float32),
            "phase": torch.zeros((), dtype=torch.float32),
        }

    def collect_params(self):
        n = self._node
        sr = self.sample_rate
        w = self._window
        # every reachable tap inside the line: 1 <= base, base + depth <=
        # W - 2; feedback also needs base >= SUB + 1
        lo = float(_SUB + 1) if self._fb_mode else 1.0
        base = float(np.clip(n._base_delay_secs * sr, lo, w - 2))
        depth = float(np.clip(n._depth_secs * sr, 0.0, w - 2 - base))
        return {
            "rate": np.float32(n._rate_hz / sr),  # cycles per sample
            "base": np.float32(base),
            "depth": np.float32(depth),
            "mix": np.float32(n._mix),
            "spread": np.float32(n._phase_spread),
            "feedback": np.float32(n._feedback if self._fb_mode else 0.0),
        }

    def kernel(self, params, state, inputs, in_mask, info):
        ch, frames = inputs.shape[-2:]
        w = self._window
        base, depth, mix, fb = (params[k][..., None, None]
                                for k in ("base", "depth", "mix", "feedback"))
        phases, phase_last = _lfo_phases(state["phase"], params["rate"],
                                         params["spread"], ch, frames)
        d = _lfo_delay(phases, base, depth)  # [..., ch, F]
        line = state["line"]

        if not self._fb_mode:
            seq = torch.cat([line, inputs], dim=-1)
            n = torch.arange(frames, dtype=torch.float32, device=inputs.device)
            tap = _tap(seq, (float(w) + n) - d)  # positions in [1, w+F-2]
            new_line = seq[..., frames:]
        else:
            # every tap lies before the current sub-block: d >= SUB + 1
            s = min(_SUB, frames)
            n_sub = -(-frames // s)
            pad = n_sub * s - frames
            if pad:
                # pad the tail sub-block (d pads to base, in bounds); the
                # padding reaches only the loop's line after the last real
                # sample, and the carried line is rebuilt from real writes
                x_p = torch.cat([inputs, inputs.new_zeros(inputs.shape[:-1] + (pad,))],
                                dim=-1)
                d_p = torch.cat([d, base.expand(*d.shape[:-1], pad)], dim=-1)
            else:
                x_p, d_p = inputs, d
            nloc = torch.arange(s, dtype=torch.float32, device=inputs.device)
            taps, writes = [], []
            for j in range(n_sub):
                tap_j = _tap(line, (float(w) + nloc) - d_p[..., j * s:(j + 1) * s])
                written = x_p[..., j * s:(j + 1) * s] + fb * tap_j
                line = torch.cat([line[..., s:], written], dim=-1)
                taps.append(tap_j)
                writes.append(written)
            tap = torch.cat(taps, dim=-1)[..., :frames]
            written = torch.cat(writes, dim=-1)[..., :frames]
            new_line = torch.cat([state["line"], written], dim=-1)[..., frames:]

        y = inputs + mix * (tap - inputs)
        line_quiet = (torch.abs(state["line"]) < _QUIET_LINE).all(dim=-1)
        out_mask = in_mask & line_quiet
        return gate(y, out_mask), {"line": new_line, "phase": phase_last}, out_mask


class ModDelayNode(AudioNode):
    """LFO-modulated fractional delay (chorus / flanger / vibrato).

    ``feedback=None`` selects the program without feedback (chorus,
    vibrato); any float (0.0 included) selects the feedback program with
    ``feedback`` as a live param (flanger).  ``max_delay_secs`` is
    structural (it sizes the line); rate, base, depth, mix, spread and
    feedback are live.
    """

    debug_name = "mod_delay"

    def __init__(
        self,
        rate_hz: float = 0.8,
        base_delay_secs: float = 0.020,
        depth_secs: float = 0.005,
        mix: float = 0.5,
        phase_spread: float = 0.25,
        feedback: float | None = None,
        max_delay_secs: float | None = None,
    ):
        self._rate_hz = float(np.clip(rate_hz, 0.0, 20.0))
        self._base_delay_secs = max(float(base_delay_secs), 0.0)
        self._depth_secs = max(float(depth_secs), 0.0)
        self._mix = min(max(float(mix), 0.0), 1.0)
        self._phase_spread = min(max(float(phase_spread), 0.0), 1.0)
        self._fb_mode = feedback is not None
        self._feedback = float(np.clip(feedback or 0.0, -0.95, 0.95))
        if max_delay_secs is None:
            max_delay_secs = self._base_delay_secs + self._depth_secs
        self._max_delay_secs = max(
            float(max_delay_secs), self._base_delay_secs + self._depth_secs, 1e-3)

    # -- presets ---------------------------------------------------------------
    @classmethod
    def chorus(cls, rate_hz=0.8, depth_secs=0.004, mix=0.5):
        return cls(rate_hz, 0.020, depth_secs, mix, phase_spread=0.25)

    @classmethod
    def flanger(cls, rate_hz=0.25, depth_secs=0.003, mix=0.5, feedback=0.6):
        return cls(rate_hz, 0.0015, depth_secs, mix, phase_spread=0.0,
                   feedback=feedback)

    @classmethod
    def vibrato(cls, rate_hz=5.0, depth_secs=0.003):
        return cls(rate_hz, 0.005, depth_secs, mix=1.0, phase_spread=0.0)

    # -- live params -------------------------------------------------------------
    def set_rate_hz(self, v: float):
        self._rate_hz = float(np.clip(v, 0.0, 20.0))

    def set_base_delay_secs(self, v: float):
        self._base_delay_secs = max(float(v), 0.0)

    def set_depth_secs(self, v: float):
        self._depth_secs = max(float(v), 0.0)

    def set_mix(self, v: float):
        self._mix = min(max(float(v), 0.0), 1.0)

    def set_phase_spread(self, v: float):
        self._phase_spread = min(max(float(v), 0.0), 1.0)

    def set_feedback(self, v: float):
        if not self._fb_mode:
            raise ValueError(
                "this ModDelayNode was built without feedback (pass "
                "feedback=0.0 at construction to enable the feedback program)"
            )
        self._feedback = float(np.clip(v, -0.95, 0.95))

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
                "ModDelayNode requires num_inputs == num_outputs; "
                f"got {num_inputs} in, {num_outputs} out"
            )
        return ModDelayProcessor(
            self, sample_rate, max_block_frames, num_inputs, num_outputs
        )


class TremoloProcessor(NodeProcessor):
    def __init__(self, node, sample_rate, max_block_frames, num_inputs, num_outputs):
        super().__init__(sample_rate, max_block_frames, num_inputs, num_outputs)
        self._node = node

    def group_key(self):
        return (self._node._bipolar,)

    def init_state(self):
        return {"phase": torch.zeros((), dtype=torch.float32)}

    def collect_params(self):
        n = self._node
        return {
            "rate": np.float32(n._rate_hz / self.sample_rate),
            "depth": np.float32(n._depth),
            "spread": np.float32(n._phase_spread),
        }

    def kernel(self, params, state, inputs, in_mask, info):
        ch, frames = inputs.shape[-2:]
        phases, phase_last = _lfo_phases(state["phase"], params["rate"],
                                         params["spread"], ch, frames)
        carrier = torch.cos(_TWO_PI_F32 * phases)
        depth = params["depth"][..., None, None]
        if self._node._bipolar:
            # ring modulation at depth 1: y = x·cos
            g = (1.0 - depth) + depth * carrier
        else:
            # tremolo: gain in [1 - depth, 1]
            g = 1.0 - depth * (0.5 - 0.5 * carrier)
        return gate(inputs * g, in_mask), {"phase": phase_last}, in_mask


class TremoloNode(AudioNode):
    """LFO amplitude modulation; ``bipolar=True`` is a ring modulator."""

    debug_name = "tremolo"
    silence_transparent = True  # 0 in -> 0 out, no tail

    def __init__(self, rate_hz: float = 5.0, depth: float = 0.5,
                 phase_spread: float = 0.0, bipolar: bool = False):
        self._rate_hz = float(np.clip(rate_hz, 0.0, 20_000.0))
        self._depth = min(max(float(depth), 0.0), 1.0)
        self._phase_spread = min(max(float(phase_spread), 0.0), 1.0)
        self._bipolar = bool(bipolar)

    def set_rate_hz(self, v: float):
        self._rate_hz = float(np.clip(v, 0.0, 20_000.0))

    def set_depth(self, v: float):
        self._depth = min(max(float(v), 0.0), 1.0)

    def set_phase_spread(self, v: float):
        self._phase_spread = min(max(float(v), 0.0), 1.0)

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
                "TremoloNode requires num_inputs == num_outputs; "
                f"got {num_inputs} in, {num_outputs} out"
            )
        return TremoloProcessor(
            self, sample_rate, max_block_frames, num_inputs, num_outputs
        )
