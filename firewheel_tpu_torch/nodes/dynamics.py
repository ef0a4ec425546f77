"""Dynamics nodes: bus compressor, lookahead limiter, noise gate, ducker.

PyTorch port of ``firewheel_tpu/nodes/dynamics.py``.  Each is
channel-linked: one gain for all channels, computed from the loudest.  The
per-sample recurrences (envelope, release, latch) run through
:func:`~firewheel_tpu_torch.ops.dynamics.scan_lanes`, K5 on the card, one
lane per instance; the dB math around them is elementwise torch.  The
kernels take any leading batch dimensions; params are one value per
instance.

Each has a row in the megakernels (K2, K3; ``executor_mega.OPS``), which
runs the same recurrences on one lane of the instance's warp.
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
from ..core.units import db_to_gain
from ..ops.dynamics import (
    GATE,
    LIMITER,
    compressor_gain_db,
    envelope_follow,
    scan_lanes,
    sliding_max,
)

__all__ = [
    "CompressorNode",
    "CompressorProcessor",
    "DuckerNode",
    "DuckerProcessor",
    "GateNode",
    "GateProcessor",
    "LimiterNode",
    "LimiterProcessor",
]


def _coef(time_secs: float, sample_rate: int) -> float:
    """One-pole smoothing coefficient for a time constant in seconds."""
    if time_secs <= 0.0:
        return 0.0
    return float(np.exp(-1.0 / (time_secs * sample_rate)))


def _db_to_gain(db: torch.Tensor) -> torch.Tensor:
    """``10^(0.05·db)`` in float32, on the device (``core/units.py``'s
    host version)."""
    return torch.pow(10.0, 0.05 * db)


def _gain_to_db(amp: torch.Tensor) -> torch.Tensor:
    """``20·log10(amp)`` in float32, on the device (no floor: 0 → −inf)."""
    return 20.0 * torch.log10(amp)


def _per_frame(p: torch.Tensor) -> torch.Tensor:
    """A per-instance param ``[...]`` as ``[..., 1]``, against frames."""
    return p[..., None]


def _channel_level(x: torch.Tensor) -> torch.Tensor:
    """The loudest channel's ``|x|``: ``f32[..., ch, F]`` → ``[..., F]``."""
    return x.abs().amax(dim=-2)


class CompressorProcessor(NodeProcessor):
    def __init__(self, node, sample_rate, max_block_frames, num_inputs, num_outputs):
        super().__init__(sample_rate, max_block_frames, num_inputs, num_outputs)
        self._node = node

    def group_key(self):
        return ()  # all variation rides in params

    def init_state(self):
        return {"env": torch.zeros((), dtype=torch.float32)}

    def collect_params(self):
        n = self._node
        return {
            "threshold_db": np.float32(n._threshold_db),
            "ratio": np.float32(max(n._ratio, 1.0)),
            "knee_db": np.float32(max(n._knee_db, 0.0)),
            "makeup": np.float32(db_to_gain(np.float32(n._makeup_db))),
            "att_b": np.float32(_coef(n._attack_secs, self.sample_rate)),
            "rel_b": np.float32(_coef(n._release_secs, self.sample_rate)),
        }

    def kernel(self, params, state, inputs, in_mask, info):
        # channel-linked peak detector: the loudest channel drives the gain
        env, env_last = envelope_follow(
            _channel_level(inputs), state["env"], params["att_b"], params["rel_b"])
        gain_db = compressor_gain_db(
            _gain_to_db(env), _per_frame(params["threshold_db"]),
            _per_frame(params["ratio"]), _per_frame(params["knee_db"]))
        gain = _db_to_gain(gain_db) * _per_frame(params["makeup"])
        out_mask = in_mask  # gain never unsilences a silent input
        y = gate(inputs * gain[..., None, :], out_mask)
        return y, {"env": env_last}, out_mask


class CompressorNode(AudioNode):
    """Channel-linked soft-knee downward compressor: a peak envelope
    follower (attack/release one-pole), the dB-domain soft knee, and
    ``makeup_db`` after the gain."""

    debug_name = "compressor"

    def __init__(
        self,
        threshold_db: float = -24.0,
        ratio: float = 4.0,
        attack_secs: float = 0.01,
        release_secs: float = 0.1,
        makeup_db: float = 0.0,
        knee_db: float = 6.0,
    ):
        self._threshold_db = float(threshold_db)
        self._ratio = float(ratio)
        self._attack_secs = float(attack_secs)
        self._release_secs = float(release_secs)
        self._makeup_db = float(makeup_db)
        self._knee_db = float(knee_db)

    def set_threshold_db(self, v: float):
        self._threshold_db = float(v)

    def set_ratio(self, v: float):
        self._ratio = float(v)

    def set_attack_secs(self, v: float):
        self._attack_secs = float(v)

    def set_release_secs(self, v: float):
        self._release_secs = float(v)

    def set_makeup_db(self, v: float):
        self._makeup_db = float(v)

    def set_knee_db(self, v: float):
        self._knee_db = float(v)

    def info(self) -> AudioNodeInfo:
        return AudioNodeInfo(1, MAX_PORTS, 1, MAX_PORTS)

    def activate(self, sample_rate, max_block_frames, num_inputs, num_outputs):
        if num_inputs != num_outputs:
            raise NodeActivationError(
                "CompressorNode requires num_inputs == num_outputs; got "
                f"{num_inputs} in, {num_outputs} out"
            )
        return CompressorProcessor(
            self, sample_rate, max_block_frames, num_inputs, num_outputs
        )


class LimiterProcessor(NodeProcessor):
    def __init__(self, node, sample_rate, max_block_frames, num_inputs, num_outputs):
        super().__init__(sample_rate, max_block_frames, num_inputs, num_outputs)
        self._node = node
        self.lookahead = max(1, int(round(node._lookahead_secs * sample_rate)))

    def group_key(self):
        return (self.lookahead,)  # state shapes depend on the lookahead

    def init_state(self):
        la = self.lookahead
        return {
            # the delayed dry signal (the lookahead's latency line)
            "delay": torch.zeros((self.num_inputs, la), dtype=torch.float32),
            # |x| tail, so the sliding window spans block boundaries
            "level_tail": torch.zeros((la,), dtype=torch.float32),
            # smoothed gain; starts at unity (0 would fade the stream in)
            "env": torch.ones((), dtype=torch.float32),
        }

    def collect_params(self):
        n = self._node
        return {
            "ceiling": np.float32(db_to_gain(np.float32(n._ceiling_db))),
            "rel_b": np.float32(_coef(n._release_secs, self.sample_rate)),
        }

    def kernel(self, params, state, inputs, in_mask, info):
        la = self.lookahead
        frames = inputs.shape[-1]
        # the future maximum over the lookahead window, per sample of the
        # delayed stream: delayed[t] pairs with max(|x|[t .. t+la])
        level_seq = torch.cat([state["level_tail"], _channel_level(inputs)], dim=-1)
        peak = sliding_max(level_seq, la + 1)  # [..., F]
        # the gain that keeps the peak at the ceiling; attack is instant (the
        # window looked ahead), release recovers with a one-pole
        need = torch.clamp_max(
            _per_frame(params["ceiling"]) / torch.clamp_min(peak, 1e-9), 1.0)
        (env_last,), gain = scan_lanes(LIMITER, need, (state["env"],),
                                       (params["rel_b"],))
        delayed = torch.cat([state["delay"], inputs], dim=-1)
        out_mask = in_mask & (state["delay"] == 0.0).all(dim=-1)
        y = gate(delayed[..., :frames] * gain[..., None, :], out_mask)
        return (
            y,
            {
                "delay": delayed[..., frames:],
                "level_tail": level_seq[..., frames:],
                "env": env_last,
            },
            out_mask,
        )


class LimiterNode(AudioNode):
    """Lookahead brickwall limiter (channel-linked).  It delays its path by
    ``lookahead_secs`` (compensate parallel dry paths with
    ``DelayCompNode``); the attack is instant through the lookahead window,
    the release a one-pole."""

    debug_name = "limiter"

    def __init__(
        self,
        ceiling_db: float = -1.0,
        lookahead_secs: float = 0.005,
        release_secs: float = 0.05,
    ):
        self._ceiling_db = float(ceiling_db)
        self._lookahead_secs = max(float(lookahead_secs), 0.0)
        self._release_secs = float(release_secs)

    def set_ceiling_db(self, v: float):
        self._ceiling_db = float(v)

    def set_release_secs(self, v: float):
        self._release_secs = float(v)

    def latency_frames(self, sample_rate: int) -> int:
        return max(1, int(round(self._lookahead_secs * sample_rate)))

    def info(self) -> AudioNodeInfo:
        return AudioNodeInfo(1, MAX_PORTS, 1, MAX_PORTS)

    def activate(self, sample_rate, max_block_frames, num_inputs, num_outputs):
        if num_inputs != num_outputs:
            raise NodeActivationError(
                "LimiterNode requires num_inputs == num_outputs; got "
                f"{num_inputs} in, {num_outputs} out"
            )
        return LimiterProcessor(
            self, sample_rate, max_block_frames, num_inputs, num_outputs
        )


class GateProcessor(NodeProcessor):
    def __init__(self, node, sample_rate, max_block_frames, num_inputs, num_outputs):
        super().__init__(sample_rate, max_block_frames, num_inputs, num_outputs)
        self._node = node

    def group_key(self):
        return ()  # all variation rides in params

    def init_state(self):
        return {
            # hysteresis latch: 1.0 while the gate is open
            "open": torch.zeros((), dtype=torch.float32),
            # hold countdown in samples (a float, as in the JAX package)
            "hold": torch.zeros((), dtype=torch.float32),
            # smoothed gain; starts fully closed
            "gain": torch.zeros((), dtype=torch.float32),
        }

    def collect_params(self):
        n = self._node
        close_db = n._threshold_db - max(n._hysteresis_db, 0.0)
        return {
            "open_lin": np.float32(db_to_gain(np.float32(n._threshold_db))),
            "close_lin": np.float32(db_to_gain(np.float32(close_db))),
            "floor": np.float32(db_to_gain(np.float32(min(n._range_db, 0.0)))),
            "att_b": np.float32(_coef(n._attack_secs, self.sample_rate)),
            "rel_b": np.float32(_coef(n._release_secs, self.sample_rate)),
            "hold_n": np.float32(max(n._hold_secs, 0.0) * self.sample_rate),
        }

    def kernel(self, params, state, inputs, in_mask, info):
        # channel-linked instantaneous detector: the loudest channel drives
        # the latch; hysteresis and hold keep it from chattering
        (opn, hold, g_last), gains = scan_lanes(
            GATE, _channel_level(inputs),
            (state["open"], state["hold"], state["gain"]),
            tuple(params[k] for k in ("open_lin", "close_lin", "floor", "att_b",
                                      "rel_b", "hold_n")))
        out_mask = in_mask  # gain never unsilences a silent input
        y = gate(inputs * gains[..., None, :], out_mask)
        return y, {"open": opn, "hold": hold, "gain": g_last}, out_mask


class GateNode(AudioNode):
    """Noise gate (channel-linked, hysteresis and hold).  Opens when the
    loudest channel crosses ``threshold_db``; closes, attenuating by
    ``range_db``, once the level has stayed below ``threshold_db −
    hysteresis_db`` for ``hold_secs``.  The gain ramps open over
    ``attack_secs`` and closed over ``release_secs``."""

    debug_name = "gate"

    def __init__(
        self,
        threshold_db: float = -50.0,
        range_db: float = -80.0,
        attack_secs: float = 0.001,
        release_secs: float = 0.1,
        hold_secs: float = 0.05,
        hysteresis_db: float = 6.0,
    ):
        self._threshold_db = float(threshold_db)
        self._range_db = min(float(range_db), 0.0)
        self._attack_secs = float(attack_secs)
        self._release_secs = float(release_secs)
        self._hold_secs = max(float(hold_secs), 0.0)
        self._hysteresis_db = max(float(hysteresis_db), 0.0)

    def set_threshold_db(self, v: float):
        self._threshold_db = float(v)

    def set_range_db(self, v: float):
        self._range_db = min(float(v), 0.0)

    def set_attack_secs(self, v: float):
        self._attack_secs = float(v)

    def set_release_secs(self, v: float):
        self._release_secs = float(v)

    def set_hold_secs(self, v: float):
        self._hold_secs = max(float(v), 0.0)

    def set_hysteresis_db(self, v: float):
        self._hysteresis_db = max(float(v), 0.0)

    def info(self) -> AudioNodeInfo:
        return AudioNodeInfo(1, MAX_PORTS, 1, MAX_PORTS)

    def activate(self, sample_rate, max_block_frames, num_inputs, num_outputs):
        if num_inputs != num_outputs:
            raise NodeActivationError(
                "GateNode requires num_inputs == num_outputs; got "
                f"{num_inputs} in, {num_outputs} out"
            )
        return GateProcessor(
            self, sample_rate, max_block_frames, num_inputs, num_outputs
        )


class DuckerProcessor(NodeProcessor):
    def __init__(self, node, sample_rate, max_block_frames, num_inputs, num_outputs):
        super().__init__(sample_rate, max_block_frames, num_inputs, num_outputs)
        self._node = node
        self.main_channels = num_outputs

    def group_key(self):
        return ()

    def init_state(self):
        return {"env": torch.zeros((), dtype=torch.float32)}

    def collect_params(self):
        n = self._node
        return {
            "threshold_db": np.float32(n._threshold_db),
            "duck_db": np.float32(n._duck_db),
            "att_b": np.float32(_coef(n._attack_secs, self.sample_rate)),
            "rel_b": np.float32(_coef(n._release_secs, self.sample_rate)),
        }

    def kernel(self, params, state, inputs, in_mask, info):
        m = self.main_channels
        main, side = inputs[..., :m, :], inputs[..., m:, :]
        # the sidechain's level drives the gain (dialogue over music)
        env, env_last = envelope_follow(
            _channel_level(side), state["env"], params["att_b"], params["rel_b"])
        # the full duck depth once the sidechain crosses the threshold,
        # proportional through a 10 dB soft region below it
        over = torch.clamp(
            (_gain_to_db(env) - _per_frame(params["threshold_db"]) + 10.0) / 10.0,
            0.0, 1.0)
        gain = _db_to_gain(_per_frame(params["duck_db"]) * over)
        out_mask = in_mask[..., :m]
        y = gate(main * gain[..., None, :], out_mask)
        return y, {"env": env_last}, out_mask


class DuckerNode(AudioNode):
    """Sidechain ducker: attenuates the main bus while the sidechain is hot.
    The first ``num_outputs`` inputs are the main bus, the rest the
    sidechain; ``duck_db`` applies once the sidechain exceeds
    ``threshold_db`` (ramped in over a 10 dB soft region below it)."""

    debug_name = "ducker"

    def __init__(
        self,
        threshold_db: float = -40.0,
        duck_db: float = -12.0,
        attack_secs: float = 0.01,
        release_secs: float = 0.3,
    ):
        self._threshold_db = float(threshold_db)
        self._duck_db = min(float(duck_db), 0.0)
        self._attack_secs = float(attack_secs)
        self._release_secs = float(release_secs)

    def set_threshold_db(self, v: float):
        self._threshold_db = float(v)

    def set_duck_db(self, v: float):
        self._duck_db = min(float(v), 0.0)

    def set_attack_secs(self, v: float):
        self._attack_secs = float(v)

    def set_release_secs(self, v: float):
        self._release_secs = float(v)

    def info(self) -> AudioNodeInfo:
        return AudioNodeInfo(2, MAX_PORTS, 1, MAX_PORTS)

    def activate(self, sample_rate, max_block_frames, num_inputs, num_outputs):
        if num_inputs <= num_outputs:
            raise NodeActivationError(
                "DuckerNode needs sidechain inputs beyond its main bus: "
                f"num_inputs ({num_inputs}) must exceed num_outputs "
                f"({num_outputs})"
            )
        return DuckerProcessor(
            self, sample_rate, max_block_frames, num_inputs, num_outputs
        )
