"""Generator nodes: noise sources and an audio-rate LFO.

PyTorch port of ``firewheel_tpu/nodes/generators.py``.

* **NoiseNode** draws white noise from the counter-based generator keyed on
  (seed, block start sample): stateless randomness, so re-rendering the
  stream with the same block partitioning reproduces it.  The bits are
  JAX's threefry2x32, computed by the port (``ops/noise.py``; K6 on the
  card), so both packages make the same noise from the same seed.  Pink
  noise filters the white stream through Paul Kellet's 3-pole
  approximation, carried as state (``ops/dynamics.py:scan_lanes``, K5 on
  the card).
* **LFONode** accumulates a 32-bit fixed-point phase like BeepTest and
  shapes it into sine, triangle, saw or square, scaled to ``offset +
  depth·wave``.
"""

from __future__ import annotations

import itertools

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
from ..core.units import db_to_gain
from ..ops.dynamics import PINK, scan_lanes
from ..ops.noise import noise_uniform
from .beep_test import _TAU_F32, _signed_phase, phase_inc_fixed

__all__ = ["NoiseNode", "NoiseProcessor", "LFONode", "LFOProcessor", "LFOShape"]

# default seeds: a construction-order counter, so two default NoiseNodes
# never share a stream (identical seeds would sum coherently)
_SEED_COUNTER = itertools.count(1)


def _flag_mask(flag: torch.Tensor, channels: int) -> torch.Tensor:
    """A per-instance silence flag ``bool[...]`` → ``bool[..., channels]``."""
    return flag[..., None].expand(*flag.shape, channels)


class NoiseProcessor(NodeProcessor):
    # no row in K2/K3 (nor in the JAX package's megakernel): a torch stage
    # on the hybrid lowering
    supports_megakernel = False

    def __init__(self, node, sample_rate, max_block_frames, num_inputs, num_outputs):
        super().__init__(sample_rate, max_block_frames, num_inputs, num_outputs)
        self._node = node

    def group_key(self):
        # the color is structural; everything else rides in params
        return (self._node._color,)

    def init_state(self):
        # Kellet pink filter poles (3 one-poles), per channel
        return {"pink": torch.zeros((self.num_outputs, 3), dtype=torch.float32)}

    def collect_params(self):
        n = self._node
        return {
            "gain": np.float32(db_to_gain(np.float32(n._gain_db))),
            "enabled": np.asarray(bool(n._enabled), bool),
            "seed": np.uint32(n._seed),
        }

    def kernel(self, params, state, inputs, in_mask, info):
        ch = self.num_outputs
        silent = ~params["enabled"]
        # stateless bits keyed on (seed, block start sample)
        white = noise_uniform(params["seed"], info.stream_sample, ch, inputs.shape[-1])
        if self._node._color != "pink":
            noise = white * params["gain"][..., None, None]
            return gate(noise, silent), {"pink": state["pink"]}, _flag_mask(silent, ch)
        # the poles [..., ch, 3] go to K5 and come back in that layout
        poles, pink = scan_lanes(PINK, white, state["pink"], ())
        noise = pink * params["gain"][..., None, None]
        return gate(noise, silent), {"pink": poles}, _flag_mask(silent, ch)


class NoiseNode(AudioNode):
    """White/pink noise generator with deterministic, seekable output."""

    debug_name = "noise"

    def __init__(
        self,
        color: str = "white",
        gain_db: float = -18.0,
        enabled: bool = True,
        seed: int | None = None,
    ):
        """``color`` is structural (whether the pink filter runs at all): to
        change it, re-add the node.  ``seed`` defaults to a construction-order
        counter, so independent default nodes are decorrelated; pass one for
        reproducible content."""
        if color not in ("white", "pink"):
            raise ValueError(f"color must be 'white' or 'pink', got {color!r}")
        self._color = color
        self._gain_db = float(gain_db)
        self._enabled = bool(enabled)
        self._seed = (next(_SEED_COUNTER) if seed is None else int(seed)) & 0xFFFFFFFF

    def set_enabled(self, v: bool):
        self._enabled = bool(v)

    def set_gain_db(self, v: float):
        self._gain_db = float(v)

    def info(self) -> AudioNodeInfo:
        return AudioNodeInfo(0, 0, 1, MAX_PORTS)

    def activate(self, sample_rate, max_block_frames, num_inputs, num_outputs):
        return NoiseProcessor(
            self, sample_rate, max_block_frames, num_inputs, num_outputs
        )


class LFOShape:
    SINE = "sine"
    TRIANGLE = "triangle"
    SAW = "saw"
    SQUARE = "square"


_SHAPES = (LFOShape.SINE, LFOShape.TRIANGLE, LFOShape.SAW, LFOShape.SQUARE)


class LFOProcessor(NodeProcessor):
    def __init__(self, node, sample_rate, max_block_frames, num_inputs, num_outputs):
        super().__init__(sample_rate, max_block_frames, num_inputs, num_outputs)
        self._node = node

    def group_key(self):
        return ()

    def init_state(self):
        return {"phase": torch.zeros((), dtype=torch.int64)}

    def collect_params(self):
        n = self._node
        return {
            "inc": np.uint32(phase_inc_fixed(n._freq_hz, self.sample_rate)),
            "depth": np.float32(n._depth),
            "offset": np.float32(n._offset),
            "shape": np.uint32(_SHAPES.index(n._shape)),
        }

    def kernel(self, params, state, inputs, in_mask, info):
        frames = inputs.shape[-1]
        inc, phase = params["inc"], state["phase"]
        k = torch.arange(frames, dtype=torch.int64, device=inc.device)
        ph = _signed_phase((phase[..., None] + k * inc[..., None]) & UINT32_MASK)
        sine = torch.sin(ph * _TAU_F32)
        tri = 1.0 - 4.0 * ph.abs()  # 1 at 0, -1 at ±0.5
        saw = 2.0 * ph
        square = torch.where(ph.abs() < 0.25, 1.0, -1.0)
        shape = params["shape"][..., None]
        wave = torch.where(shape == 0, sine, torch.where(
            shape == 1, tri, torch.where(shape == 2, saw, square)))
        out = params["offset"][..., None] + params["depth"][..., None] * wave
        y = out[..., None, :].expand(*out.shape[:-1], self.num_outputs, frames)
        new_phase = (phase + frames * inc) & UINT32_MASK
        out_mask = torch.zeros(out.shape[:-1] + (self.num_outputs,), dtype=torch.bool,
                               device=out.device)
        return y, {"phase": new_phase}, out_mask


class LFONode(AudioNode):
    """Audio-rate low-frequency oscillator: ``offset + depth·wave``.  Wire it
    into any audio input, or read it back per block for control-rate
    modulation."""

    debug_name = "lfo"

    def __init__(
        self,
        shape: str = LFOShape.SINE,
        freq_hz: float = 1.0,
        depth: float = 1.0,
        offset: float = 0.0,
    ):
        self.set_shape(shape)
        self._freq_hz = float(freq_hz)
        self._depth = float(depth)
        self._offset = float(offset)

    def set_freq_hz(self, v: float):
        self._freq_hz = float(v)

    def set_depth(self, v: float):
        self._depth = float(v)

    def set_offset(self, v: float):
        self._offset = float(v)

    def set_shape(self, shape: str):
        if shape not in _SHAPES:
            raise ValueError(f"shape must be one of {_SHAPES}, got {shape!r}")
        self._shape = shape

    def info(self) -> AudioNodeInfo:
        return AudioNodeInfo(0, 0, 1, MAX_PORTS)

    def activate(self, sample_rate, max_block_frames, num_inputs, num_outputs):
        return LFOProcessor(
            self, sample_rate, max_block_frames, num_inputs, num_outputs
        )
