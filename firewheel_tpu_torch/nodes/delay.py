"""Delay nodes: sample-accurate delay compensation and feedback echo.

PyTorch port of ``firewheel_tpu/nodes/delay.py``:

* :class:`DelayCompNode` — a pure N-frame delay (latency alignment; the
  latency pass, ``graph/latency.py``, splices it onto early edges).  Its
  row in the megakernel keeps the line in device memory, as the echo's.
* :class:`EchoNode` — feedback echo ``y = dry·x + wet·e``, ``e[n] = x[n-D]
  + fb·e[n-D]``.  The delay must be ≥ the engine block size.

Both lines keep the JAX package's layout (oldest sample first, shifted by
one block every block), so state converts between the packages as a plain
copy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.node import (
    expand_like,
    gate,
    AudioNode,
    AudioNodeInfo,
    NodeActivationError,
    NodeProcessor,
    MAX_PORTS,
)
from ..ops.delay import comb_init, delay_init, delay_step

__all__ = ["DelayCompNode", "DelayCompProcessor", "EchoNode", "EchoProcessor"]

_QUIET_F32 = float(np.float32(1e-10))


class DelayCompProcessor(NodeProcessor):
    def __init__(self, delay_frames, sample_rate, max_block_frames, num_inputs, num_outputs):
        super().__init__(sample_rate, max_block_frames, num_inputs, num_outputs)
        self.delay_frames = delay_frames

    def group_key(self):
        return (self.delay_frames,)

    def init_state(self):
        return {"buf": delay_init(self.num_inputs, self.delay_frames)}

    def kernel(self, params, state, inputs, in_mask, info):
        y, buf = delay_step(inputs, state["buf"])
        # a freshly silent input still drains the delay line; the output is
        # silent only when the line holds silence too
        if self.delay_frames > 0:
            line_quiet = (torch.abs(state["buf"]) < _QUIET_F32).all(dim=-1)
        else:
            line_quiet = torch.ones_like(in_mask)
        return y, {"buf": buf}, in_mask & line_quiet


class DelayCompNode(AudioNode):
    debug_name = "delay_comp"

    def __init__(self, delay_frames: int = 0, delay_secs: float | None = None):
        if delay_frames < 0:
            raise ValueError(f"delay_frames must be >= 0, got {delay_frames}")
        self._delay_frames = int(delay_frames)
        self._delay_secs = delay_secs

    def latency_frames(self, sample_rate: int) -> int:
        # a pure delay IS latency: reporting it makes compensate_latency
        # account for manual alignment delays (and its own insertions)
        if self._delay_secs is not None:
            return int(round(self._delay_secs * sample_rate))
        return self._delay_frames

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
                "DelayCompNode requires num_inputs == num_outputs; "
                f"got {num_inputs} in, {num_outputs} out"
            )
        return DelayCompProcessor(self.latency_frames(sample_rate), sample_rate,
                                  max_block_frames, num_inputs, num_outputs)


class EchoProcessor(NodeProcessor):
    def __init__(self, node, delay_frames, sample_rate, max_block_frames, num_inputs, num_outputs):
        super().__init__(sample_rate, max_block_frames, num_inputs, num_outputs)
        self._node = node
        self.delay_frames = delay_frames

    def group_key(self):
        return (self.delay_frames,)

    def init_state(self):
        return {"line": comb_init(self.num_inputs, self.delay_frames)}

    def collect_params(self):
        return {
            "feedback": np.float32(self._node.feedback()),
            "wet": np.float32(self._node.wet()),
            "dry": np.float32(self._node.dry()),
        }

    def kernel(self, params, state, inputs, in_mask, info):
        f = inputs.shape[-1]
        line = state["line"]
        delayed_echo = line[..., :f]
        # signal entering the line: input + feedback * delayed echo
        echo = inputs + expand_like(params["feedback"], inputs) * delayed_echo
        new_line = torch.cat([line[..., f:], echo], dim=-1)
        y = (
            expand_like(params["dry"], inputs) * inputs
            + expand_like(params["wet"], inputs) * delayed_echo
        )

        line_quiet = (torch.abs(line) < _QUIET_F32).all(dim=-1)
        out_mask = in_mask & line_quiet
        return gate(y, out_mask), {"line": new_line}, out_mask


class EchoNode(AudioNode):
    debug_name = "echo"

    def __init__(
        self,
        delay_secs: float = 0.25,
        feedback: float = 0.4,
        wet: float = 0.5,
        dry: float = 1.0,
    ):
        self._delay_secs = float(delay_secs)
        self._feedback = float(np.clip(feedback, 0.0, 0.99))
        self._wet = max(float(wet), 0.0)
        self._dry = max(float(dry), 0.0)

    def feedback(self) -> float:
        return self._feedback

    def set_feedback(self, fb: float):
        self._feedback = float(np.clip(fb, 0.0, 0.99))

    def wet(self) -> float:
        return self._wet

    def set_wet(self, wet: float):
        self._wet = max(float(wet), 0.0)

    def dry(self) -> float:
        return self._dry

    def set_dry(self, dry: float):
        self._dry = max(float(dry), 0.0)

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
                "EchoNode requires num_inputs == num_outputs; "
                f"got {num_inputs} in, {num_outputs} out"
            )
        delay_frames = int(round(self._delay_secs * sample_rate))
        if delay_frames < max_block_frames:
            raise NodeActivationError(
                f"EchoNode delay ({delay_frames} frames) must be >= the "
                f"block size ({max_block_frames} frames)"
            )
        return EchoProcessor(
            self, delay_frames, sample_rate, max_block_frames, num_inputs, num_outputs
        )
