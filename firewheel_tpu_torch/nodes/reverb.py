"""Convolutional reverb node: streaming convolution with a live IR.

PyTorch port of ``firewheel_tpu/nodes/reverb.py``.  The impulse response is
an array param; its engine form (taps, or head partition and tail spectra)
is computed once per IR on the host and cached.  Two engines, selected by
``method``:

* ``"fft"``: the zero-latency partitioned FFT (``ops/fft_conv.py``), the
  long-IR engine;
* ``"direct"``: the time-domain FIR sum (``ops/direct_conv.py``), the
  short-IR engine; its state is one input tail;
* ``"auto"`` (default) picks ``"direct"`` up to
  ``DIRECT_CONV_MAX_TAPS`` of padded IR, as the JAX package does.

The wet path rings while any of the engine's history is audible: the out
mask is set only where the input is silent and every history leaf is below
1e-12.
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
from ..ops.direct_conv import (
    DIRECT_CONV_MAX_TAPS,
    direct_conv_step,
    direct_hist_init,
)
from ..ops.fft_conv import conv_partition_ir, conv_state_init, conv_step

__all__ = ["ConvolutionReverbNode", "ConvolutionReverbProcessor"]

_QUIET_F32 = float(np.float32(1e-12))


def _quiet(t: torch.Tensor, dims) -> torch.Tensor:
    """``all(|t| < 1e-12)`` over ``dims``."""
    return torch.all(torch.abs(t) < _QUIET_F32, dim=dims)


class ConvolutionReverbProcessor(NodeProcessor):
    supports_megakernel = False  # the conv engines have no device function

    def __init__(self, node, sample_rate, max_block_frames, num_inputs, num_outputs):
        super().__init__(sample_rate, max_block_frames, num_inputs, num_outputs)
        self._node = node
        self._h_cache = None
        self._h_cache_src = None
        self._partitions = max(1, -(-node.ir_frames() // max_block_frames))
        method = node.method
        if method == "auto":
            method = "direct" if self._capacity() <= DIRECT_CONV_MAX_TAPS else "fft"
        self._method = method

    def _capacity(self) -> int:
        return self._partitions * self.max_block_frames

    def _padded_ir(self):
        """The IR zero-padded to the activated capacity (same-length swaps
        keep every shape)."""
        ir = np.atleast_2d(np.asarray(self._node._ir, np.float32))
        cap = self._capacity()
        if ir.shape[-1] > cap:
            raise ValueError(
                f"new IR ({ir.shape[-1]} frames) exceeds the activated "
                f"capacity ({cap} frames); re-add the node (or activate "
                "with the longest IR first) to grow the delay line"
            )
        if ir.shape[-1] < cap:
            ir = np.pad(ir, ((0, 0), (0, cap - ir.shape[-1])))
        return ir

    def _spectra(self):
        node = self._node
        if self._h_cache_src is not node._ir:
            ir = self._padded_ir()
            if self._method == "direct":
                self._h_cache = ir  # taps verbatim
            else:
                self._h_cache = conv_partition_ir(ir, self.max_block_frames)
            self._h_cache_src = node._ir
        return self._h_cache

    def group_key(self):
        # state and param shapes depend on the engine, the partition count
        # and the IR's channels
        return (self._method, self._partitions, self._node._ir.shape[0])

    def init_state(self):
        if self._method == "direct":
            return {"hist": direct_hist_init(self.num_inputs, self._capacity())}
        return conv_state_init(self._partitions, self.num_inputs,
                               self.max_block_frames)

    def collect_params(self):
        base = {
            "wet": np.float32(self._node.wet()),
            "dry": np.float32(self._node.dry()),
        }
        if self._method == "direct":
            base["taps"] = self._spectra()
        else:
            base["h_head"], base["H_tail"] = self._spectra()
        return base

    def kernel(self, params, state, inputs, in_mask, info):
        if self._method == "direct":
            wet, hist = direct_conv_step(inputs, state["hist"], params["taps"])
            new_state = {"hist": hist}
            line_quiet = _quiet(state["hist"], -1)
        else:
            wet, new_state = conv_step(inputs, state, params["h_head"],
                                       params["H_tail"])
            line_quiet = _quiet(state["hist"], -1) & _quiet(state["tailbuf"], -1)
            if state["fdl"].shape[-4] > 0:
                # fdl is f32[..., P-1, ch, bins, 2]
                line_quiet = line_quiet & _quiet(state["fdl"], (-4, -2, -1))
        y = (expand_like(params["dry"], inputs) * inputs
             + expand_like(params["wet"], inputs) * wet)
        out_mask = in_mask & line_quiet
        return gate(y, out_mask), new_state, out_mask


class ConvolutionReverbNode(AudioNode):
    debug_name = "convolution_reverb"

    def __init__(self, ir, wet: float = 0.3, dry: float = 1.0,
                 method: str = "auto"):
        """``ir``: impulse response, ``[frames]`` (shared by the channels) or
        ``[channels, frames]``.  ``method``: ``"auto"``, ``"direct"`` or
        ``"fft"`` (see the module docstring)."""
        assert method in ("auto", "direct", "fft"), method
        self.method = method
        self._ir = np.atleast_2d(np.array(ir, np.float32, copy=True))
        self._wet = max(float(wet), 0.0)
        self._dry = max(float(dry), 0.0)

    def ir_frames(self) -> int:
        return self._ir.shape[-1]

    def set_ir(self, ir):
        """Swap the impulse response (copied: the engine cache keys on the
        array's identity)."""
        self._ir = np.atleast_2d(np.array(ir, np.float32, copy=True))

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
                "ConvolutionReverbNode requires num_inputs == num_outputs; "
                f"got {num_inputs} in, {num_outputs} out"
            )
        ir_ch = self._ir.shape[0]
        if ir_ch not in (1, num_inputs):
            raise NodeActivationError(
                f"IR has {ir_ch} channels; expected 1 or {num_inputs}"
            )
        return ConvolutionReverbProcessor(
            self, sample_rate, max_block_frames, num_inputs, num_outputs
        )
