"""Sum node: N→M channel summation (N must be a multiple of M).

PyTorch port of ``firewheel_tpu/nodes/sum.py`` (reference:
``basic_nodes/sum.rs:3-142``).  ``out[ch] = sum_k in[k*M + ch]``,
accumulated left to right as the reference does, for float32
reproducibility (so no ``torch.sum``).  All-silent → silence and an
all-silent mask; N==M → copy with mask passthrough; summing → the out mask
stays not-silent.
"""

from __future__ import annotations

from ..core.node import (
    gate,
    AudioNode,
    AudioNodeInfo,
    NodeActivationError,
    NodeProcessor,
    MAX_PORTS,
)

__all__ = ["SumNode", "SumProcessor"]


class SumProcessor(NodeProcessor):
    def __init__(self, sample_rate, max_block_frames, num_inputs, num_outputs):
        super().__init__(sample_rate, max_block_frames, num_inputs, num_outputs)
        self.num_in_ports = num_inputs // num_outputs

    def group_key(self):
        return ()

    def kernel(self, params, state, inputs, in_mask, info):
        m = self.num_outputs
        all_silent = in_mask.all(dim=-1)

        if self.num_in_ports == 1:
            out = inputs
            out_mask = all_silent[..., None] | in_mask
        else:
            # Left-to-right accumulation matches sum.rs:67-133 rounding order.
            out = inputs[..., 0:m, :]
            for k in range(1, self.num_in_ports):
                out = out + inputs[..., k * m : (k + 1) * m, :]
            out_mask = all_silent[..., None].expand(*all_silent.shape, m)

        return gate(out, all_silent), state, out_mask


class SumNode(AudioNode):

    #: silence in => silence out, no self-generated signal
    silence_transparent = True
    debug_name = "sum"

    def info(self) -> AudioNodeInfo:
        return AudioNodeInfo(
            num_min_supported_inputs=1,
            num_max_supported_inputs=MAX_PORTS,
            num_min_supported_outputs=1,
            num_max_supported_outputs=MAX_PORTS,
        )

    def activate(self, sample_rate, max_block_frames, num_inputs, num_outputs):
        if num_outputs == 0 or num_inputs % num_outputs != 0:
            raise NodeActivationError(
                "The number of inputs on a SumNode must be a multiple of the "
                f"number of outputs. Got num_inputs: {num_inputs}, "
                f"num_outputs: {num_outputs}"
            )
        return SumProcessor(sample_rate, max_block_frames, num_inputs, num_outputs)
