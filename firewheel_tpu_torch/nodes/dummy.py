"""Dummy (no-op) node: the graph_in/graph_out sentinels' processor.

PyTorch port of ``firewheel_tpu/nodes/dummy.py`` (reference:
``basic_nodes/dummy.rs:5-48``): outputs zeros with a not-silent mask.
"""

from __future__ import annotations

from ..core.node import AudioNode, AudioNodeInfo, NodeProcessor, MAX_PORTS

__all__ = ["DummyAudioNode", "DummyProcessor"]


class DummyProcessor(NodeProcessor):
    def group_key(self):
        return ()

    def kernel(self, params, state, inputs, in_mask, info):
        lead = inputs.shape[:-2]
        outputs = inputs.new_zeros(lead + (self.num_outputs, inputs.shape[-1]))
        out_mask = in_mask.new_zeros(lead + (self.num_outputs,))
        return outputs, state, out_mask


class DummyAudioNode(AudioNode):
    debug_name = "dummy"

    def info(self) -> AudioNodeInfo:
        return AudioNodeInfo(
            num_max_supported_inputs=MAX_PORTS,
            num_max_supported_outputs=MAX_PORTS,
        )

    def activate(self, sample_rate, max_block_frames, num_inputs, num_outputs):
        return DummyProcessor(sample_rate, max_block_frames, num_inputs, num_outputs)
