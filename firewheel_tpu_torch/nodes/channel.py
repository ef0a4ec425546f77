"""Channel-layout adapters: mono→stereo and stereo→mono.

PyTorch port of ``firewheel_tpu/nodes/channel.py`` (the reference's
``basic_nodes/mono_to_stereo.rs`` and ``stereo_to_mono.rs``).  Mono→stereo
duplicates channel 0; stereo→mono is ``(L+R)·0.5``.
"""

from __future__ import annotations

from ..core.node import AudioNode, AudioNodeInfo, NodeProcessor, gate

__all__ = [
    "MonoToStereoNode",
    "MonoToStereoProcessor",
    "StereoToMonoNode",
    "StereoToMonoProcessor",
]


class MonoToStereoProcessor(NodeProcessor):
    def group_key(self):
        return ()

    def kernel(self, params, state, inputs, in_mask, info):
        silent = in_mask[..., 0]
        row = gate(inputs[..., 0, :], silent)
        out = row[..., None, :].expand(*row.shape[:-1], 2, row.shape[-1])
        out_mask = silent[..., None].expand(*silent.shape, 2)
        return out, state, out_mask


class MonoToStereoNode(AudioNode):
    debug_name = "mono_to_stereo"

    def info(self) -> AudioNodeInfo:
        return AudioNodeInfo(
            num_min_supported_inputs=1,
            num_max_supported_inputs=1,
            num_min_supported_outputs=2,
            num_max_supported_outputs=2,
        )

    def activate(self, sample_rate, max_block_frames, num_inputs, num_outputs):
        return MonoToStereoProcessor(
            sample_rate, max_block_frames, num_inputs, num_outputs
        )


class StereoToMonoProcessor(NodeProcessor):
    def group_key(self):
        return ()

    def kernel(self, params, state, inputs, in_mask, info):
        all_silent = in_mask[..., :2].all(dim=-1)
        mono = (inputs[..., 0, :] + inputs[..., 1, :]) * 0.5
        out = gate(mono, all_silent)[..., None, :]
        return out, state, all_silent[..., None]


class StereoToMonoNode(AudioNode):
    debug_name = "stereo_to_mono"

    def info(self) -> AudioNodeInfo:
        return AudioNodeInfo(
            num_min_supported_inputs=2,
            num_max_supported_inputs=2,
            num_min_supported_outputs=1,
            num_max_supported_outputs=1,
        )

    def activate(self, sample_rate, max_block_frames, num_inputs, num_outputs):
        return StereoToMonoProcessor(
            sample_rate, max_block_frames, num_inputs, num_outputs
        )
