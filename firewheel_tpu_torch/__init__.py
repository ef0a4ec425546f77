"""firewheel_tpu_torch — the PyTorch/CUDA port of firewheel_tpu.

The port runs the JAX package's batched renderers on torch tensors: the
64-node mixer (eagerly, or as one megakernel launch a chunk) and the
effects chain (sampler → filter → echo → clip → reverb, through the hybrid
lowering's megakernel islands).  Its kernels are CUDA for NVIDIA Hopper
(``csrc/``).  It imports torch and numpy, never JAX.
"""

from .core.node import AudioNode, AudioNodeInfo, BlockInfo, NodeProcessor
from .core.sample_resource import SampleResource
from .executor import ScheduleProgram, node_key
from .graph import AudioGraph, AudioGraphConfig
from .mixer import effects_chain_graph, mixer_graph
from .nodes import ConvolutionReverbNode, LoopRange, SamplerNode
from .parallel import BatchRenderer

__all__ = [
    "AudioGraph",
    "AudioGraphConfig",
    "AudioNode",
    "AudioNodeInfo",
    "BatchRenderer",
    "BlockInfo",
    "ConvolutionReverbNode",
    "LoopRange",
    "NodeProcessor",
    "SampleResource",
    "SamplerNode",
    "ScheduleProgram",
    "effects_chain_graph",
    "mixer_graph",
    "node_key",
]
