"""firewheel_tpu_torch — the PyTorch/CUDA port of firewheel_tpu.

The port runs the JAX package's main path — the batched 64-node mixer —
on torch tensors, with the sequential biquad as a CUDA kernel for NVIDIA
Hopper (``csrc/biquad.cu``).  It imports torch and numpy, never JAX.
"""

from .core.node import AudioNode, AudioNodeInfo, BlockInfo, NodeProcessor
from .executor import ScheduleProgram, node_key
from .graph import AudioGraph, AudioGraphConfig
from .mixer import mixer_graph
from .parallel import BatchRenderer

__all__ = [
    "AudioGraph",
    "AudioGraphConfig",
    "AudioNode",
    "AudioNodeInfo",
    "BatchRenderer",
    "BlockInfo",
    "NodeProcessor",
    "ScheduleProgram",
    "mixer_graph",
    "node_key",
]
