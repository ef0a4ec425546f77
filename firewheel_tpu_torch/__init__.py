"""firewheel_tpu_torch — the PyTorch/CUDA port of firewheel_tpu.

The port runs the JAX package's batched renderers on torch tensors: the
64-node mixer (eagerly, or as one megakernel launch a chunk) and the
effects chain (sampler → filter → echo → clip → reverb, through the hybrid
lowering's megakernel islands).  Its streaming engine (``FirewheelCtx`` →
``GraphContext`` → ``GraphProcessor``) renders one graph live, buffer by
buffer, with live edits and per-block param timelines.  Its kernels are
CUDA for NVIDIA Hopper (``csrc/``).  It imports torch and numpy, never JAX.
"""

from .core.automation import AutomationCurve, Keyframe, ParamAutomator
from .core.events import NodeEvent
from .core.node import (
    AudioNode, AudioNodeInfo, BlockInfo, NodeActivationError, NodeProcessor,
    StreamStatus,
)
from .core.sample_resource import SampleResource
from .core.silence_mask import SilenceMask
from .executor import ScheduleProgram, node_key
from .graph import AudioGraph, AudioGraphConfig
from .context import GraphContext, UpdateResult, UpdateStatus
from .processor import GraphProcessor, ProcessorStatus
from .backend import (
    ArraySink,
    DeviceInfo,
    FirewheelCtx,
    OutputStream,
    RingBuffer,
    StreamConfig,
    WavSink,
    available_output_devices,
)
from .mixer import effects_chain_graph, mixer_graph
from .nodes import ConvolutionReverbNode, LoopRange, SamplerNode
from .parallel import BatchRenderer

__all__ = [
    "ArraySink",
    "AudioGraph",
    "AudioGraphConfig",
    "AudioNode",
    "AudioNodeInfo",
    "AutomationCurve",
    "BatchRenderer",
    "BlockInfo",
    "ConvolutionReverbNode",
    "DeviceInfo",
    "FirewheelCtx",
    "GraphContext",
    "GraphProcessor",
    "Keyframe",
    "LoopRange",
    "NodeActivationError",
    "NodeEvent",
    "NodeProcessor",
    "OutputStream",
    "ParamAutomator",
    "ProcessorStatus",
    "RingBuffer",
    "SampleResource",
    "SamplerNode",
    "ScheduleProgram",
    "SilenceMask",
    "StreamConfig",
    "StreamStatus",
    "UpdateResult",
    "UpdateStatus",
    "WavSink",
    "available_output_devices",
    "effects_chain_graph",
    "mixer_graph",
    "node_key",
]
