"""firewheel_tpu_torch — the PyTorch/CUDA port of firewheel_tpu.

The port runs the JAX package's batched renderers on torch tensors: the
64-node mixer (eagerly, or as one megakernel launch a chunk) and the
effects chain (sampler → filter → echo → clip → reverb, through the hybrid
lowering's megakernel islands).  A ``SessionServer`` multiplexes client
sessions onto one batch renderer: it connects, updates, resets and
disconnects sessions, ships each chunk to the host as interleaved pcm16
or as IMA ADPCM rows (``output_format="adpcm4"``) while the next one
renders, polls per-session device events, and
checkpoints and restores the whole fleet.  Its streaming engine
(``FirewheelCtx`` → ``GraphContext`` → ``GraphProcessor``) renders one
graph live, buffer by buffer, with live edits, per-block param timelines,
checkpoints, and latency compensation (``graph/latency.py`` splices
``DelayCompNode``s onto early edges).  The spatial scene (BASELINE config
5: ``Spatializer3DNode`` with doppler and occlusion,
``BinauralSpatializerNode``, and ``SpatialScene``'s world-space emitters
around an ``AudioListener``) renders on every path: streamed, batched,
and through the megakernel's spatializer row.  The mastering bus
(``mastering_bus_graph``: pink noise ducked under a dialogue beep, a
compressor, a 255-tap FIR shelf, a lookahead limiter and an EBU R128
loudness meter) renders streamed and batched, and so does the FX palette
of the interactive editor (``fx_palette_graph``: a parametric EQ,
chorus, flanger, tremolo, waveshapers, a gate, stereo width and a pitch
shifter).  Checkpoints are the JAX
package's files: either package restores the other's.  Its kernels are CUDA for
NVIDIA Hopper (``csrc/``).  It imports torch and numpy, never JAX.
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
from .mixer import (
    effects_chain_graph, fx_palette_graph, mastering_bus_graph, mixer_graph,
    spatial_scene_graph,
)
from .nodes import (
    BinauralSpatializerNode, ConvolutionReverbNode, DelayCompNode, LoopRange,
    SamplerNode, Spatializer3DNode,
)
from .scene3d import AudioListener, SpatialScene
from .parallel import BatchRenderer
from .serving import SessionHandle, SessionServer
from .checkpoint import (
    load_checkpoint,
    load_sharded_local,
    restore_into,
    save_checkpoint,
    save_sharded_checkpoint,
)

__all__ = [
    "ArraySink",
    "AudioGraph",
    "AudioGraphConfig",
    "AudioListener",
    "AudioNode",
    "AudioNodeInfo",
    "AutomationCurve",
    "BatchRenderer",
    "BinauralSpatializerNode",
    "BlockInfo",
    "ConvolutionReverbNode",
    "DelayCompNode",
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
    "SessionHandle",
    "SessionServer",
    "SilenceMask",
    "SpatialScene",
    "Spatializer3DNode",
    "StreamConfig",
    "StreamStatus",
    "UpdateResult",
    "UpdateStatus",
    "WavSink",
    "available_output_devices",
    "effects_chain_graph",
    "fx_palette_graph",
    "mastering_bus_graph",
    "load_checkpoint",
    "load_sharded_local",
    "mixer_graph",
    "node_key",
    "restore_into",
    "save_checkpoint",
    "save_sharded_checkpoint",
    "spatial_scene_graph",
]
