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
package's files: either package restores the other's.  Clips play through
the granular sampler (``GranularSamplerNode``: tempo and pitch apart) and
stream from disk or a callback through ``StreamingSamplerNode``, whose
readers come from the format registry (``open_stream_reader``,
``load_audio``: WAV, AIFF, AU, FLAC, and MP3, Ogg Vorbis and Opus where the
system has the codec); ``MusicPlayer`` sequences, loops and crossfades
tracks over two streaming decks.  ``save_graph``/``load_graph`` write and
read the JAX package's scene files.  ``VoicePool`` fires sound effects
over a fixed bank of pooled samplers, which ``utils.MidiSequencer`` drives
from a MIDI file; ``utils.HttpWavStreamReader`` streams a WAV over HTTP.
Its kernels are CUDA for NVIDIA Hopper (``csrc/``).  It imports torch and numpy, never JAX.
"""

from .core.automation import AutomationCurve, Keyframe, ParamAutomator
from .core.events import NodeEvent
from .core.node import (
    AudioNode, AudioNodeInfo, BlockInfo, NodeActivationError, NodeProcessor,
    StreamStatus,
)
from .core.flac import FlacStreamReader, decode_flac
from .core.formats import (
    as_stream_reader, load_audio, open_stream_reader, register_format,
    register_stream_reader, supported_formats, supported_stream_formats,
)
from .core.sample_resource import SampleResource
from .core.silence_mask import SilenceMask
from .core.smoother import ParamSmoother, SmootherConfig, SmootherState
from .core.units import (
    db_to_gain, db_to_gain_clamped_neg_100_db, gain_to_db,
    gain_to_db_clamped_neg_100_db, percent_volume_to_raw_gain,
)
from .executor import ScheduleProgram, node_key
from .graph import (
    AudioGraph, AudioGraphConfig, CompiledSchedule, Edge, EdgeID, NodeID,
    SchedulePackage, load_graph, save_graph,
)
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
    BinauralSpatializerNode, CallbackStreamReader, ConvolutionReverbNode,
    DelayCompNode, GranularSamplerNode, LoopRange, SamplerNode,
    Spatializer3DNode, StreamingSamplerNode,
)
from .music import MusicPlayer
from .voice_pool import VoiceHandle, VoicePool
from .utils.flac_encode import encode_flac
from .utils.opus import OpusSink
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
from . import nodes, utils

__all__ = [
    "ArraySink",
    "as_stream_reader",
    "AudioGraph",
    "AudioGraphConfig",
    "AudioListener",
    "AudioNode",
    "AudioNodeInfo",
    "AutomationCurve",
    "available_output_devices",
    "BatchRenderer",
    "BinauralSpatializerNode",
    "BlockInfo",
    "CallbackStreamReader",
    "CompiledSchedule",
    "ConvolutionReverbNode",
    "db_to_gain",
    "db_to_gain_clamped_neg_100_db",
    "decode_flac",
    "DelayCompNode",
    "DeviceInfo",
    "Edge",
    "EdgeID",
    "effects_chain_graph",
    "encode_flac",
    "FirewheelCtx",
    "FlacStreamReader",
    "fx_palette_graph",
    "gain_to_db",
    "gain_to_db_clamped_neg_100_db",
    "GranularSamplerNode",
    "GraphContext",
    "GraphProcessor",
    "Keyframe",
    "load_audio",
    "load_checkpoint",
    "load_graph",
    "load_sharded_local",
    "LoopRange",
    "mastering_bus_graph",
    "mixer_graph",
    "MusicPlayer",
    "node_key",
    "NodeActivationError",
    "NodeEvent",
    "NodeID",
    "NodeProcessor",
    "nodes",
    "open_stream_reader",
    "OpusSink",
    "OutputStream",
    "ParamAutomator",
    "ParamSmoother",
    "percent_volume_to_raw_gain",
    "ProcessorStatus",
    "register_format",
    "register_stream_reader",
    "restore_into",
    "RingBuffer",
    "SampleResource",
    "SamplerNode",
    "save_checkpoint",
    "save_graph",
    "save_sharded_checkpoint",
    "SchedulePackage",
    "ScheduleProgram",
    "SessionHandle",
    "SessionServer",
    "SilenceMask",
    "SmootherConfig",
    "SmootherState",
    "spatial_scene_graph",
    "Spatializer3DNode",
    "SpatialScene",
    "StreamConfig",
    "StreamingSamplerNode",
    "StreamStatus",
    "supported_formats",
    "supported_stream_formats",
    "UpdateResult",
    "UpdateStatus",
    "utils",
    "VoiceHandle",
    "VoicePool",
    "WavSink",
]
