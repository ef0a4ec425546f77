"""firewheel_tpu_torch.core — shared leaf types (the ``firewheel-core``
analog): nodes, units, ranges, the parameter smoother, sample resources,
automation, events and the audio formats."""

from .silence_mask import SilenceMask, mask_from_bools, mask_to_bools
from .units import (
    db_to_gain,
    gain_to_db,
    db_to_gain_clamped_neg_100_db,
    gain_to_db_clamped_neg_100_db,
    percent_volume_to_raw_gain,
    raw_gain_to_percent_volume,
)
from .ranges import LinearRange, NormToFreqRange, NormToPowRange
from .smoother import (
    SmootherConfig,
    SmootherState,
    ParamSmoother,
    smoother_coeffs,
    smoother_init,
    smoother_reset,
    smoother_set_and_process,
    SMOOTHER_INACTIVE,
    SMOOTHER_ACTIVE,
    SMOOTHER_DEACTIVATING,
)
from .node import (
    AudioNode,
    AudioNodeInfo,
    BlockInfo,
    NodeProcessor,
    NodeActivationError,
    StreamStatus,
    MAX_PORTS,
)
from .sample_resource import (SampleResource, pcm_f32_to_i16,
                              pcm_i16_to_f32, pcm_u16_to_f32)
from .automation import AutomationCurve, Keyframe, ParamAutomator
from .events import NodeEvent, diff_counters
from .flac import FlacStreamReader, decode_flac
from .formats import (
    as_stream_reader,
    load_audio,
    open_stream_reader,
    register_format,
    register_stream_reader,
    supported_formats,
    supported_stream_formats,
)
from . import interleave

__all__ = [
    "SilenceMask",
    "mask_from_bools",
    "mask_to_bools",
    "db_to_gain",
    "gain_to_db",
    "db_to_gain_clamped_neg_100_db",
    "gain_to_db_clamped_neg_100_db",
    "percent_volume_to_raw_gain",
    "raw_gain_to_percent_volume",
    "LinearRange",
    "NormToFreqRange",
    "NormToPowRange",
    "SmootherConfig",
    "SmootherState",
    "ParamSmoother",
    "smoother_coeffs",
    "smoother_init",
    "smoother_reset",
    "smoother_set_and_process",
    "SMOOTHER_INACTIVE",
    "SMOOTHER_ACTIVE",
    "SMOOTHER_DEACTIVATING",
    "AudioNode",
    "AudioNodeInfo",
    "BlockInfo",
    "NodeProcessor",
    "NodeActivationError",
    "StreamStatus",
    "MAX_PORTS",
    "NodeEvent",
    "diff_counters",
    "SampleResource",
    "pcm_f32_to_i16",
    "pcm_i16_to_f32",
    "pcm_u16_to_f32",
    "interleave",
]
