"""The node library (the nodes ported so far)."""

from .beep_test import BeepTestNode
from .binaural import BinauralSpatializerNode
from .delay import DelayCompNode, EchoNode
from .dummy import DummyAudioNode
from .filter import FilterNode, FilterType
from .hard_clip import HardClipNode
from .meter import DbMeterNode
from .pan import StereoPanNode
from .reverb import ConvolutionReverbNode
from .sampler import LoopRange, SamplerNode
from .spatial import Spatializer3DNode
from .sum import SumNode
from .volume import VolumeNode

__all__ = [
    "BeepTestNode",
    "BinauralSpatializerNode",
    "ConvolutionReverbNode",
    "DbMeterNode",
    "DelayCompNode",
    "DummyAudioNode",
    "EchoNode",
    "FilterNode",
    "FilterType",
    "HardClipNode",
    "LoopRange",
    "SamplerNode",
    "Spatializer3DNode",
    "StereoPanNode",
    "SumNode",
    "VolumeNode",
]
