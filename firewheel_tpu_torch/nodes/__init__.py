"""The node library (the nodes ported so far)."""

from .beep_test import BeepTestNode
from .delay import DelayCompNode, EchoNode
from .dummy import DummyAudioNode
from .filter import FilterNode, FilterType
from .hard_clip import HardClipNode
from .meter import DbMeterNode
from .pan import StereoPanNode
from .reverb import ConvolutionReverbNode
from .sampler import LoopRange, SamplerNode
from .sum import SumNode
from .volume import VolumeNode

__all__ = [
    "BeepTestNode",
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
    "StereoPanNode",
    "SumNode",
    "VolumeNode",
]
