"""The node library (the main path's nodes so far)."""

from .beep_test import BeepTestNode
from .delay import EchoNode
from .dummy import DummyAudioNode
from .filter import FilterNode, FilterType
from .hard_clip import HardClipNode
from .meter import DbMeterNode
from .pan import StereoPanNode
from .sum import SumNode
from .volume import VolumeNode

__all__ = [
    "BeepTestNode",
    "DbMeterNode",
    "DummyAudioNode",
    "EchoNode",
    "FilterNode",
    "FilterType",
    "HardClipNode",
    "StereoPanNode",
    "SumNode",
    "VolumeNode",
]
