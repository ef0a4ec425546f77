"""The node library (the nodes ported so far)."""

from .beep_test import BeepTestNode
from .binaural import BinauralSpatializerNode
from .delay import DelayCompNode, EchoNode
from .dummy import DummyAudioNode
from .dynamics import CompressorNode, DuckerNode, GateNode, LimiterNode
from .filter import FilterNode, FilterType
from .fir import FirFilterNode, design_windowed_sinc
from .generators import LFONode, LFOShape, NoiseNode
from .hard_clip import HardClipNode
from .loudness import IntegratedLoudness, LoudnessMeterNode
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
    "CompressorNode",
    "ConvolutionReverbNode",
    "DbMeterNode",
    "DelayCompNode",
    "DuckerNode",
    "DummyAudioNode",
    "EchoNode",
    "FilterNode",
    "FilterType",
    "FirFilterNode",
    "GateNode",
    "HardClipNode",
    "IntegratedLoudness",
    "LFONode",
    "LFOShape",
    "LimiterNode",
    "LoopRange",
    "LoudnessMeterNode",
    "NoiseNode",
    "SamplerNode",
    "Spatializer3DNode",
    "StereoPanNode",
    "SumNode",
    "VolumeNode",
    "design_windowed_sinc",
]
