"""The node library (the nodes ported so far)."""

from .beep_test import BeepTestNode
from .binaural import BinauralSpatializerNode
from .channel import MonoToStereoNode, StereoToMonoNode
from .delay import DelayCompNode, EchoNode
from .dummy import DummyAudioNode, DummyProcessor
from .dynamics import CompressorNode, DuckerNode, GateNode, LimiterNode
from .eq import EQBand, ParametricEQNode
from .filter import FilterNode, FilterType
from .fir import FirFilterNode, design_windowed_sinc
from .generators import LFONode, LFOShape, NoiseNode
from .granular import GranularSamplerNode
from .hard_clip import HardClipNode
from .loudness import IntegratedLoudness, LoudnessMeterNode
from .meter import DbMeterNode
from .mod_effects import ModDelayNode, TremoloNode
from .pan import StereoPanNode
from .pitch_shift import PitchShiftNode
from .reverb import ConvolutionReverbNode
from .sampler import LoopRange, SamplerNode
from .spatial import Spatializer3DNode
from .stereo_width import StereoWidthNode
from .streaming_sampler import CallbackStreamReader, StreamingSamplerNode
from .sum import SumNode
from .volume import VolumeNode
from .waveshaper import WaveshaperNode

__all__ = [
    "BeepTestNode",
    "BinauralSpatializerNode",
    "CallbackStreamReader",
    "CompressorNode",
    "ConvolutionReverbNode",
    "DbMeterNode",
    "DelayCompNode",
    "DuckerNode",
    "DummyAudioNode",
    "DummyProcessor",
    "EQBand",
    "EchoNode",
    "FilterNode",
    "FilterType",
    "FirFilterNode",
    "GateNode",
    "GranularSamplerNode",
    "HardClipNode",
    "IntegratedLoudness",
    "LFONode",
    "LFOShape",
    "LimiterNode",
    "LoopRange",
    "LoudnessMeterNode",
    "ModDelayNode",
    "MonoToStereoNode",
    "NoiseNode",
    "ParametricEQNode",
    "PitchShiftNode",
    "SamplerNode",
    "Spatializer3DNode",
    "StereoPanNode",
    "StereoToMonoNode",
    "StereoWidthNode",
    "StreamingSamplerNode",
    "SumNode",
    "TremoloNode",
    "VolumeNode",
    "WaveshaperNode",
    "design_windowed_sinc",
]
