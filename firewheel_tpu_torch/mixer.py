"""The benchmark graphs: the batched 64-node mixer, the effects chain,
the spatial scene, and random graphs.

:func:`mixer_graph` mirrors ``__graft_entry__._mixer_graph``: 19 voices of
BeepTest → Volume → StereoPan, then Sum → lowpass Filter 8 kHz → Echo
0.25 s/fb 0.3 → HardClip → DbMeter → out, at 48 kHz stereo, 64 nodes with
the two sentinels.  :func:`effects_chain_graph` mirrors the graph that
``bench.py --hybrid`` times, and :func:`effects_chain_config4_graph` the
BASELINE config-4 graph of ``examples/effects_chain.py``: sampler → filter
→ echo → clip → convolution reverb.  :func:`spatial_scene_graph` builds
BASELINE config 5, the 266-node graph of ``examples/spatial_scene.py``
(128 beeps through 3D spatializers into group sums and a metered, clipped
master), and :func:`orbit_scene` its automation.  Node keys
(``repr(NodeID)``) come out identical to the JAX package's.
:func:`random_graph` builds seeded random DAGs of the mixer's nodes;
:func:`fuzz_graph` and :func:`fuzz_pooling_graph` build the JAX package's
differential fuzzer's DAGs over its whole palette (:data:`FUZZ_PALETTE`).
:func:`vary_params` and
:func:`vary_effects_params` give every instance of a batch its own params,
for holding two lowerings against each other; :func:`vary_spatial_params`
does so for the spatial scene.  :func:`voice_mixer_64_graph` builds
BASELINE config 3, the 64-voice resampling mixer of
``examples/voice_mixer_64.py`` (:func:`add_voice_mixer_64`), and
:func:`vary_voice_mixer_params` varies it per instance.
:func:`mastering_bus_graph` builds the
game-audio master chain of ``examples/mastering_bus.py`` (pink-noise music
ducked under a beep dialogue, compressor, 255-tap linear-phase FIR shelf,
lookahead limiter, loudness meter), and :func:`vary_mastering_params`
varies it per instance.  :func:`fx_palette_graph` builds the engine graph of
``examples/interactive_graph.py`` at its full width with every insert of
its master-bus FX palette in series (EQ, chorus, flanger, tremolo,
waveshaper, gate) and the rest of the FX nodes after them, and
:func:`vary_fx_params` varies it per instance.  :func:`voice_mix_programs`
splits the mixer for a ``VoiceParallelMixer``: one voice as its own
program, the bus as the master, and :func:`voice_snapshots` gives each
voice its own frequency, volume and pan.
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

from .core.automation import AutomationCurve
from .core.sample_resource import SampleResource
from .device import DEFAULT_DEVICE
from .executor import ScheduleProgram, node_key
from .graph import AudioGraph, AudioGraphConfig
from . import nodes as _NODES
from .core.units import db_to_gain, percent_volume_to_raw_gain
from .nodes.dynamics import CompressorProcessor, DuckerProcessor
from .nodes.eq import ParametricEQProcessor
from .nodes.filter import _DESIGNS
from .nodes.generators import NoiseProcessor
from .nodes.beep_test import BeepTestProcessor, phase_inc_fixed
from .nodes.mod_effects import ModDelayProcessor
from .nodes.pan import StereoPanProcessor
from .nodes.pitch_shift import PitchShiftProcessor
from .nodes.sampler import SamplerProcessor
from .nodes.spatial import Spatializer3DProcessor
from .nodes.stereo_width import StereoWidthProcessor
from .nodes.volume import VolumeProcessor
from .nodes.waveshaper import WaveshaperProcessor
from .nodes import (
    BeepTestNode,
    ConvolutionReverbNode,
    DbMeterNode,
    DummyAudioNode,
    EchoNode,
    FilterNode,
    FilterType,
    HardClipNode,
    SamplerNode,
    StereoPanNode,
    SumNode,
    VolumeNode,
)

__all__ = [
    "BLOCK", "FX_KINDS", "FX_VOICES", "SR", "add_effects_chain", "add_fx_palette",
    "EQ_GATE", "add_eq_gate", "add_fx_engine", "add_fx_voice", "add_mastering_bus",
    "add_mixer", "add_spatial_scene",
    "add_mix_bus", "add_voice", "add_voice_graph", "air_shelf_taps", "effects_chain_audio",
    "effects_chain_config4_graph", "effects_chain_graph", "eq_gate_graph", "fx_insert",
    "FUZZ_PALETTE", "FUZZ_POKES", "fuzz_graph", "fuzz_instance_params",
    "fuzz_pooling_graph",
    "fx_palette_graph", "mastering_bus_graph", "mixer_graph", "orbit_scene",
    "random_graph", "set_fx", "spatial_scene_graph", "vary_effects_params",
    "vary_fx_params",
    "vary_mastering_params", "vary_params", "vary_spatial_params",
    "vary_voice_mixer_params", "voice_mix_programs", "voice_mixer_64_graph",
    "voice_mixer_clip", "voice_snapshots", "add_voice_mixer_64",
]

SR = 48000
BLOCK = 128


def _add_voice_chain(g: AudioGraph, beep, volume, pan, dst, port: int) -> tuple:
    """Add the voice ``beep`` → ``volume`` → ``pan`` (stereo nodes) to
    ``g``, into inputs ``port, port + 1`` of ``dst`` → the three ids."""
    ids = (g.add_node(0, 2, beep), g.add_node(2, 2, volume), g.add_node(2, 2, pan))
    for src, d, p in ((ids[0], ids[1], 0), (ids[1], ids[2], 0), (ids[2], dst, port)):
        g.connect(src, 0, d, p)
        g.connect(src, 1, d, p + 1)
    return ids


def _add_bus_chain(g: AudioGraph, src, filter_backend: str, n,
                   state_light: bool = False) -> None:
    """Add the mixer's bus to ``g``: ``src`` → lowpass Filter 8 kHz → Echo
    0.25 s fb 0.3 → HardClip 0 dB → DbMeter → out (``n``: the node
    module).  ``state_light``: the echo and the meter become HardClips of
    6 and 12 dB, added before the 0 dB clip, as
    ``__graft_entry__._mixer_graph`` adds them (the same node keys)."""
    filt = g.add_node(2, 2, n.FilterNode(n.FilterType.LOWPASS, 8000.0,
                                         backend=filter_backend))
    if state_light:
        echo = g.add_node(2, 2, n.HardClipNode(6.0))
        meter = g.add_node(2, 2, n.HardClipNode(12.0))
        clip = g.add_node(2, 2, n.HardClipNode(0.0))
    else:
        echo = g.add_node(2, 2, n.EchoNode(delay_secs=0.25, feedback=0.3))
        clip = g.add_node(2, 2, n.HardClipNode(0.0))
        meter = g.add_node(2, 2, n.DbMeterNode())
    chain = [src, filt, echo, clip, meter, g.graph_out_node()]
    for a, b in zip(chain, chain[1:]):
        g.connect(a, 0, b, 0)
        g.connect(a, 1, b, 1)


def add_voice(g: AudioGraph, s, i: int, num_voices: int, nodes=None):
    """Voice ``i`` of the mixer: BeepTest (110·(1 + i mod 12) Hz, -18 dB) →
    Volume 80% → StereoPan (spread over [-1, 1]) → inputs ``2i, 2i+1`` of
    the sum ``s``.  ``nodes`` is the node module (the port's by default).
    Returns the (beep, volume, pan) node ids."""
    n = nodes or _NODES
    return _add_voice_chain(g, n.BeepTestNode(110.0 * (1 + i % 12), -18.0, True),
                            n.VolumeNode(80.0),
                            n.StereoPanNode((i / max(num_voices - 1, 1)) * 2 - 1), s, 2 * i)


def add_mixer(g: AudioGraph, num_voices: int = 19, filter_backend: str = "pallas",
              nodes=None, state_light: bool = False):
    """Add the mixer's nodes to ``g`` (stereo graph output): ``num_voices``
    voices (:func:`add_voice`) → Sum → lowpass Filter 8 kHz → Echo 0.25 s
    fb 0.3 → HardClip 0 dB → DbMeter → out.  ``nodes`` is the node module
    (the port's by default).  ``state_light``: the state-size ablation of
    ``__graft_entry__._mixer_graph``, the echo and the meter swapped for
    stateless clips (:func:`_add_bus_chain`).  Returns ``(sum, voices)``,
    ``voices`` the (beep, volume, pan) ids of each voice."""
    n = nodes or _NODES
    s = g.add_node(2 * num_voices, 2, n.SumNode())
    voices = [add_voice(g, s, i, num_voices, n) for i in range(num_voices)]
    _add_bus_chain(g, s, filter_backend, n, state_light)
    return s, voices


def add_voice_graph(g: AudioGraph, nodes=None) -> dict:
    """One voice of the mixer as a graph of its own, for
    :class:`~firewheel_tpu_torch.parallel.mesh.VoiceParallelMixer`:
    BeepTest (110 Hz, -18 dB) → Volume 80% → StereoPan (centre) → out.
    Returns the nodes (``"beep"``, ``"volume"``, ``"pan"``), whose setters
    give each voice its own snapshot (:func:`voice_snapshots`)."""
    n = nodes or _NODES
    v = {"beep": n.BeepTestNode(110.0, -18.0, True), "volume": n.VolumeNode(80.0),
         "pan": n.StereoPanNode(0.0)}
    _add_voice_chain(g, v["beep"], v["volume"], v["pan"], g.graph_out_node(), 0)
    return v


def add_mix_bus(g: AudioGraph, filter_backend: str = "pallas", nodes=None) -> None:
    """The mixer's bus as a graph of its own, on the stereo mix at its
    inputs (the master program of a ``VoiceParallelMixer``): see
    :func:`add_mixer`."""
    _add_bus_chain(g, g.graph_in_node(), filter_backend, nodes or _NODES)


def voice_mix_programs(filter_backend: str = "pallas",
                       device: str | torch.device = DEFAULT_DEVICE):
    """The mixer split for a ``VoiceParallelMixer`` → ``(voice_program,
    master_program, voice_nodes)``: :func:`add_voice_graph` and
    :func:`add_mix_bus`, compiled on ``device``."""
    def compile_(g):
        pkg = g.compile(SR, BLOCK)
        return ScheduleProgram(pkg.schedule, dict(pkg.new_node_processors), SR,
                               device=device)

    g = AudioGraph(AudioGraphConfig(0, 2))
    voice = add_voice_graph(g)
    vprog = compile_(g)
    g = AudioGraph(AudioGraphConfig(num_graph_inputs=2, num_graph_outputs=2))
    add_mix_bus(g, filter_backend)
    return vprog, compile_(g), voice


def voice_snapshots(program: ScheduleProgram, voice: dict, num_voices: int) -> list:
    """One param snapshot a voice, each its own: voice i at 55·(2 + i) Hz,
    volume 40 + (37·i mod 60) %, panned across [-1, 1].  ``voice``: the
    nodes :func:`add_voice_graph` returned for ``program``'s graph (either
    package's)."""
    snaps = []
    for i in range(num_voices):
        voice["beep"].set_frequency(55.0 * (2 + i))
        voice["volume"].set_percent_volume(40.0 + (37 * i) % 60)
        voice["pan"].set_pan(2.0 * i / max(num_voices - 1, 1) - 1.0)
        snaps.append(program.collect_params())
    return snaps


def mixer_graph(num_voices: int = 19, filter_backend: str = "pallas",
                device: str | torch.device = DEFAULT_DEVICE) -> ScheduleProgram:
    """Build and compile the mixer → a :class:`ScheduleProgram` on
    ``device``.  ``num_voices=19`` gives the 64-node benchmark graph."""
    g = AudioGraph(AudioGraphConfig(0, 2))
    add_mixer(g, num_voices, filter_backend)
    pkg = g.compile(SR, BLOCK)
    return ScheduleProgram(
        pkg.schedule, dict(pkg.new_node_processors), SR, device=device
    )


def add_effects_chain(g: AudioGraph, clip_audio, ir, echo_secs: float,
                      filter_backend: str = "auto"):
    """Add sampler (cubic, playing ``clip_audio``) → lowpass 6 kHz q 0.9 →
    echo (``echo_secs``, fb 0.35, wet 0.4) → clip at -3 dB → reverb (``ir``,
    wet 0.35) → out to ``g``.  Returns the sampler's node id."""
    sn = SamplerNode(percent_volume=100.0, quality="cubic")
    sn.set_sample(SampleResource(clip_audio))
    sn.play()
    sampler = g.add_node(0, 2, sn)
    filt = g.add_node(2, 2, FilterNode("lowpass", frequency_hz=6000.0, q=0.9,
                                       backend=filter_backend))
    echo = g.add_node(2, 2, EchoNode(delay_secs=echo_secs, feedback=0.35, wet=0.4))
    clip = g.add_node(2, 2, HardClipNode(threshold_db=-3.0))
    rev = g.add_node(2, 2, ConvolutionReverbNode(ir, wet=0.35))
    chain = [sampler, filt, echo, clip, rev, g.graph_out_node()]
    for a, b in zip(chain[:-1], chain[1:]):
        for ch in range(2):
            g.connect(a, ch, b, ch)
    return sampler


def effects_chain_audio(clip_frames: int = 8192):
    """The effects chain's seeded stereo clip (``rng(3)``, ×0.25) and
    256-tap stereo IR (``exp(-n/48)`` envelope)."""
    rng = np.random.default_rng(3)
    clip_audio = (rng.standard_normal((2, clip_frames)) * 0.25).astype(np.float32)
    ir = (rng.standard_normal((2, 256)) * np.exp(
        -np.arange(256, dtype=np.float32) / 48.0)).astype(np.float32)
    return clip_audio, ir


def _chain(g, clip_audio, ir, echo_secs, filter_backend, device):
    """sampler → filter → echo → clip → reverb → out, compiled."""
    add_effects_chain(g, clip_audio, ir, echo_secs, filter_backend)
    pkg = g.compile(SR, BLOCK)
    return ScheduleProgram(
        pkg.schedule, dict(pkg.new_node_processors), SR, device=device
    )


def effects_chain_graph(clip_frames: int = 8192, filter_backend: str = "auto",
                        device: str | torch.device = DEFAULT_DEVICE) -> ScheduleProgram:
    """The effects chain of ``bench.py --hybrid``: a cubic sampler playing a
    seeded stereo clip (``rng(3)``, ×0.25), lowpass 6 kHz q 0.9, echo
    0.01 s (480 samples) fb 0.35 wet 0.4, clip at -3 dB, and a reverb with
    a 256-tap stereo IR (``exp(-n/48)`` envelope), which is the direct
    engine.  Partitions into torch(sampler) | island(filter, echo, clip) |
    torch(reverb)."""
    clip_audio, ir = effects_chain_audio(clip_frames)
    return _chain(AudioGraph(AudioGraphConfig(0, 2)), clip_audio, ir, 0.01,
                  filter_backend, device)


def karplus_strong_pluck(freq_hz: float, secs: float, sr: int = SR):
    """Plucked-string synthesis: a noise burst through a feedback comb
    (``examples/effects_chain.py``), stereo."""
    rng = np.random.default_rng(5)
    period = int(round(sr / freq_hz))
    n = int(secs * sr)
    buf = np.zeros(n, np.float32)
    buf[:period] = rng.uniform(-1.0, 1.0, period).astype(np.float32)
    for i in range(period, n):
        buf[i] = 0.996 * 0.5 * (buf[i - period] + buf[i - period + 1])
    return np.stack([buf, buf])


def exp_decay_ir(secs: float, t60_secs: float, sr: int = SR):
    """A synthetic stereo room: decorrelated, exponentially decaying noise
    (``examples/effects_chain.py``)."""
    rng = np.random.default_rng(9)
    n = int(secs * sr)
    t = np.arange(n, dtype=np.float32) / sr
    env = np.exp(-6.91 * t / t60_secs)  # -60 dB at t60
    ir = rng.standard_normal((2, n)).astype(np.float32) * env
    return ir / np.abs(ir).sum(axis=-1, keepdims=True)


def effects_chain_config4_graph(filter_backend: str = "auto",
                                device: str | torch.device = DEFAULT_DEVICE) -> ScheduleProgram:
    """BASELINE config 4 (``examples/effects_chain.py``): a 1.2 s
    Karplus-Strong pluck through the chain, echo 0.28 s, and a 0.6 s IR
    (28 800 taps, 225 partitions), which is the FFT engine."""
    return _chain(AudioGraph(AudioGraphConfig(0, 2)),
                  karplus_strong_pluck(220.0, 1.2), exp_decay_ir(0.6, 0.5),
                  0.28, filter_backend, device)


_FILTER_TYPES = (
    FilterType.LOWPASS, FilterType.HIGHPASS, FilterType.BANDPASS,
    FilterType.NOTCH, FilterType.ALLPASS, FilterType.PEAKING,
    FilterType.LOW_SHELF, FilterType.HIGH_SHELF,
)


def random_graph(seed: int, device: str | torch.device = DEFAULT_DEVICE,
                 block_frames: int = BLOCK) -> ScheduleProgram:
    """A seeded random DAG of the port's nodes, compiled to a
    :class:`ScheduleProgram` at 48 kHz, stereo out, in blocks of
    ``block_frames`` (128 by default).  Its filter runs the sequential
    biquad (``backend="pallas"``), the recurrence the megakernel runs.

    Two or three beeps feed a shuffled chain of volumes, pans (1 and 2
    inputs), a 4→2 sum with one input left unconnected, a filter of random
    type, an echo whose delay (F+1..3F+66 frames for blocks of F: 129..450
    at 128) is longer than a block and shorter than four, a clip, a meter
    and a dummy.  Each input reads a random earlier output, so outputs fan
    out and some are left unread; graph output 1 reads an output that
    already has a reader."""
    rng = np.random.default_rng(seed)
    g = AudioGraph(AudioGraphConfig(0, 2))
    ports: list = []     # every output so far: (node, port)
    read: list = []      # outputs with a reader

    def pick():
        src = ports[int(rng.integers(len(ports)))]
        read.append(src)
        return src

    def add(n_in, n_out, node, unconnected=()):
        nid = g.add_node(n_in, n_out, node)
        for i in range(n_in):
            if i not in unconnected:
                g.connect(*pick(), nid, i)
        ports.extend((nid, j) for j in range(n_out))

    for _ in range(int(rng.integers(2, 4))):
        add(0, int(rng.integers(1, 3)), BeepTestNode(
            float(rng.uniform(100.0, 2000.0)), float(rng.uniform(-12.0, -3.0)),
            bool(rng.random() < 0.8)))
    kinds = ["volume", "volume", "pan1", "pan2", "sum", "filter", "echo",
             "clip", "meter", "dummy"]
    rng.shuffle(kinds)
    for kind in kinds:
        ch = int(rng.integers(1, 3))
        if kind == "volume":
            add(ch, ch, VolumeNode(float(rng.uniform(20.0, 120.0))))
        elif kind in ("pan1", "pan2"):
            add(1 if kind == "pan1" else 2, 2,
                StereoPanNode(float(rng.uniform(-1.0, 1.0))))
        elif kind == "sum":
            add(4, 2, SumNode(), unconnected=(3,))
        elif kind == "filter":
            add(ch, ch, FilterNode(
                _FILTER_TYPES[int(rng.integers(len(_FILTER_TYPES)))],
                float(rng.uniform(200.0, 12000.0)), float(rng.uniform(0.5, 4.0)),
                float(rng.uniform(-12.0, 12.0)), backend="pallas"))
        elif kind == "echo":
            add(ch, ch, EchoNode(
                delay_secs=int(rng.integers(block_frames + 1,
                                            3 * block_frames + 67)) / SR,
                feedback=float(rng.uniform(0.0, 0.8)),
                wet=float(rng.uniform(0.2, 1.0)), dry=float(rng.uniform(0.5, 1.0))))
        elif kind == "clip":
            add(ch, ch, HardClipNode(float(rng.uniform(-14.0, -2.0))))
        elif kind == "meter":
            add(ch, ch, DbMeterNode())
        else:
            add(ch, int(rng.integers(1, 3)), DummyAudioNode())
    out = g.graph_out_node()
    g.connect(*pick(), out, 0)
    g.connect(*read[int(rng.integers(len(read)))], out, 1)
    pkg = g.compile(SR, block_frames)
    return ScheduleProgram(
        pkg.schedule, dict(pkg.new_node_processors), SR, device=device
    )


#: The differential fuzzer's node palette (``tests/test_differential_fuzz.py``
#: in the JAX package): ``(name, build(rng, nodes) -> (node, n_in, n_out))``,
#: port counts fixed per kind to ones every node accepts.  Each builder makes
#: its rng draws in the JAX fuzzer's order.
FUZZ_PALETTE = (
    ("beep", lambda r, n: (n.BeepTestNode(float(r.uniform(80, 2000)),
                                          float(r.uniform(-24, -6)),
                                          bool(r.random() < 0.8)), 0, 2)),
    ("noise", lambda r, n: (n.NoiseNode("pink" if r.random() < 0.5 else "white",
                                        float(r.uniform(-30, -12)),
                                        seed=int(r.integers(0, 2**31))), 0, 2)),
    ("volume", lambda r, n: (n.VolumeNode(float(r.uniform(0, 150))), 2, 2)),
    ("sum", lambda r, n: (n.SumNode(), 4, 2)),
    ("hard_clip", lambda r, n: (n.HardClipNode(float(r.uniform(-12, 0))), 2, 2)),
    ("filter", lambda r, n: (n.FilterNode(
        ["lowpass", "highpass", "bandpass", "peaking"][int(r.integers(4))],
        float(r.uniform(100, 8000)), float(r.uniform(0.5, 4.0)),
        float(r.uniform(-9, 9))), 2, 2)),
    ("echo", lambda r, n: (n.EchoNode(float(r.uniform(0.01, 0.08)),
                                      float(r.uniform(0.0, 0.8)),
                                      float(r.uniform(0.2, 1.0))), 2, 2)),
    ("delay_comp", lambda r, n: (n.DelayCompNode(int(r.integers(0, 256))), 2, 2)),
    ("eq", lambda r, n: (n.ParametricEQNode(), 2, 2)),
    ("waveshaper", lambda r, n: (n.WaveshaperNode(
        ["tanh", "atan", "soft"][int(r.integers(3))],
        float(r.uniform(0, 18))), 2, 2)),
    ("stereo_width", lambda r, n: (n.StereoWidthNode(float(r.uniform(0, 2))), 2, 2)),
    ("pan", lambda r, n: (n.StereoPanNode(float(r.uniform(-1, 1))), 2, 2)),
    ("mono2stereo", lambda r, n: (n.MonoToStereoNode(), 1, 2)),
    ("stereo2mono", lambda r, n: (n.StereoToMonoNode(), 2, 1)),
    ("tremolo", lambda r, n: (n.TremoloNode(float(r.uniform(0.5, 12.0)),
                                            float(r.uniform(0, 1))), 2, 2)),
)


def fuzz_graph(rng, graph_factory=None, nodes=None):
    """The differential fuzzer's random DAG, drawn from ``rng`` (a numpy
    ``Generator``) draw for draw as the JAX package's ``build_random_graph``
    draws it → ``(graph, created, edges)``.

    Graph inputs 0 or 2, then 3–9 nodes of :data:`FUZZ_PALETTE`, each input
    port wired with odds 0.85 to a random earlier output (or the graph
    input), so some inputs dangle (cleared and silent) and outputs fan out
    freely; each graph output wired with odds 0.95.  Creation order is a
    topological order.  ``created``: ``(key, node_id, n_in, n_out)`` in
    creation order; ``edges``: ``{(dst_key, dst_port) | ("out", port):
    (src_key, src_port)}``, the records
    :func:`~firewheel_tpu_torch.testing.interpret_block` walks.

    ``graph_factory(n_in)`` builds into a caller's graph (a
    ``GraphContext``'s); by default a new stereo-out ``AudioGraph``.
    ``nodes`` is the node module (the port's by default): given the JAX
    package's nodes and graph types, the same calls build the same graph
    there, with the same keys."""
    n = nodes or _NODES
    n_in_ch = int(rng.choice([0, 2]))
    g = (AudioGraph(AudioGraphConfig(n_in_ch, 2)) if graph_factory is None
         else graph_factory(n_in_ch))
    gin = g.graph_in_node()
    avail = [(node_key(gin), gin, p) for p in range(n_in_ch)]
    created, edges = [], {}
    for _ in range(int(rng.integers(3, 10))):
        _, build = FUZZ_PALETTE[int(rng.integers(len(FUZZ_PALETTE)))]
        node, n_in, n_out = build(rng, n)
        nid = g.add_node(n_in, n_out, node)
        k = node_key(nid)
        for port in range(n_in):
            if avail and rng.random() < 0.85:
                sk, sid, sp = avail[int(rng.integers(len(avail)))]
                g.connect(sid, sp, nid, port)
                edges[(k, port)] = (sk, sp)
        created.append((k, nid, n_in, n_out))
        avail.extend((k, nid, p) for p in range(n_out))
    for port in range(2):
        if avail and rng.random() < 0.95:
            sk, sid, sp = avail[int(rng.integers(len(avail)))]
            g.connect(sid, sp, g.graph_out_node(), port)
            edges[("out", port)] = (sk, sp)
    return g, created, edges


#: the live-edit fuzzer's param setters, with their ranges: an edit's poke
#: sets the first of these a node has, :func:`fuzz_instance_params` every one
FUZZ_POKES = (
    ("set_percent_volume", 0.0, 150.0),
    ("set_frequency", 100.0, 8000.0),
    ("set_gain_db", -24.0, 6.0),
    ("set_feedback", 0.0, 0.8),
    ("set_width", 0.0, 2.0),
    ("set_pan", -1.0, 1.0),
    ("set_drive_db", 0.0, 18.0),
    ("set_depth", 0.0, 1.0),
)


def fuzz_instance_params(program: ScheduleProgram, graph, created, seed: int,
                         row: int) -> dict:
    """Instance ``row``'s own params for a :func:`fuzz_graph` graph: every
    setter of :data:`FUZZ_POKES` that a node of ``created`` has, in creation
    order, set to a value drawn from ``default_rng((seed, row))``, then
    ``program``'s snapshot.  The nodes keep those values; take the graph's
    own params and the initial state before the first call."""
    rng = np.random.default_rng((seed, row))
    for rec in created:
        node = graph.node(rec[1])
        for name, lo, hi in FUZZ_POKES:
            setter = getattr(node, name, None)
            if setter is not None:
                setter(float(rng.uniform(lo, hi)))
    return program.collect_params()


def fuzz_pooling_graph(graph_factory=None, nodes=None, num_voices: int = 6):
    """The fuzzer's pooling-heavy graph (the JAX package's
    ``test_pooling_heavy_differential``): ``num_voices`` voices of BeepTest
    (220·(v + 1) Hz, -18 dB) → Volume (40 + 10·v %) into one Sum → out,
    so the executor pools the beeps and the volumes into large groups →
    ``(graph, created, edges)`` as :func:`fuzz_graph` returns them."""
    n = nodes or _NODES
    g = AudioGraph(AudioGraphConfig(0, 2)) if graph_factory is None else graph_factory(0)
    created, edges = [], {}
    sum_id = g.add_node(2 * num_voices, 2, n.SumNode())
    ksum = node_key(sum_id)
    for v in range(num_voices):
        beep = g.add_node(0, 2, n.BeepTestNode(220.0 * (v + 1), -18.0, True))
        vol = g.add_node(2, 2, n.VolumeNode(40.0 + 10.0 * v))
        kb, kv = node_key(beep), node_key(vol)
        for ch in range(2):
            g.connect(beep, ch, vol, ch)
            g.connect(vol, ch, sum_id, 2 * v + ch)
            edges[(kv, ch)] = (kb, ch)
            edges[(ksum, 2 * v + ch)] = (kv, ch)
        created.append((kb, beep, 0, 2))
        created.append((kv, vol, 2, 2))
    created.append((ksum, sum_id, 2 * num_voices, 2))
    for ch in range(2):
        g.connect(sum_id, ch, g.graph_out_node(), ch)
        edges[("out", ch)] = (ksum, ch)
    return g, created, edges


def vary_params(params: dict, seed: int) -> dict:
    """Give every instance of batch-stacked ``params`` its own values, in
    place: volumes in [0, 1.2) (instance 0 of each at 0, muted), pans in
    [-1, 1), cutoffs in [200, 12000) Hz, and one beep in four disabled.
    Returns ``params``."""
    rng = np.random.default_rng(seed)

    def draw(t, lo, hi):
        v = torch.from_numpy(rng.uniform(lo, hi, t.shape).astype(np.float32))
        t.copy_(v)

    for key, p in params.items():
        if "raw_gain" in p:
            draw(p["raw_gain"], 0.0, 1.2)
            p["raw_gain"][0] = 0.0
        if "pan" in p:
            draw(p["pan"], -1.0, 1.0)
        if "freq" in p:
            draw(p["freq"], 200.0, 12000.0)
        if "enabled" in p:
            p["enabled"].copy_(torch.from_numpy(rng.random(p["enabled"].shape) >= 0.25))
    return params


def vary_effects_params(params: dict) -> dict:
    """Give every instance b of the effects chain's batch-stacked ``params``
    its own values, in place: playback rate 0.75 + 0.25·(b mod 6); a loop
    over the whole clip on even b, a one-shot from frame 1024·(b mod 8) on
    odd b (so some finish early); cutoff 6000 − 50·(b mod 64) Hz; reverb
    wet 0.2 + 0.01·(b mod 32).  Returns ``params``."""
    for p in params.values():
        if "sample" in p:
            b = torch.arange(p["rate"].shape[0], device=p["rate"].device)
            odd = b % 2 == 1
            p["rate"].copy_(0.75 + 0.25 * (b % 6).to(torch.float32))
            p["loop_on"].copy_(~odd)
            p["loop_start"].zero_()
            p["loop_end"].fill_(p["sample"].shape[-1])
            p["seek_pos"].copy_(torch.where(odd, 1024 * (b % 8), 0))
        elif "freq" in p:
            b = torch.arange(p["freq"].shape[0], device=p["freq"].device)
            p["freq"].copy_(6000.0 - 50.0 * (b % 64).to(torch.float32))
        elif "taps" in p or "h_head" in p:
            b = torch.arange(p["wet"].shape[0], device=p["wet"].device)
            p["wet"].copy_(0.2 + 0.01 * (b % 32).to(torch.float32))
    return params


def _emitter(i: int, num_emitters: int):
    """Emitter ``i`` of the spatial scene (``examples/spatial_scene.py``):
    ``(angle, radius, listener-frame position, beep frequency)`` on a
    circle around the listener, radius 3 + (i mod 5) m."""
    angle = 2 * math.pi * i / num_emitters
    radius = 3.0 + (i % 5)
    pos = (radius * math.sin(angle), 0.0, -radius * math.cos(angle))
    return angle, radius, pos, 110.0 * 2 ** ((i % 24) / 12.0)


def add_spatial_scene(g: AudioGraph, num_emitters: int = 128, groups: int = 4,
                      doppler_every: int = 0, binaural: bool = False, nodes=None):
    """Add the spatial scene's nodes to ``g`` (stereo graph output):
    ``num_emitters`` beeps at −30 dB, each into a spatializer, ``groups``
    group sums, a master sum, volume 90%, a dB meter and a 0 dB clip, as
    ``examples/spatial_scene.py`` builds them.  Every ``doppler_every``-th
    spatializer (0: none) is a doppler one; ``binaural`` puts
    ``BinauralSpatializerNode``s in place of the speaker spatializers.
    ``nodes`` is the node module (the port's by default).  Returns
    ``(meter, spatializers)``, each spatializer as ``(node id, angle,
    radius)``."""
    n = nodes or _NODES
    if num_emitters % groups:
        raise ValueError(f"{num_emitters} emitters do not split into {groups} groups")
    per_group = num_emitters // groups
    group_sums = [g.add_node(2 * per_group, 2, n.SumNode()) for _ in range(groups)]
    master = g.add_node(2 * groups, 2, n.SumNode())
    spatializers = []
    for i in range(num_emitters):
        angle, radius, pos, freq = _emitter(i, num_emitters)
        emitter = g.add_node(0, 1, n.BeepTestNode(freq, -30.0, True))
        if binaural:
            node = n.BinauralSpatializerNode(position=pos)
        else:
            node = n.Spatializer3DNode(
                position=pos, doppler=bool(doppler_every) and i % doppler_every == 0)
        spat = g.add_node(1, 2, node)
        g.connect(emitter, 0, spat, 0)
        grp = group_sums[i // per_group]
        slot = i % per_group
        g.connect(spat, 0, grp, 2 * slot)
        g.connect(spat, 1, grp, 2 * slot + 1)
        spatializers.append((spat, angle, radius))
    for gi, grp in enumerate(group_sums):
        g.connect(grp, 0, master, 2 * gi)
        g.connect(grp, 1, master, 2 * gi + 1)
    vol = g.add_node(2, 2, n.VolumeNode(90.0))
    meter = g.add_node(2, 2, n.DbMeterNode())
    clip = g.add_node(2, 2, n.HardClipNode(0.0))
    chain = [master, vol, meter, clip, g.graph_out_node()]
    for src, dst in zip(chain, chain[1:]):
        g.connect(src, 0, dst, 0)
        g.connect(src, 1, dst, 1)
    return meter, spatializers


def spatial_scene_graph(num_emitters: int = 128, groups: int = 4,
                        doppler_every: int = 0, binaural: bool = False,
                        device: str | torch.device = DEFAULT_DEVICE) -> ScheduleProgram:
    """BASELINE config 5 (:func:`add_spatial_scene`), compiled at 48 kHz in
    blocks of 128 frames → a :class:`ScheduleProgram` on ``device``.  The
    defaults give the 266-node graph of ``examples/spatial_scene.py``."""
    g = AudioGraph(AudioGraphConfig(0, 2))
    add_spatial_scene(g, num_emitters, groups, doppler_every, binaural)
    pkg = g.compile(SR, BLOCK)
    return ScheduleProgram(
        pkg.schedule, dict(pkg.new_node_processors), SR, device=device
    )


def orbit_scene(automation, graph, spatializers, secs: float = 1.5) -> int:
    """The example's automation: every (n // 32)-th of the ``n``
    spatializers (every one below 32) sweeps 90° around the listener over
    ``secs`` seconds, through ``automation`` (a ``ParamAutomator``, e.g.
    ``FirewheelCtx.automation``).  ``spatializers`` are
    :func:`add_spatial_scene`'s.  Returns the number of orbiting emitters."""
    moving = spatializers[:: max(1, len(spatializers) // 32)]
    for spat, angle, radius in moving:
        node = graph.node(spat)

        def mover(t_angle, node=node, base=angle, r=radius):
            a = base + t_angle
            node.set_position((r * math.sin(a), 0.0, -r * math.cos(a)))

        automation.add(f"orbit-{spat!r}", mover,
                       AutomationCurve.linear([(0.0, 0.0), (secs, math.pi / 2)]))
    return len(moving)


def vary_spatial_params(program: ScheduleProgram, params: dict, seed: int,
                        moving_every: int = 0) -> dict:
    """Give every instance of the spatial scene's batch-stacked ``params``
    its own emitters, in place: each speaker spatializer's position moves
    up to 2 m from where it is, its volume gain is in [0.25, 1.5) and its
    occlusion in [0, 1) (0 for one instance in three), staged by the node's
    own :meth:`~firewheel_tpu_torch.nodes.spatial.Spatializer3DProcessor.
    stage`.  With ``moving_every``, only every ``moving_every``-th
    spatializer changes (its smoothers then ramp from the state that
    ``init_state`` seeded).  Returns ``params``."""
    rng = np.random.default_rng(seed)
    spats = [(key, proc) for key, proc in program._procs.items()
             if isinstance(proc, Spatializer3DProcessor)]
    for j, (key, proc) in enumerate(spats):
        if moving_every and j % moving_every:
            continue
        p = params[key]
        b = p["gain"].shape[0]
        pos = (np.asarray(proc._node._position, np.float32)
               + rng.uniform(-2.0, 2.0, (b, 3)).astype(np.float32))
        occ = rng.uniform(0.0, 1.0, b) * (np.arange(b) % 3 != 0)
        staged = proc.stage(pos, rng.uniform(0.25, 1.5, b), occ)
        for leaf, v in staged.items():
            p[leaf].copy_(torch.from_numpy(v))
    return params


def air_shelf_taps(nodes=None) -> np.ndarray:
    """The mastering bus's linear-phase "air" shelf: +2 dB above 8 kHz as a
    255-tap FIR, the full band at 1.259 minus the excess below 8 kHz (a
    Hamming-windowed lowpass, ``design_windowed_sinc``)."""
    n = nodes or _NODES
    lp = n.design_windowed_sinc("lowpass", 255, SR, 8000.0)
    air = np.zeros(255, np.float32)
    air[127] = 1.259
    air += lp * (1.0 - 1.259)
    return air


def add_mastering_bus(g: AudioGraph, nodes=None) -> dict:
    """Add the mastering bus of ``examples/mastering_bus.py`` to ``g``
    (stereo graph output): pink noise (−14 dB, seed 11) as the music and a
    280 Hz beep (−12 dB, off) as the dialogue; a ducker (threshold −40 dB,
    depth −12 dB, 10 ms / 250 ms) with the dialogue as its sidechain; the
    ducked music and the dialogue summed; a compressor (−18 dB, 3:1, 10 ms /
    150 ms, makeup 3 dB); the 255-tap air shelf (:func:`air_shelf_taps`); a
    limiter (ceiling −1 dB, 3 ms lookahead); a loudness meter.  ``nodes`` is
    the node module (the port's by default).  Returns the node ids by name:
    ``music``, ``voice``, ``duck``, ``mix``, ``comp``, ``eq``, ``lim``,
    ``meter``."""
    n = nodes or _NODES
    ids = {
        "music": g.add_node(0, 2, n.NoiseNode("pink", gain_db=-14.0, seed=11)),
        "voice": g.add_node(0, 2, n.BeepTestNode(280.0, -12.0, False)),
        "duck": g.add_node(4, 2, n.DuckerNode(threshold_db=-40.0, duck_db=-12.0,
                                              attack_secs=0.01, release_secs=0.25)),
        "mix": g.add_node(4, 2, n.SumNode()),
        "comp": g.add_node(2, 2, n.CompressorNode(threshold_db=-18.0, ratio=3.0,
                                                  attack_secs=0.01,
                                                  release_secs=0.15, makeup_db=3.0)),
        "eq": g.add_node(2, 2, n.FirFilterNode(air_shelf_taps(n))),
        "lim": g.add_node(2, 2, n.LimiterNode(ceiling_db=-1.0, lookahead_secs=0.003)),
        "meter": g.add_node(2, 2, n.LoudnessMeterNode()),
    }
    for c in range(2):
        g.connect(ids["music"], c, ids["duck"], c)        # main bus
        g.connect(ids["voice"], c, ids["duck"], 2 + c)    # sidechain
        g.connect(ids["duck"], c, ids["mix"], c)          # ducked music
        g.connect(ids["voice"], c, ids["mix"], 2 + c)     # the dialogue itself
        g.connect(ids["mix"], c, ids["comp"], c)
        g.connect(ids["comp"], c, ids["eq"], c)
        g.connect(ids["eq"], c, ids["lim"], c)
        g.connect(ids["lim"], c, ids["meter"], c)
        g.connect(ids["meter"], c, g.graph_out_node(), c)
    return ids


def mastering_bus_graph(device: str | torch.device = DEFAULT_DEVICE) -> ScheduleProgram:
    """The mastering bus (:func:`add_mastering_bus`), compiled at 48 kHz in
    blocks of 128 frames → a :class:`ScheduleProgram` on ``device``."""
    g = AudioGraph(AudioGraphConfig(0, 2))
    add_mastering_bus(g)
    pkg = g.compile(SR, BLOCK)
    return ScheduleProgram(
        pkg.schedule, dict(pkg.new_node_processors), SR, device=device
    )


def vary_mastering_params(program: ScheduleProgram, params: dict, seed: int) -> dict:
    """Give every instance of the mastering bus's batch-stacked ``params``
    its own values, in place, around the example's settings: a noise seed
    of its own, the dialogue on in every other instance, the ducker's
    threshold in [−46, −34) dB and depth in [−18, −6) dB, the compressor's
    threshold in [−24, −12) dB and makeup in [0, 6) dB.  Returns
    ``params``."""
    rng = np.random.default_rng(seed)

    def put(t, values):
        t.copy_(torch.from_numpy(np.asarray(values)).to(t.dtype))

    for key, proc in program._procs.items():
        p = params[key]
        if isinstance(proc, NoiseProcessor):
            b = p["seed"].shape[0]
            put(p["seed"], rng.integers(0, 2**32, b, dtype=np.int64))
        elif isinstance(proc, BeepTestProcessor):
            b = p["enabled"].shape[0]
            put(p["enabled"], np.arange(b) % 2 == 1)
        elif isinstance(proc, DuckerProcessor):
            b = p["threshold_db"].shape[0]
            put(p["threshold_db"], rng.uniform(-46.0, -34.0, b).astype(np.float32))
            put(p["duck_db"], rng.uniform(-18.0, -6.0, b).astype(np.float32))
        elif isinstance(proc, CompressorProcessor):
            b = p["threshold_db"].shape[0]
            put(p["threshold_db"], rng.uniform(-24.0, -12.0, b).astype(np.float32))
            put(p["makeup"], db_to_gain(rng.uniform(0.0, 6.0, b).astype(np.float32)))
    return params


def voice_mixer_clip(seed: int) -> np.ndarray:
    """The clip of voice ``seed`` in ``examples/voice_mixer_64.py``
    (``make_clip``): a quarter-second mono pluck, ``f32[1, 12000]``, its
    pitch 55·2^(k/12) Hz with k drawn from ``rng(seed)`` in [0, 25), a
    second harmonic at 0.3, an 80 ms exponential decay, ×0.15."""
    rng = np.random.default_rng(seed)
    n = SR // 4
    t = np.arange(n, dtype=np.float32)
    freq = 55.0 * 2 ** (rng.integers(0, 25) / 12.0)
    tone = np.sin(2 * np.pi * freq / SR * t) + 0.3 * np.sin(
        2 * np.pi * 2 * freq / SR * t
    )
    env = np.exp(-t / (SR * 0.08)).astype(np.float32)
    return (tone * env * 0.15)[None, :].astype(np.float32)


def add_voice_mixer_64(g: AudioGraph, num_voices: int = 64, groups: int = 4,
                       nodes=None) -> dict:
    """Add BASELINE config 3, the graph of ``examples/voice_mixer_64.py``,
    to ``g`` (stereo graph output), node for node in the example's order:
    ``groups`` group sums of ``num_voices // groups`` stereo voices and a
    mixer sum over them (nodes take at most 64 ports); ``num_voices``
    poolable ``SamplerNode(80)`` voices, each looping its own clip
    (:func:`voice_mixer_clip`) at rate 2^((i mod 7 − 3)/12) (±3 semitones)
    from playhead (i mod 16)/64 s, with a 4 ms envelope, playing; the bus
    Volume 70% → StereoPan centre → HardClip 0 dB → out.  ``nodes`` is the
    node module (the port's by default; the JAX package's builds the same
    graph in JAX).  Returns the node ids: ``groups`` (the group sums),
    ``mixer``, ``voices``, ``volume``, ``pan``, ``clip``."""
    n = nodes or _NODES
    if num_voices % groups:
        raise ValueError(f"{num_voices} voices do not split into {groups} groups")
    # the node module's own clip class (the JAX package's holds jax arrays)
    resource = sys.modules[n.SamplerNode.__module__].SampleResource
    per_group = num_voices // groups
    group_sums = [g.add_node(2 * per_group, 2, n.SumNode()) for _ in range(groups)]
    mix = g.add_node(2 * groups, 2, n.SumNode())
    for gi, grp in enumerate(group_sums):
        g.connect(grp, 0, mix, 2 * gi)
        g.connect(grp, 1, mix, 2 * gi + 1)
    voices = []
    for i in range(num_voices):
        smp = g.add_node(0, 2, n.SamplerNode(80.0, poolable=True))
        grp = group_sums[i // per_group]
        slot = i % per_group
        g.connect(smp, 0, grp, 2 * slot)
        g.connect(smp, 1, grp, 2 * slot + 1)
        voices.append(smp)
    ids = {"groups": group_sums, "mixer": mix, "voices": voices,
           "volume": g.add_node(2, 2, n.VolumeNode(70.0)),
           "pan": g.add_node(2, 2, n.StereoPanNode(0.0)),
           "clip": g.add_node(2, 2, n.HardClipNode(0.0))}
    chain = [mix, ids["volume"], ids["pan"], ids["clip"], g.graph_out_node()]
    for a, b in zip(chain, chain[1:]):
        g.connect(a, 0, b, 0)
        g.connect(a, 1, b, 1)
    for i, vid in enumerate(voices):
        node = g.node(vid)
        node.set_sample(resource(voice_mixer_clip(i)))
        node.set_loop_range(n.LoopRange.FULL)
        node.set_playback_rate(2 ** ((i % 7 - 3) / 12.0))
        node.set_playhead((i % 16) / 64.0)
        node.set_envelope(0.004, 0.004)
        node.play()
    return ids


def voice_mixer_64_graph(num_voices: int = 64, groups: int = 4,
                         device: str | torch.device = DEFAULT_DEVICE) -> ScheduleProgram:
    """BASELINE config 3 (:func:`add_voice_mixer_64`), compiled at 48 kHz
    in blocks of 128 frames → a :class:`ScheduleProgram` on ``device``.
    The defaults give the example's 72-node graph (64 samplers, 5 sums, the
    bus)."""
    g = AudioGraph(AudioGraphConfig(0, 2))
    add_voice_mixer_64(g, num_voices, groups)
    pkg = g.compile(SR, BLOCK)
    return ScheduleProgram(
        pkg.schedule, dict(pkg.new_node_processors), SR, device=device
    )


def vary_voice_mixer_params(program: ScheduleProgram, params: dict, seed: int) -> dict:
    """Give every instance of config 3's batch-stacked ``params`` its own
    values, in place: each voice's playback rate 2^(s/12) with s in
    [−3, 3) semitones and its playhead anywhere in its clip (a seek the
    first block applies), the bus volume in [40, 100) % and its pan in
    [−1, 1).  Returns ``params``."""
    rng = np.random.default_rng(seed)

    def put(t, values):
        t.copy_(torch.from_numpy(np.asarray(values)).to(t.dtype))

    for key, proc in program._procs.items():
        p = params[key]
        if isinstance(proc, SamplerProcessor):
            b = p["rate"].shape[0]
            put(p["rate"], (2.0 ** (rng.uniform(-3.0, 3.0, b) / 12.0)).astype(np.float32))
            put(p["seek_pos"], rng.integers(0, p["sample"].shape[-1], b, dtype=np.int64))
        elif isinstance(proc, VolumeProcessor):
            b = p["raw_gain"].shape[0]
            put(p["raw_gain"], percent_volume_to_raw_gain(rng.uniform(40.0, 100.0, b)))
        elif isinstance(proc, StereoPanProcessor):
            b = p["pan"].shape[0]
            put(p["pan"], rng.uniform(-1.0, 1.0, b).astype(np.float32))
    return params


#: the master-bus FX palette of ``examples/interactive_graph.py:68-79``, in order
FX_KINDS = ("eq", "chorus", "flanger", "tremolo", "waveshaper", "gate")
#: the example's voice limit (``MAX_VOICES``) and the voices' frequencies: its
#: first two, then six more for the full width
FX_VOICES = (440.0, 660.0, 220.0, 330.0, 550.0, 880.0, 770.0, 990.0)


def fx_insert(kind: str, nodes=None):
    """A fresh node of the example's FX palette: ``kind`` one of
    :data:`FX_KINDS`, with the example's own params.  ``nodes`` is the node
    module (the port's by default)."""
    n = nodes or _NODES
    if kind == "eq":
        return n.ParametricEQNode([
            n.EQBand(n.FilterType.LOW_SHELF, 150.0, 0.8, 4.0),
            n.EQBand(n.FilterType.PEAKING, 1500.0, 1.2, -6.0),
            n.EQBand(n.FilterType.HIGH_SHELF, 6000.0, 0.7, 3.0),
        ])
    if kind == "chorus":
        return n.ModDelayNode.chorus(rate_hz=0.9, mix=0.5)
    if kind == "flanger":
        return n.ModDelayNode.flanger(feedback=0.6)
    if kind == "tremolo":
        return n.TremoloNode(rate_hz=5.0, depth=0.8)
    if kind == "waveshaper":
        return n.WaveshaperNode("soft", drive_db=12.0, mix=0.7)
    if kind == "gate":
        return n.GateNode(threshold_db=-45.0, hold_secs=0.1)
    raise ValueError(f"unknown FX kind {kind!r}; one of {FX_KINDS}")


def add_fx_voice(g: AudioGraph, s, slot: int, freq: float, nodes=None):
    """The example's ``_add_voice``: BeepTest (``freq``, −15 dB) → Volume
    80% → StereoPan centre → inputs ``2·slot, 2·slot + 1`` of the sum ``s``.
    Returns the (beep, volume, pan) node ids."""
    n = nodes or _NODES
    beep = g.add_node(0, 2, n.BeepTestNode(freq, -15.0, True))
    vol = g.add_node(2, 2, n.VolumeNode(80.0))
    pan = g.add_node(2, 2, n.StereoPanNode(0.0))
    for src, dst, port in ((beep, vol, 0), (vol, pan, 0), (pan, s, 2 * slot)):
        g.connect(src, 0, dst, port)
        g.connect(src, 1, dst, port + 1)
    return beep, vol, pan


def add_fx_engine(g: AudioGraph, nodes=None) -> dict:
    """Add the engine graph of ``examples/interactive_graph.py``'s
    ``EngineApp`` to ``g`` (stereo graph output): Sum (16 inputs, the
    example's 8 voice slots) → HardClip 0 dB → DbMeter → out, and its first
    two voices (:func:`add_fx_voice`, 440 and 660 Hz).  Returns the node ids
    ``sum``, ``clip``, ``meter``, ``voices`` (a list of (beep, volume, pan))
    and ``fx`` (the master insert's ``(kind, id)``, None: :func:`set_fx`)."""
    n = nodes or _NODES
    ids = {"sum": g.add_node(2 * len(FX_VOICES), 2, n.SumNode()),
           "clip": g.add_node(2, 2, n.HardClipNode(0.0)),
           "meter": g.add_node(2, 2, n.DbMeterNode()), "fx": None}
    for c in range(2):
        g.connect(ids["sum"], c, ids["clip"], c, check_for_cycles=True)
        g.connect(ids["clip"], c, ids["meter"], c, check_for_cycles=True)
        g.connect(ids["meter"], c, g.graph_out_node(), c, check_for_cycles=True)
    ids["voices"] = [add_fx_voice(g, ids["sum"], i, FX_VOICES[i], n) for i in range(2)]
    return ids


def set_fx(g: AudioGraph, ids: dict, kind: str | None, nodes=None) -> None:
    """The example's ``_set_fx`` on :func:`add_fx_engine`'s graph: remove
    the current master insert (or cut clip → meter), then insert a fresh
    ``kind`` (:func:`fx_insert`) between the clip and the meter, or, for
    ``None``, reconnect them.  A topology edit: the running engine
    recompiles and hot-swaps with state migration."""
    if ids["fx"] is not None:
        g.remove_node(ids["fx"][1])  # severs its edges
        ids["fx"] = None
    else:
        for c in range(2):
            g.disconnect(ids["clip"], c, ids["meter"], c)
    if kind is None:
        for c in range(2):
            g.connect(ids["clip"], c, ids["meter"], c, check_for_cycles=True)
        return
    node = g.add_node(2, 2, fx_insert(kind, nodes))
    for c in range(2):
        g.connect(ids["clip"], c, node, c, check_for_cycles=True)
        g.connect(node, c, ids["meter"], c, check_for_cycles=True)
    ids["fx"] = (kind, node)


def add_fx_palette(g: AudioGraph, num_voices: int = len(FX_VOICES), nodes=None,
                   kinds=FX_KINDS) -> dict:
    """Add the engine graph of ``examples/interactive_graph.py`` to ``g``
    (stereo graph output) with every FX insert in series: ``num_voices``
    voices (:func:`add_fx_voice`) → Sum (16 inputs, the example's 8 voice
    slots) → HardClip 0 dB → the palette (:func:`fx_insert`, each of
    ``kinds`` in :data:`FX_KINDS` order) → a fold waveshaper with its DC blocker →
    StereoWidth 1.25 → StereoToMono → PitchShift +7 semitones, mix 0.5 →
    MonoToStereo → DbMeter → out.  ``nodes`` is the node module (the port's
    by default).  Returns the node ids: ``sum``, ``clip``, ``meter``,
    ``voices`` (the (beep, volume, pan) of each) and each insert by kind,
    plus ``fold``, ``width``, ``to_mono``, ``pitch``, ``to_stereo``."""
    n = nodes or _NODES
    ids = {"sum": g.add_node(2 * len(FX_VOICES), 2, n.SumNode())}
    ids["voices"] = [add_fx_voice(g, ids["sum"], i, FX_VOICES[i], n)
                     for i in range(num_voices)]
    ids["clip"] = g.add_node(2, 2, n.HardClipNode(0.0))
    chain = [ids["sum"], ids["clip"]]
    for kind in (k for k in FX_KINDS if k in kinds):
        ids[kind] = g.add_node(2, 2, fx_insert(kind, n))
        chain.append(ids[kind])
    ids["fold"] = g.add_node(2, 2, n.WaveshaperNode("fold", drive_db=3.0, mix=0.5,
                                                    dc_block=True))
    ids["width"] = g.add_node(2, 2, n.StereoWidthNode(1.25))
    chain += [ids["fold"], ids["width"]]
    for src, dst in zip(chain, chain[1:]):
        g.connect(src, 0, dst, 0)
        g.connect(src, 1, dst, 1)
    ids["to_mono"] = g.add_node(2, 1, n.StereoToMonoNode())
    ids["pitch"] = g.add_node(1, 1, n.PitchShiftNode(7.0, mix=0.5))
    ids["to_stereo"] = g.add_node(1, 2, n.MonoToStereoNode())
    ids["meter"] = g.add_node(2, 2, n.DbMeterNode())
    g.connect(ids["width"], 0, ids["to_mono"], 0)
    g.connect(ids["width"], 1, ids["to_mono"], 1)
    g.connect(ids["to_mono"], 0, ids["pitch"], 0)
    g.connect(ids["pitch"], 0, ids["to_stereo"], 0)
    for c in range(2):
        g.connect(ids["to_stereo"], c, ids["meter"], c)
        g.connect(ids["meter"], c, g.graph_out_node(), c)
    return ids


def fx_palette_graph(num_voices: int = len(FX_VOICES),
                     device: str | torch.device = DEFAULT_DEVICE,
                     kinds=FX_KINDS, block_frames: int = BLOCK) -> ScheduleProgram:
    """The FX palette graph (:func:`add_fx_palette`, with the inserts
    ``kinds``), compiled at 48 kHz in blocks of ``block_frames`` → a
    :class:`ScheduleProgram` on ``device``."""
    g = AudioGraph(AudioGraphConfig(0, 2))
    add_fx_palette(g, num_voices, kinds=kinds)
    pkg = g.compile(SR, block_frames)
    return ScheduleProgram(
        pkg.schedule, dict(pkg.new_node_processors), SR, device=device
    )


#: the gate of :func:`add_eq_gate`: it opens on the voices' peaks and closes
#: between them within every block (−9 dB, 3 dB of hysteresis, no hold), so
#: that its floor's gradient is not 0
EQ_GATE = {"threshold_db": -9.0, "range_db": -20.0, "attack_secs": 0.0005,
           "release_secs": 0.002, "hold_secs": 0.0, "hysteresis_db": 3.0}


def add_eq_gate(g: AudioGraph, num_voices: int = len(FX_VOICES), nodes=None) -> dict:
    """Add the FX palette's voices and EQ with a gate after it to ``g``
    (stereo graph output): ``num_voices`` voices (:func:`add_fx_voice`) →
    Sum (16 inputs) → the palette's EQ (:func:`fx_insert`, three bands) →
    ``GateNode(**EQ_GATE)`` → out.  ``nodes`` is the node module (the
    port's by default).  Returns the node ids ``sum``, ``eq``, ``gate`` and
    ``voices``."""
    n = nodes or _NODES
    ids = {"sum": g.add_node(2 * len(FX_VOICES), 2, n.SumNode())}
    ids["voices"] = [add_fx_voice(g, ids["sum"], i, FX_VOICES[i], n)
                     for i in range(num_voices)]
    ids["eq"] = g.add_node(2, 2, fx_insert("eq", n))
    ids["gate"] = g.add_node(2, 2, n.GateNode(**EQ_GATE))
    chain = [ids["sum"], ids["eq"], ids["gate"], g.graph_out_node()]
    for src, dst in zip(chain, chain[1:]):
        g.connect(src, 0, dst, 0)
        g.connect(src, 1, dst, 1)
    return ids


def eq_gate_graph(num_voices: int = len(FX_VOICES),
                  device: str | torch.device = DEFAULT_DEVICE) -> ScheduleProgram:
    """:func:`add_eq_gate`'s graph compiled at 48 kHz in blocks of
    :data:`BLOCK` → a :class:`ScheduleProgram` on ``device``."""
    g = AudioGraph(AudioGraphConfig(0, 2))
    add_eq_gate(g, num_voices)
    pkg = g.compile(SR, BLOCK)
    return ScheduleProgram(
        pkg.schedule, dict(pkg.new_node_processors), SR, device=device
    )


def vary_fx_params(program: ScheduleProgram, params: dict, seed: int,
                   gains: dict | None = None) -> dict:
    """Give every instance of the FX palette's batch-stacked ``params`` its
    own values, in place: each voice's frequency within ±25% of its own,
    each EQ band's gain within ±6 dB of its own (the band's coefficients
    restaged by the filter node's designs, per instance), the chorus's rate
    in [0.3, 3) Hz, each waveshaper's drive within ±6 dB of its own, the
    width in [0.5, 2) and the pitch shift in [−12, 12) semitones.  The EQ's
    per-instance gains in dB (float32 ``[B]``) go into ``gains``, when
    given, under ``(node key, band index)``.  Returns ``params``."""
    rng = np.random.default_rng(seed)

    def put(t, values):
        t.copy_(torch.from_numpy(np.asarray(values)).to(t.dtype))

    for key, proc in program._procs.items():
        p = params[key]
        if isinstance(proc, BeepTestProcessor):
            b = p["inc"].shape[0]
            freq = proc._node.freq_hz * rng.uniform(0.75, 1.25, b)
            put(p["inc"], [phase_inc_fixed(f, proc.sample_rate) for f in freq])
        elif isinstance(proc, ParametricEQProcessor):
            for i, band in enumerate(proc._node._bands):
                leaves = p["bands"][str(i)]
                b = leaves["b0"].shape[0]
                gain = (band.gain_db + rng.uniform(-6.0, 6.0, b)).astype(np.float32)
                if gains is not None:
                    gains[(key, i)] = gain
                # host numbers: the designs' numpy float32 staging, as the
                # node's collect_params stages its bands
                c = _DESIGNS[band.band_type](band.frequency_hz, band.q, gain,
                                             proc.sample_rate)
                for k, v in zip(("b0", "b1", "b2", "a1", "a2"), c):
                    put(leaves[k], np.asarray(v, np.float32))
        elif isinstance(proc, ModDelayProcessor) and not proc._fb_mode:
            b = p["rate"].shape[0]
            put(p["rate"], (rng.uniform(0.3, 3.0, b) / proc.sample_rate).astype(np.float32))
        elif isinstance(proc, WaveshaperProcessor):
            b = p["drive"].shape[0]
            drive_db = proc._node.drive_db() + rng.uniform(-6.0, 6.0, b)
            put(p["drive"], db_to_gain(drive_db.astype(np.float32)).astype(np.float32))
        elif isinstance(proc, StereoWidthProcessor):
            b = p["width"].shape[0]
            put(p["width"], rng.uniform(0.5, 2.0, b).astype(np.float32))
        elif isinstance(proc, PitchShiftProcessor):
            b = p["ratio"].shape[0]
            put(p["ratio"], (2.0 ** (rng.uniform(-12.0, 12.0, b) / 12.0)).astype(np.float32))
    return params
