"""The benchmark graph, the batched 64-node mixer, and random graphs.

:func:`mixer_graph` mirrors ``__graft_entry__._mixer_graph``: 19 voices of
BeepTest → Volume → StereoPan, then Sum → lowpass Filter 8 kHz → Echo
0.25 s/fb 0.3 → HardClip → DbMeter → out, at 48 kHz stereo, 64 nodes with
the two sentinels.  Node keys (``repr(NodeID)``) come out identical to the
JAX package's.  :func:`random_graph` builds seeded random DAGs of the same
nodes, and :func:`vary_params` gives every instance of a batch its own
params, for holding two lowerings against each other.
"""

from __future__ import annotations

import numpy as np
import torch

from .executor import ScheduleProgram
from .graph import AudioGraph, AudioGraphConfig
from .nodes import (
    BeepTestNode,
    DbMeterNode,
    DummyAudioNode,
    EchoNode,
    FilterNode,
    FilterType,
    HardClipNode,
    StereoPanNode,
    SumNode,
    VolumeNode,
)

__all__ = ["BLOCK", "SR", "mixer_graph", "random_graph", "vary_params"]

SR = 48000
BLOCK = 128


def mixer_graph(num_voices: int = 19, filter_backend: str = "pallas",
                device: str | torch.device = "cpu") -> ScheduleProgram:
    """Build and compile the mixer → a :class:`ScheduleProgram` on
    ``device``.  ``num_voices=19`` gives the 64-node benchmark graph."""
    g = AudioGraph(AudioGraphConfig(0, 2))
    s = g.add_node(2 * num_voices, 2, SumNode())
    for i in range(num_voices):
        freq = 110.0 * (1 + i % 12)
        beep = g.add_node(0, 2, BeepTestNode(freq, -18.0, True))
        vol = g.add_node(2, 2, VolumeNode(80.0))
        pan = g.add_node(2, 2, StereoPanNode((i / max(num_voices - 1, 1)) * 2 - 1))
        g.connect(beep, 0, vol, 0)
        g.connect(beep, 1, vol, 1)
        g.connect(vol, 0, pan, 0)
        g.connect(vol, 1, pan, 1)
        g.connect(pan, 0, s, 2 * i)
        g.connect(pan, 1, s, 2 * i + 1)
    filt = g.add_node(2, 2, FilterNode(FilterType.LOWPASS, 8000.0,
                                       backend=filter_backend))
    echo = g.add_node(2, 2, EchoNode(delay_secs=0.25, feedback=0.3))
    clip = g.add_node(2, 2, HardClipNode(0.0))
    meter = g.add_node(2, 2, DbMeterNode())
    chain = [s, filt, echo, clip, meter, g.graph_out_node()]
    for src, dst in zip(chain, chain[1:]):
        g.connect(src, 0, dst, 0)
        g.connect(src, 1, dst, 1)

    pkg = g.compile(SR, BLOCK)
    return ScheduleProgram(
        pkg.schedule, dict(pkg.new_node_processors), SR, device=device
    )


_FILTER_TYPES = (
    FilterType.LOWPASS, FilterType.HIGHPASS, FilterType.BANDPASS,
    FilterType.NOTCH, FilterType.ALLPASS, FilterType.PEAKING,
    FilterType.LOW_SHELF, FilterType.HIGH_SHELF,
)


def random_graph(seed: int, device: str | torch.device = "cpu") -> ScheduleProgram:
    """A seeded random DAG of the port's nodes, compiled to a
    :class:`ScheduleProgram` at 48 kHz, 128-frame blocks, stereo out.

    Two or three beeps feed a shuffled chain of volumes, pans (1 and 2
    inputs), a 4→2 sum with one input left unconnected, a filter of random
    type, an echo whose delay (129..450 frames) is shorter than four blocks
    and not a multiple of one, a clip, a meter and a dummy.  Each input reads
    a random earlier output, so outputs fan out and some are left unread;
    graph output 1 reads an output that already has a reader."""
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
                float(rng.uniform(-12.0, 12.0))))
        elif kind == "echo":
            add(ch, ch, EchoNode(
                delay_secs=int(rng.integers(129, 451)) / SR,
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
    pkg = g.compile(SR, BLOCK)
    return ScheduleProgram(
        pkg.schedule, dict(pkg.new_node_processors), SR, device=device
    )


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
