"""The benchmark graph: the batched 64-node mixer.

Mirrors ``__graft_entry__._mixer_graph``: 19 voices of BeepTest → Volume →
StereoPan, then Sum → lowpass Filter 8 kHz → Echo 0.25 s/fb 0.3 → HardClip
→ DbMeter → out, at 48 kHz stereo, 64 nodes with the two sentinels.  Node
keys (``repr(NodeID)``) come out identical to the JAX package's.
"""

from __future__ import annotations

import torch

from .executor import ScheduleProgram
from .graph import AudioGraph, AudioGraphConfig
from .nodes import (
    BeepTestNode,
    DbMeterNode,
    EchoNode,
    FilterNode,
    FilterType,
    HardClipNode,
    StereoPanNode,
    SumNode,
    VolumeNode,
)

__all__ = ["BLOCK", "SR", "mixer_graph"]

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
