"""Visual node graph: live DAG editing with visualization.

A palette of node types is instantiated into a running engine, edited
live (connections with cycle checking, volume drags), and the graph and
its compiled schedule are rendered as terminal ASCII, a Graphviz DOT file
and a drag-the-nodes HTML page (``utils/viz.py``).

Run:  python -m firewheel_tpu_torch.examples.visual_node_graph [out.html]
"""

from __future__ import annotations

import os
import sys

from ..backend import ArraySink, FirewheelCtx, StreamConfig
from ..device import DEFAULT_DEVICE
from ..graph import CycleDetected
from ..nodes import (
    BeepTestNode,
    HardClipNode,
    MonoToStereoNode,
    StereoPanNode,
    StereoToMonoNode,
    SumNode,
    VolumeNode,
)
from ..utils.viz import ascii_graph, schedule_table, to_dot, to_html


def main(out_html: str = "visual_node_graph.html", device=DEFAULT_DEVICE) -> dict:
    """Build, edit and render the palette's graph on ``device``; write the
    DOT file beside ``out_html``.  Returns ``cycle_rejected``, ``ascii``,
    ``schedule`` (the compiled schedule's table), ``dot``, ``audio``."""
    cx = FirewheelCtx(device=device)
    g = cx.graph_mut()

    # the palette
    beep_a = g.add_node(0, 2, BeepTestNode(440.0, -12.0, True))
    beep_b = g.add_node(0, 2, BeepTestNode(660.0, -18.0, True))
    vol_a = g.add_node(2, 2, VolumeNode(100.0))
    vol_b = g.add_node(2, 2, VolumeNode(60.0))
    mixer = g.add_node(6, 2, SumNode())  # ports 4/5 left free
    to_mono = g.add_node(2, 1, StereoToMonoNode())
    to_stereo = g.add_node(1, 2, MonoToStereoNode())
    pan = g.add_node(2, 2, StereoPanNode(0.3))
    clip = g.add_node(2, 2, HardClipNode(0.0))

    # wired like a user dragging connections, the cycle check on
    for src, sp, dst, dp in (
        (beep_a, 0, vol_a, 0), (beep_a, 1, vol_a, 1),
        (beep_b, 0, vol_b, 0), (beep_b, 1, vol_b, 1),
        (vol_a, 0, mixer, 0), (vol_a, 1, mixer, 1),
        (vol_b, 0, mixer, 2), (vol_b, 1, mixer, 3),
        (mixer, 0, to_mono, 0), (mixer, 1, to_mono, 1),
        (to_mono, 0, to_stereo, 0),
        (to_stereo, 0, pan, 0), (to_stereo, 1, pan, 1),
        (pan, 0, clip, 0), (pan, 1, clip, 1),
        (clip, 0, g.graph_out_node(), 0), (clip, 1, g.graph_out_node(), 1),
    ):
        g.connect(src, sp, dst, dp, check_for_cycles=True)

    # a cycle attempt is rejected, the graph untouched
    rejected = False
    try:
        g.connect(clip, 0, mixer, 4, check_for_cycles=True)
    except CycleDetected:
        rejected = True
        print("(cycle attempt rejected, as the editor would show)")

    art = ascii_graph(g)
    print("\n=== graph ===")
    print(art)

    sink = ArraySink()
    cx.activate(StreamConfig(48000, 2, buffer_frames=512), sink=sink)

    # live param edits while rendering (the volume drag)
    va = g.node(vol_a)
    for pct in (100.0, 75.0, 50.0, 25.0):
        va.set_percent_volume(pct)
        cx.render_offline(0.1)

    schedule = None
    table = None
    proc = cx.stream._processor
    if proc._program is not None:
        schedule = proc._program.schedule
        table = schedule_table(schedule)
        print("\n=== compiled schedule ===")
        print(table)

    cx.deactivate()
    audio = sink.audio(2)
    print(f"\nrendered {audio.shape[1] / 48000:.2f}s of audio on {cx.device}")

    dot = to_dot(g, schedule)
    dot_path = os.path.splitext(out_html)[0] + ".dot"
    with open(dot_path, "w") as f:
        f.write(dot)
    with open(out_html, "w") as f:
        f.write(to_html(g, schedule, title="firewheel_tpu_torch — visual node graph"))
    print(f"wrote {dot_path} and {out_html} (open in a browser; drag nodes)")
    return {"cycle_rejected": rejected, "ascii": art, "schedule": table, "dot": dot,
            "audio": audio}


if __name__ == "__main__":
    main(*sys.argv[1:2])
