"""Spatial scene: 128 3D-positioned emitters + dB meters, 266-node graph,
on the port.

BASELINE config 5.  128 beep emitters are scattered on a circle around the
listener, each through a 3D spatializer; subgroups meet at summation nodes,
a metered master bus clips the mix, and the emitters orbit the listener via
automation during the render.  Each spatializer's one-pole runs the
associative scan (``csrc/assoc_scan.cu``), one launch for the pooled
spatializers a block.

Node count: 128 emitters + 128 spatializers + 4 group sums + master sum +
volume + meter + clip + 2 sentinels = 266.

Run:  python -m firewheel_tpu_torch.examples.spatial_scene [out.wav]
"""

from __future__ import annotations

import sys

from ..backend import FirewheelCtx, StreamConfig, WavSink
from ..device import DEFAULT_DEVICE
from ..mixer import add_spatial_scene, orbit_scene
from ..nodes import DbMeterNode

SR = 48000
NUM_EMITTERS = 128
GROUPS = 4
SECS = 1.5


def build_scene(cx: FirewheelCtx):
    """The scene in ``cx``'s graph (NUM_EMITTERS emitters in GROUPS groups,
    :func:`~firewheel_tpu_torch.mixer.add_spatial_scene`) and its orbit on
    ``cx.automation``: every (NUM_EMITTERS // 32)-th emitter sweeps 90°
    over SECS.  Returns ``(meter id, spatializers, emitters orbiting)``,
    each spatializer as ``(node id, angle, radius)``."""
    g = cx.graph_mut()
    meter, spatializers = add_spatial_scene(g, NUM_EMITTERS, GROUPS)
    orbiting = orbit_scene(cx.automation, g, spatializers, SECS)
    return meter, spatializers, orbiting


def main(out_path: str = "spatial_scene.wav", device=DEFAULT_DEVICE) -> dict:
    """Render SECS of the scene on ``device`` offline to ``out_path``, in
    1024-frame buffers, 8 a dispatch.  Returns the node count, the master
    meter's reading and the stream's stats."""
    cx = FirewheelCtx(device=device)
    meter, _, _ = build_scene(cx)
    n_nodes = len(list(cx.graph.nodes()))
    print(f"graph: {n_nodes} nodes ({NUM_EMITTERS} emitters)")

    sink = WavSink(out_path, SR, 2)
    cx.activate(
        StreamConfig(SR, 2, buffer_frames=1024, chunk_buffers=8), sink=sink
    )
    cx.render_offline(SECS)
    reading = DbMeterNode.read(cx.node_state(meter))
    stats = cx.stream.stats()
    cx.deactivate()

    print(
        f"rendered {SECS} s → {out_path}; master "
        f"peak {reading['peak_db'].round(1)} dB, "
        f"rms {reading['rms_db'].round(1)} dB; "
        f"render/buffer p50 {stats['render_ms_p50']:.2f} ms, "
        f"p99 {stats['render_ms_p99']:.2f} ms incl. one-time compiles / "
        f"{stats['buffer_budget_ms']:.2f} ms budget"
    )
    return {"nodes": n_nodes, "reading": reading, "stats": stats}


if __name__ == "__main__":
    main(*sys.argv[1:2])
