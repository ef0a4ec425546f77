"""SessionServer demo: a day in the life of a game-audio fleet, on the port.

Eight clients connect to a 16-slot server over one compiled program, each
with their own mix settings; sessions fire SFX (completions arrive as
per-session device events), change their settings live, disconnect and
are replaced, all with no recompile after the first chunk.  With
``output_format="pcm16"`` the fetched audio is wire-ready PCM
(``int16[B, K, F, No]``) and the RMS below is in LSBs.

Run:  python -m firewheel_tpu_torch.examples.session_server [pcm16]
"""

from __future__ import annotations

import sys

import numpy as np

from ..core.sample_resource import SampleResource
from ..device import DEFAULT_DEVICE
from ..executor import ScheduleProgram
from ..graph import AudioGraph, AudioGraphConfig
from ..nodes import BeepTestNode, SamplerNode, StereoPanNode, SumNode, VolumeNode
from ..serving import SessionServer

SR, BLOCK = 48000, 128
CAPACITY = 16


def build_template(device=DEFAULT_DEVICE):
    """Per-client audio: music tone -> volume -> pan, one-shot SFX,
    summed.  Built in its IDLE state (muted, paused).  Returns ``(program
    on device, the template's nodes by name)``."""
    g = AudioGraph(AudioGraphConfig(0, 2))
    music = BeepTestNode(330.0, -18.0, True)
    vol = VolumeNode(0.0)       # idle: muted
    pan = StereoPanNode(0.0)
    sfx = SamplerNode(100.0)
    rng = np.random.default_rng(1)
    sfx.set_sample(SampleResource(
        (rng.standard_normal((2, 2048)) * 0.1).astype(np.float32),
        device=False,
    ))
    mid = g.add_node(0, 2, music)
    vid = g.add_node(2, 2, vol)
    pid = g.add_node(2, 2, pan)
    sid = g.add_node(0, 2, sfx)
    mix = g.add_node(4, 2, SumNode())
    g.connect(mid, 0, vid, 0)
    g.connect(mid, 1, vid, 1)
    g.connect(vid, 0, pid, 0)
    g.connect(vid, 1, pid, 1)
    g.connect(pid, 0, mix, 0)
    g.connect(pid, 1, mix, 1)
    g.connect(sid, 0, mix, 2)
    g.connect(sid, 1, mix, 3)
    g.connect(mix, 0, g.graph_out_node(), 0)
    g.connect(mix, 1, g.graph_out_node(), 1)
    pkg = g.compile(SR, BLOCK)
    prog = ScheduleProgram(pkg.schedule, dict(pkg.new_node_processors), SR,
                           device=device)
    return prog, {"vol": vol, "pan": pan, "sfx": sfx}


def main(output_format: str = "f32", device=DEFAULT_DEVICE) -> dict:
    """Serve the day on ``device``, the server's chunks as ``output_format``
    (``"f32"`` as the JAX example, or ``"pcm16"``).  Returns the sessions
    whose SFX finished, each slot's RMS over the last chunk, that chunk
    on the host and the session-seconds rendered."""
    prog, n = build_template(device)
    srv = SessionServer(prog, capacity=CAPACITY, chunk_blocks=16, device=device,
                        output_format=output_format)

    # 8 clients join, each with their own pan + volume; evens fire a shot
    handles = []
    for i in range(8):
        def cfg(i=i):
            n["vol"].set_percent_volume(100.0)
            n["pan"].set_pan(-1.0 + 2.0 * i / 7)
            (n["sfx"].play() if i % 2 == 0 else n["sfx"].pause())
        handles.append(srv.connect(cfg))
    out = srv.render().cpu().numpy()
    print(f"{srv.occupancy}/{CAPACITY} sessions, {out.shape} per chunk")

    done = srv.poll_events()
    fired = sorted(h.slot for h in done)
    print(f"SFX finished in sessions {fired}")
    assert fired == [h.slot for i, h in enumerate(handles) if i % 2 == 0]

    # client 3 mutes; client 5 leaves; a new client takes the free slot
    handles[3].update(lambda: n["vol"].set_percent_volume(0.0))
    handles[5].disconnect()
    newcomer = srv.connect(lambda: n["vol"].set_percent_volume(100.0))
    assert newcomer.slot == 5 and not handles[5].alive

    for _ in range(8):
        out = srv.render().cpu().numpy()
    r = np.sqrt((out.astype(np.float64) ** 2).mean(axis=(1, 2, 3)))
    print("per-session rms:",
          " ".join(f"{b}:{r[b]:.3f}" for b in range(CAPACITY)))
    assert r[handles[3].slot] < 1e-6, "muted session audible"
    assert r[newcomer.slot] > 0.05, "newcomer lost"
    assert all(r[b] < 1e-6 for b in range(8, CAPACITY)), "vacant slot noisy"
    seconds = srv.occupancy * srv.sample / SR
    print(f"OK: {srv.sample / SR:.2f} s per session, "
          f"{seconds:.1f} session-seconds total")
    return {"fired": fired, "rms": r, "last_chunk": out, "session_seconds": seconds}


if __name__ == "__main__":
    main(*sys.argv[1:2])
