"""Game-server serving path: many independent game instances on one card.

B independent *instances* of one game's graph render in one
``BatchRenderer`` dispatch, driven by a per-instance control plane:

* every dispatch renders K blocks for ALL instances;
* a client command ("player 7 muted the music") edits only that
  instance's param slice (``update_instance``: one instance's bytes moved,
  no disturbance to the other B−1);
* a client reconnect resets only that instance's recurrent state
  (``reset_instance``);
* the SFX one-shots' finishes come back per instance from device counters
  (``poll_events``).

Run:  python -m firewheel_tpu_torch.examples.game_server
"""

from __future__ import annotations

import numpy as np

from ..core.sample_resource import SampleResource
from ..device import DEFAULT_DEVICE
from ..executor import ScheduleProgram
from ..graph import AudioGraph, AudioGraphConfig
from ..nodes import BeepTestNode, SamplerNode, StereoPanNode, SumNode, VolumeNode
from ..parallel import BatchRenderer

SR, BLOCK, K = 48000, 128, 16
B = 16  # game instances


def build_game_graph(device=DEFAULT_DEVICE):
    """One game's audio: two tones → volume → pan, plus a one-shot SFX
    sampler summed in (its finish is reported per instance via events).
    Returns ``(graph, program, node ids)``."""
    g = AudioGraph(AudioGraphConfig(0, 2))
    music = g.add_node(0, 2, BeepTestNode(330.0, -18.0, True))
    vol = g.add_node(2, 2, VolumeNode(100.0))
    pan = g.add_node(2, 2, StereoPanNode(0.0))
    sfx_node = SamplerNode(100.0)
    rng = np.random.default_rng(0)
    sfx_node.set_sample(SampleResource(
        (rng.standard_normal((2, 1024)) * 0.05).astype(np.float32),
        device=False,
    ))
    sfx = g.add_node(0, 2, sfx_node)
    g.connect(music, 0, vol, 0)
    g.connect(music, 1, vol, 1)
    g.connect(vol, 0, pan, 0)
    g.connect(vol, 1, pan, 1)
    mix = g.add_node(4, 2, SumNode())
    g.connect(pan, 0, mix, 0)
    g.connect(pan, 1, mix, 1)
    g.connect(sfx, 0, mix, 2)
    g.connect(sfx, 1, mix, 3)
    g.connect(mix, 0, g.graph_out_node(), 0)
    g.connect(mix, 1, g.graph_out_node(), 1)
    pkg = g.compile(SR, BLOCK)
    prog = ScheduleProgram(pkg.schedule, dict(pkg.new_node_processors), SR,
                           device=device)
    return g, prog, {"music": music, "vol": vol, "pan": pan, "sfx": sfx}


def main(device=DEFAULT_DEVICE) -> dict:
    """Serve B instances on ``device``: bring-up, one poll, a mute and a
    reconnect, eight more dispatches.  Returns ``finished`` (the instances
    whose SFX finished), ``rms`` (each instance's over the last 4 blocks)
    and ``instance_seconds``."""
    g, prog, ids = build_game_graph(device)
    br = BatchRenderer(prog, batch=B, device=device)

    # per-instance bring-up: each game gets its own pan position, and the
    # even-numbered games fire their SFX one-shot at t=0
    plist = []
    for b in range(B):
        g.node(ids["pan"]).set_pan(-1.0 + 2.0 * b / (B - 1))
        sfx = g.node(ids["sfx"])
        if b % 2 == 0:
            sfx.play()
        else:
            sfx.pause()
        plist.append(prog.collect_params())
    params = br.stack_params(plist)
    state = br.init_state()

    sample = 0

    def dispatch():
        nonlocal state, sample
        out, om, state = br.render_chunk(
            params, state, start_sample=sample, num_blocks=K
        )
        sample += K * BLOCK
        return out.cpu().numpy()  # [B, K, 2, F]

    out = dispatch()
    print(f"serving {B} instances on {br.device}, {out.shape} per dispatch "
          f"({K * BLOCK / SR * 1e3:.1f} ms of audio each)")

    # --- events: which games' SFX finished? (device counters, one poll) ---
    done = sorted(e.instance for e in br.poll_events(state)
                  if e.name == "finished")
    print(f"SFX finished in instances: {done}")
    assert done == [b for b in range(B) if b % 2 == 0], done

    # --- control plane: player 7 mutes; player 3 reconnects ---------------
    g.node(ids["vol"]).set_percent_volume(0.0)
    g.node(ids["pan"]).set_pan(-1.0 + 2.0 * 7 / (B - 1))
    params = br.update_instance(params, 7, prog.collect_params())
    state = br.reset_instance(state, 3)

    # let instance 7's mute ramp settle (10 ms smoother), then check
    for _ in range(8):
        out = dispatch()

    rms = out[:, -4:].std(axis=(1, 2, 3))
    print("per-instance rms (instance 7 muted):")
    print("  " + "  ".join(f"{b}:{rms[b]:.4f}" for b in range(B)))
    assert rms[7] < 1e-6, "muted instance still audible"
    assert all(rms[b] > 1e-3 for b in range(B) if b != 7), "instance lost"
    seconds = B * sample / SR
    print("OK: per-instance control isolated; "
          f"{seconds:.1f} instance-seconds rendered")
    return {"finished": done, "rms": rms, "instance_seconds": seconds}


if __name__ == "__main__":
    main()
