"""Differentiable mixing on the port: gradient-descend node parameters to
hit a target.

The whole compiled graph render is differentiable, so mixing decisions
become an optimization problem.  Three detuned voices with unknown gains
are auto-balanced so the rendered mix matches a target loudness profile:
torch autograd flows through the beeps, the volume smoothers, the pan and
the sum node (``ScheduleProgram.chunk_fn``).  Each voice is probed alone,
the three probes as three instances of one batch.

Run:  python -m firewheel_tpu_torch.examples.autotune_mix
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..executor import ScheduleProgram, node_key
from ..graph import AudioGraph, AudioGraphConfig
from ..nodes import BeepTestNode, StereoPanNode, SumNode, VolumeNode
from ..parallel import BatchRenderer

SR, F = 48000, 256
#: blocks a probe renders: past the 10 ms gain smoothers (settled after
#: about 5500 samples); only the last block is measured
BLOCKS = 24
STEPS = 80
RATE = 8.0
#: each voice's RMS in the target mix
TARGET = (0.05, 0.10, 0.02)


def build_mix(device=DEFAULT_DEVICE):
    """Three beeps (220, 440, 880 Hz, -6 dB) through volumes into a sum, a
    pan, out, at 48 kHz in blocks of F frames.  Returns ``(program on
    device, the volumes' param keys)``."""
    g = AudioGraph(AudioGraphConfig(0, 2))
    vols = []
    mixer = g.add_node(6, 2, SumNode())
    for i, freq in enumerate((220.0, 440.0, 880.0)):
        beep = g.add_node(0, 2, BeepTestNode(freq, -6.0, True))
        vol = g.add_node(2, 2, VolumeNode(100.0))
        g.connect(beep, 0, vol, 0)
        g.connect(beep, 1, vol, 1)
        g.connect(vol, 0, mixer, 2 * i)
        g.connect(vol, 1, mixer, 2 * i + 1)
        vols.append(vol)
    pan = g.add_node(2, 2, StereoPanNode(0.0))
    g.connect(mixer, 0, pan, 0)
    g.connect(mixer, 1, pan, 1)
    g.connect(pan, 0, g.graph_out_node(), 0)
    g.connect(pan, 1, g.graph_out_node(), 1)

    pkg = g.compile(SR, F)
    prog = ScheduleProgram(pkg.schedule, dict(pkg.new_node_processors), SR,
                           device=device)
    return prog, [node_key(v) for v in vols]


def voice_probe(prog: ScheduleProgram, keys, device=DEFAULT_DEVICE):
    """``fn(gains f32[3]) -> (loss, rms f32[3])``: instance ``i`` of a
    batch of three renders voice ``i`` alone (the others' gains zeroed)
    for BLOCKS blocks; ``rms`` is each instance's over its last block and
    ``loss`` the squared distance to TARGET, differentiable in ``gains``."""
    device = resolve_device(device)
    br = BatchRenderer(prog, 3, device=device)
    params, state = br.stack_params(), br.init_state()
    target = torch.tensor(TARGET, device=device)
    sel = torch.eye(3, device=device)
    chunk = prog.chunk_fn(BLOCKS)
    zeros = (torch.zeros((3, BLOCKS, 0, F), device=device),
             torch.zeros((3, BLOCKS, 0), dtype=torch.bool, device=device))

    def probe(gains):
        p = {key: dict(v) for key, v in params.items()}
        for v, key in enumerate(keys):
            p[key]["raw_gain"] = gains[v] * sel[:, v]
        out, _, _ = chunk(p, state, *zeros, 0, 0)
        rms = (out[:, -1] ** 2).mean(dim=(1, 2)).sqrt()
        return ((rms - target) ** 2).sum(), rms

    return probe


def main(device=DEFAULT_DEVICE) -> dict:
    """Fit the three gains on ``device``: STEPS of gradient descent at
    RATE, clipped to [0, 4], from 0.5 each.  Returns the initial loss, the
    gains after every step (``f32[STEPS, 3]``), the loss after every 20th
    step, the final gains, loss and per-voice RMS."""
    prog, keys = build_mix(device)
    probe = voice_probe(prog, keys, device)

    def loss_of(gains):
        with torch.no_grad():
            return float(probe(gains)[0])

    gains = torch.full((3,), 0.5, device=prog.device)
    initial = loss_of(gains)
    print("initial loss:", initial)
    trajectory, curve = [], {}
    for step in range(STEPS):
        g = gains.detach().requires_grad_()
        (grad,) = torch.autograd.grad(probe(g)[0], g)
        gains = (gains - RATE * grad).clamp(0.0, 4.0)
        trajectory.append(gains.cpu().numpy())
        if step % 20 == 19:
            curve[step + 1] = loss_of(gains)
            print(f"step {step+1}: loss {curve[step + 1]:.2e}, "
                  f"gains {trajectory[-1].round(4)}")
    with torch.no_grad():
        loss, rms = probe(gains)
    got = rms.cpu().numpy()
    print("target per-voice rms:", np.asarray(TARGET))
    print("achieved per-voice rms:", got.round(4))
    assert float(loss) < 1e-6
    print("auto-mix converged ✓")
    return {"initial_loss": initial, "trajectory": np.stack(trajectory),
            "curve": curve, "gains": trajectory[-1], "loss": float(loss), "rms": got}


if __name__ == "__main__":
    main()
