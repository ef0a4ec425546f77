"""Mastering bus: dynamics + loudness workflow on the port.

A music bed (pink noise) and a dialogue voice (beep) run through the
game-audio master chain:

    music ──┐
            ├── ducker (dialogue sidechain) ── compressor ──
    voice ──┘      linear-phase FIR high-shelf ── limiter ── out
                                                      │
                                               loudness meter

While the stream runs, dialogue toggles on and off (the music ducks under
it), and the loudness meter is polled every ~100 ms to feed the EBU R128
integrated-loudness gate.  Finishes by printing the measured program
loudness and writing the bounce to a WAV file.  On the card each 256-frame
block launches the sample scan (``csrc/sample_scan.cu``) four times (the
ducker's and the compressor's envelopes, the limiter, the pink filter),
the noise generator (``csrc/noise.cu``) once and the meter's K-weighting
cascade (``csrc/assoc_scan.cu``) once.

Run:  python -m firewheel_tpu_torch.examples.mastering_bus [out.wav]
"""

from __future__ import annotations

import os
import sys
import tempfile

from ..backend import FirewheelCtx, StreamConfig, WavSink
from ..device import DEFAULT_DEVICE
from ..mixer import add_mastering_bus
from ..nodes import IntegratedLoudness, LoudnessMeterNode

SR = 48000
SECS = 4.0
BUFFER_FRAMES = 256
#: stream seconds between which the dialogue line is on
DIALOGUE = (1.0, 2.5)


def dialogue_on(sec: float) -> bool:
    """Whether the dialogue line plays at stream second ``sec``."""
    return DIALOGUE[0] < sec < DIALOGUE[1]


def main(out: str | None = None, device=DEFAULT_DEVICE) -> dict:
    """Stream SECS of the bus on ``device`` in BUFFER_FRAMES buffers into
    the WAV ``out`` (a file in the temporary directory by default).
    Returns the WAV's path, each poll's ``(momentary, short-term, gating
    block)`` LUFS, the integrated loudness and the final short-term
    loudness."""
    out = out or os.path.join(tempfile.gettempdir(), "mastering_bus.wav")
    cx = FirewheelCtx(device=device)
    ids = add_mastering_bus(cx.graph)  # the nodes in the example's order
    voice_node = cx.graph.node(ids["voice"])
    meter = ids["meter"]

    sink = WavSink(out, SR, 2)
    cx.activate(StreamConfig(SR, 2, buffer_frames=BUFFER_FRAMES), sink=sink,
                duration_secs=SECS)

    integ = IntegratedLoudness()
    stream = cx.stream
    polled = 0
    reads = []
    while not stream.finished:
        if stream.error is not None:
            raise stream.error
        cx.update()
        sec = stream.frames_rendered / SR
        voice_node.set_enabled(dialogue_on(sec))
        if polled < int(sec * 10):
            r = LoudnessMeterNode.read(cx.node_state(meter))
            integ.push(r["gating_block_lufs"])
            reads.append((r["momentary_lufs"], r["short_term_lufs"],
                          r["gating_block_lufs"]))
            polled += 1
            if polled % 10 == 0:
                print(
                    f"  t={sec:4.1f}s momentary {r['momentary_lufs']:6.1f} "
                    f"LUFS  short-term {r['short_term_lufs']:6.1f} LUFS"
                )

    r = LoudnessMeterNode.read(cx.node_state(meter))
    cx.deactivate()
    print(f"program loudness (gated, integrated): {integ.value():.1f} LUFS")
    print(f"final short-term: {r['short_term_lufs']:.1f} LUFS")
    print(f"wrote {out}")
    return {"path": out, "reads": reads, "integrated": integ.value(),
            "short_term": r["short_term_lufs"]}


if __name__ == "__main__":
    main(*sys.argv[1:2])
