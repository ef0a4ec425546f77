"""Beep test: the minimal end-to-end engine example on the port.

Add a ``BeepTestNode`` (440 Hz, -12 dB) → connect both ports to graph out
→ activate → poll ``update()`` every 15 ms for 4 seconds (the reference's
``examples/beep_test/src/main.rs:10-52``).  Instead of an OS speaker the
stream renders into a WAV file; ``--play`` plays it on the OS speakers
through ``SoundDeviceSink`` (needs sounddevice), paced in realtime.

Run:  python -m firewheel_tpu_torch.examples.beep_test [out.wav]
      python -m firewheel_tpu_torch.examples.beep_test --play
"""

from __future__ import annotations

import sys
import time

from ..backend import FirewheelCtx, StreamConfig, WavSink
from ..context import UpdateStatus
from ..device import DEFAULT_DEVICE
from ..nodes import BeepTestNode

BEEP_FREQUENCY_HZ = 440.0
BEEP_GAIN_DB = -12.0
BEEP_DURATION_SECS = 4.0
UPDATE_INTERVAL_SECS = 0.015


def add_beep(graph):
    """The beep (440 Hz, -12 dB, on) into both of ``graph``'s outputs;
    returns its node id."""
    beep_node = graph.add_node(
        0, 2, BeepTestNode(BEEP_FREQUENCY_HZ, BEEP_GAIN_DB, True)
    )
    graph.connect(beep_node, 0, graph.graph_out_node(), 0)
    graph.connect(beep_node, 1, graph.graph_out_node(), 1)
    return beep_node


def main(out_path: str = "beep_test.wav", device=DEFAULT_DEVICE) -> dict:
    """Stream the beep on ``device`` into the WAV ``out_path`` (or, with
    ``out_path == "--play"``, to the OS speakers), polling ``update()``
    every 15 ms until 4 s of audio or 4 s of wall time.  Returns the WAV's
    path (or, played, the sink's underflows), the frames rendered and the
    updates made."""
    print("Firewheel beep test...")

    play = out_path == "--play"
    cx = FirewheelCtx(device=device)
    add_beep(cx.graph_mut())

    if play:
        # real OS speakers through the optional sounddevice backend;
        # realtime pacing keeps the device ring fed
        from ..backend.os_audio import SoundDeviceSink

        cfg = StreamConfig(sample_rate=48000, num_out_channels=2, realtime=True)
        sink = SoundDeviceSink(cfg.sample_rate, cfg.num_out_channels)
    else:
        cfg = StreamConfig(sample_rate=48000, num_out_channels=2)
        sink = WavSink(out_path, cfg.sample_rate, cfg.num_out_channels)
    cx.activate(cfg, sink=sink, duration_secs=BEEP_DURATION_SECS)

    updates = frames = 0
    start = time.monotonic()
    while time.monotonic() - start < BEEP_DURATION_SECS:
        time.sleep(UPDATE_INTERVAL_SECS)
        result = cx.update()
        updates += 1
        if result.status == UpdateStatus.ACTIVE and result.graph_error:
            print("graph error:", result.graph_error)
        elif result.status == UpdateStatus.DEACTIVATED:
            print("Deactivated unexpectedly:", result.error)
            break
        if cx.stream:
            frames = cx.stream.frames_rendered
            if frames >= cfg.sample_rate * BEEP_DURATION_SECS:
                break

    cx.deactivate()
    if play:
        sink.close()
        print(f"finished (played {sink.underflow_count} underflows)")
        return {"frames": frames, "updates": updates, "underflows": sink.underflow_count}
    print(f"finished → {out_path}")
    return {"path": out_path, "frames": frames, "updates": updates}


if __name__ == "__main__":
    main(*sys.argv[1:2])
