"""The realtime stream's drain of its paced consumer's output ring
(``backend/stream.py:OutputStream._drain_out_ring``) against a sink that
takes frames more slowly than the stream rate, as a sound device on its
own clock may: the paced consumer forwards a period every 5.3 ms, silence
when the render falls behind, so a drain that ran until the ring was
empty never returned, nor did ``update()``.  Each drain now moves the
frames the ring held when it began."""

import threading
import time

import firewheel_tpu_torch as ft
from firewheel_tpu_torch import nodes as tn


class SlowSink(ft.ArraySink):
    """Takes each write's frames in 1.5 times their duration at 48 kHz."""

    def write(self, interleaved, num_channels):
        time.sleep(1.5 * len(interleaved) / num_channels / 48000)
        super().write(interleaved, num_channels)


def test_update_returns_against_a_sink_slower_than_the_stream():
    cx = ft.FirewheelCtx(device="cpu")
    g = cx.graph_mut()
    beep = g.add_node(0, 2, tn.BeepTestNode(440.0, -12.0, True))
    for ch in range(2):
        g.connect(beep, ch, g.graph_out_node(), ch)
    sink = SlowSink()
    cx.activate(ft.StreamConfig(buffer_frames=256, realtime=True), sink=sink)
    assert cx.stream.stats()["consumer"] == "native"
    updates = []

    def engine():
        # the game's loop: update() every 5 ms for a second of wall time
        end = time.monotonic() + 1.0
        while time.monotonic() < end:
            cx.update()
            updates.append(time.monotonic())
            time.sleep(0.005)

    thread = threading.Thread(target=engine, daemon=True)
    thread.start()
    thread.join(timeout=30)
    assert not thread.is_alive(), "update() did not return: the drain chased the paced consumer"
    cx.deactivate()
    assert len(updates) >= 3
    audio = sink.audio(2)
    assert audio.shape[1] >= 256 and abs(audio).max() > 0.1
