"""Live-input insert chain: process an external feed through the graph.

    external stereo input ── filter ── echo ── hard clip ── out

The feed comes from an ``input_source`` callable (a capture device, a
network stream, another engine's bus: anything that returns ``[ch, n]``
f32 on demand) and the graph runs it through an insert chain on the card.
The demo feed is a 500 Hz + 9 kHz two-tone, so the 3 kHz lowpass's work
shows in the output spectrum.  The filter is ``FilterNode``'s ``"auto"``
backend: one launch of the associative scan (``ops/iir.py:biquad_scan``)
a block.

Run:  python -m firewheel_tpu_torch.examples.input_effects [out.wav]
      python -m firewheel_tpu_torch.examples.input_effects --mic

``--mic`` swaps the synthetic feed for a real OS capture device
(``SoundDeviceSource``, needs sounddevice) and streams it through the
same insert chain in realtime to the OS speakers: live monitoring.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np

from ..backend import FirewheelCtx, StreamConfig, WavSink
from ..device import DEFAULT_DEVICE
from ..graph import AudioGraphConfig
from ..nodes import EchoNode, FilterNode, FilterType, HardClipNode

SR = 48000
SECS = 2.0


def two_tone():
    """The demo's 'capture device': 500 Hz fundamental + 9 kHz hiss, a
    callable returning ``[2, n]`` f32 frames in order."""
    pos = [0]

    def input_source(n):
        t = (pos[0] + np.arange(n)) / SR
        pos[0] += n
        x = 0.4 * np.sin(2 * np.pi * 500.0 * t) + 0.3 * np.sin(
            2 * np.pi * 9000.0 * t
        )
        return np.stack([x, x]).astype(np.float32)

    return input_source


def monitor(cx: FirewheelCtx) -> None:
    """Live monitoring for 10 s: the OS capture device → the chain → the
    speakers."""
    from ..backend.os_audio import SoundDeviceSink, SoundDeviceSource, os_audio_available

    if not os_audio_available():
        sys.exit("--mic needs the optional sounddevice package")
    src = SoundDeviceSource(SR, num_channels=2)
    sink = SoundDeviceSink(SR, 2)
    cx.activate(StreamConfig(SR, 2, num_in_channels=2, realtime=True),
                sink=sink, input_source=src)
    print("monitoring live input for 10 s (ctrl-c to stop)...")
    try:
        end = time.time() + 10.0
        while time.time() < end:
            cx.update()
            time.sleep(0.015)
    finally:
        cx.deactivate()
        src.close()
        sink.close()
        print(f"capture starves: {src.starve_count}, "
              f"overflows: {src.overflow_count}")


def main(out: str | None = None, mic: bool = False, device=DEFAULT_DEVICE) -> str | None:
    """Run the chain on ``device``: 2 s of the two-tone feed into the WAV
    ``out`` (a file in the temporary directory by default), or with ``mic``
    the capture device to the speakers.  Returns the WAV's path."""
    cx = FirewheelCtx(AudioGraphConfig(num_graph_inputs=2, num_graph_outputs=2),
                      device=device)
    g = cx.graph
    filt = g.add_node(2, 2, FilterNode(FilterType.LOWPASS, 3000.0))
    echo = g.add_node(2, 2, EchoNode(delay_secs=0.1, feedback=0.3, wet=0.5))
    clip = g.add_node(2, 2, HardClipNode(-1.0))
    gi, go = g.graph_in_node(), g.graph_out_node()
    for c in range(2):
        g.connect(gi, c, filt, c)
        g.connect(filt, c, echo, c)
        g.connect(echo, c, clip, c)
        g.connect(clip, c, go, c)
    if mic:
        monitor(cx)
        return None
    out = out or os.path.join(tempfile.gettempdir(), "input_effects.wav")
    cx.activate(StreamConfig(SR, 2, num_in_channels=2), sink=WavSink(out, SR, 2),
                input_source=two_tone())
    cx.render_offline(SECS)
    cx.deactivate()
    print(f"processed {SECS} s of live input on {cx.device} → {out}")
    return out


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    main(args[0] if args else None, mic="--mic" in sys.argv[1:])
