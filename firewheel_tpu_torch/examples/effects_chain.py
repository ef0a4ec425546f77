"""Effects chain: BASELINE config 4 end to end on the port.

    sampler ── biquad filter ── echo ── hard clip ── convolution reverb ── out

A synthesized Karplus-Strong pluck plays through the full effects chain
via the streaming context (``FirewheelCtx``), with live control during the
stream: the pluck retriggers at different playback rates (the sampler's
cubic resampler) and the filter cutoff sweeps down and back up.  The
filter is ``FilterNode``'s ``"auto"`` backend, one launch of the
associative scan (``ops/iir.py:biquad_scan``) a block; the 0.6 s room
takes the reverb's FFT engine.  The bounce lands in a WAV file.

Run:  python -m firewheel_tpu_torch.examples.effects_chain [out.wav]
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np

from ..backend import FirewheelCtx, StreamConfig, WavSink
from ..context import UpdateStatus
from ..core.sample_resource import SampleResource
from ..device import DEFAULT_DEVICE
from ..mixer import exp_decay_ir, karplus_strong_pluck
from ..nodes import (
    ConvolutionReverbNode,
    EchoNode,
    FilterNode,
    HardClipNode,
    SamplerNode,
)

SR = 48000
DURATION_SECS = 6.0
#: (stream second, playback rate) of each retrigger of the pluck
TRIGGERS = ((0.0, 1.0), (1.0, 1.5), (2.0, 0.75), (3.0, 2.0), (4.0, 1.0))


def cutoff_hz(t: float) -> float:
    """The cutoff sweep at stream second ``t``: 6 kHz -> 600 Hz -> 6 kHz
    over the stream."""
    sweep = 0.5 - 0.5 * np.cos(2 * np.pi * t / DURATION_SECS)
    return 6000.0 * (0.1 + 0.9 * (1.0 - sweep))


def main(out: str | None = None, device=DEFAULT_DEVICE) -> dict:
    """Stream DURATION_SECS of the chain on ``device`` into the WAV ``out``
    (a file in the temporary directory by default), the control script
    keyed to stream time.  Returns the WAV's path, the frames rendered and
    the ``update()`` calls made."""
    out = out or os.path.join(tempfile.gettempdir(), "effects_chain.wav")
    cx = FirewheelCtx(device=device)
    g = cx.graph

    pluck = karplus_strong_pluck(220.0, 1.2)
    sampler_node = SamplerNode(percent_volume=100.0, quality="cubic")
    sampler_node.set_sample(SampleResource(pluck))

    sampler = g.add_node(0, 2, sampler_node)
    filt_node = FilterNode("lowpass", frequency_hz=6000.0, q=0.9)
    filt = g.add_node(2, 2, filt_node)
    echo = g.add_node(2, 2, EchoNode(delay_secs=0.28, feedback=0.35, wet=0.4))
    clip = g.add_node(2, 2, HardClipNode(threshold_db=-3.0))
    rev = g.add_node(
        2, 2, ConvolutionReverbNode(exp_decay_ir(0.6, 0.5), wet=0.35)
    )
    go = g.graph_out_node()

    chain = [sampler, filt, echo, clip, rev, go]
    for src, dst in zip(chain[:-1], chain[1:]):
        for ch in range(2):
            g.connect(src, ch, dst, ch)

    cfg = StreamConfig(sample_rate=SR, num_out_channels=2)
    sink = WavSink(out, cfg.sample_rate, cfg.num_out_channels)
    cx.activate(cfg, sink=sink, duration_secs=DURATION_SECS)

    # live control script keyed to STREAM time (frames rendered), not wall
    # time: automation lands at the same point in the audio whether the
    # stream is paced realtime or renders offline through first-call stalls
    next_trig = 0
    sampler_node.play()

    target_frames = int(SR * DURATION_SECS)
    updates = 0
    deadline = time.monotonic() + 900.0  # wall safety cap
    while time.monotonic() < deadline:
        t = cx.stream.frames_rendered / SR if cx.stream else 0.0
        if next_trig < len(TRIGGERS) and t >= TRIGGERS[next_trig][0]:
            _, rate = TRIGGERS[next_trig]
            sampler_node.set_playback_rate(rate)
            sampler_node.set_playhead(0.0)
            sampler_node.play()
            next_trig += 1
        filt_node.set_frequency(cutoff_hz(t))
        result = cx.update()
        updates += 1
        if result.status == UpdateStatus.DEACTIVATED:
            print("deactivated unexpectedly:", result.error)
            break
        if cx.stream and cx.stream.frames_rendered >= target_frames:
            break

    frames = cx.stream.frames_rendered if cx.stream else 0
    cx.deactivate()
    print(f"effects chain bounce → {out}")
    return {"path": out, "frames": frames, "updates": updates}


if __name__ == "__main__":
    main(*sys.argv[1:2])
