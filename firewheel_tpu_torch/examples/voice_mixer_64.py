"""64-voice mixer: sample players with resampling → summation → gain/pan bus.

BASELINE config 3 on the port: 64 sampler voices loop short clips at
per-voice playback rates (±3 semitones), feed two levels of sums (four
groups of 16 stereo voices, then the groups), then a volume/pan/clip
master bus (:func:`~firewheel_tpu_torch.mixer.add_voice_mixer_64`).
Streamed offline through ``FirewheelCtx`` to a WAV, 1024-frame buffers,
8 a dispatch.

Run:  python -m firewheel_tpu_torch.examples.voice_mixer_64 [out.wav]
"""

from __future__ import annotations

import sys

from ..backend import FirewheelCtx, StreamConfig, WavSink
from ..device import DEFAULT_DEVICE
from ..mixer import SR, add_voice_mixer_64

NUM_VOICES = 64
SECS = 2.0


def stream_config() -> StreamConfig:
    """The example's stream: 48 kHz stereo, 1024-frame buffers (and
    blocks), 8 buffers a dispatch."""
    return StreamConfig(SR, 2, buffer_frames=1024, chunk_buffers=8)


def main(out_path: str = "voice_mixer_64.wav", device=DEFAULT_DEVICE,
         secs: float = SECS) -> dict:
    """Render ``secs`` of the mix on ``device`` to ``out_path``; returns the
    stream's stats (``OutputStream.stats``)."""
    cx = FirewheelCtx(device=device)
    add_voice_mixer_64(cx.graph_mut(), NUM_VOICES)
    sink = WavSink(out_path, SR, 2)
    cx.activate(stream_config(), sink=sink)
    cx.render_offline(secs)
    stats = cx.stream.stats()
    cx.deactivate()

    print(
        f"rendered {secs} s of {NUM_VOICES}-voice mix on {cx.device} → {out_path}  "
        f"(render/buffer p50 {stats['render_ms_p50']:.2f} ms, "
        f"p99 {stats['render_ms_p99']:.2f} ms / "
        f"{stats['buffer_budget_ms']:.2f} ms budget)"
    )
    return stats


if __name__ == "__main__":
    main(*sys.argv[1:2])
