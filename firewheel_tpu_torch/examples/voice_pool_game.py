"""Voice pool on the port: fire-and-forget game audio over a fixed sampler
bank.

An 8-voice :class:`~firewheel_tpu_torch.voice_pool.VoicePool` plays a
little synthesized battle (footsteps, laser shots, an explosion, a looping
engine hum) with overlapping sample-accurate triggers, priority stealing,
and per-shot gain/pan/pitch.  The topology never changes after activation:
every ``play()`` is parameter traffic only (no recompile), and the 8
identical pooled samplers render as ONE batched group.

Run:  python -m firewheel_tpu_torch.examples.voice_pool_game [out.wav]
"""

from __future__ import annotations

import sys
import zlib

import numpy as np

from ..backend import FirewheelCtx, StreamConfig, WavSink
from ..core.sample_resource import SampleResource
from ..device import DEFAULT_DEVICE
from ..graph import AudioGraphConfig
from ..voice_pool import VoicePool

SR = 48000
F = 128


def synth_clip(kind: str) -> SampleResource:
    """Tiny procedural sound effects (no asset files needed).  The noise
    is seeded from the CRC-32 of ``kind``, the same in every process."""
    rng = np.random.default_rng(zlib.crc32(kind.encode()) & 0xFFFF)
    if kind == "footstep":  # 40 ms filtered noise thump
        n = int(0.04 * SR)
        x = rng.standard_normal(n).astype(np.float32)
        env = np.exp(-np.linspace(0, 9, n)).astype(np.float32)
        for _ in range(3):  # crude lowpass
            x = np.convolve(x, np.ones(8, np.float32) / 8, "same")
        return SampleResource((x * env)[None, :] * 2.0, sample_rate=SR)
    if kind == "laser":  # 120 ms descending chirp
        n = int(0.12 * SR)
        t = np.arange(n, dtype=np.float32) / SR
        f = 2600.0 * np.exp(-t * 18.0) + 300.0
        ph = np.cumsum(2 * np.pi * f / SR).astype(np.float32)
        env = np.exp(-t * 25.0).astype(np.float32)
        return SampleResource((np.sin(ph) * env * 0.8)[None, :], sample_rate=SR)
    if kind == "explosion":  # 600 ms noise burst with rumble
        n = int(0.6 * SR)
        t = np.arange(n, dtype=np.float32) / SR
        x = rng.standard_normal(n).astype(np.float32)
        for _ in range(4):
            x = np.convolve(x, np.ones(16, np.float32) / 16, "same")
        rumble = np.sin(2 * np.pi * 55.0 * t) * np.exp(-t * 4.0)
        env = np.exp(-t * 6.0).astype(np.float32)
        return SampleResource(
            ((x * 3.0 + rumble) * env)[None, :].astype(np.float32),
            sample_rate=SR,
        )
    if kind == "engine":  # 250 ms loopable hum
        n = int(0.25 * SR)
        t = np.arange(n, dtype=np.float32) / SR
        x = sum(
            np.sin(2 * np.pi * f0 * t) * a
            for f0, a in ((82.0, 0.5), (164.0, 0.25), (123.0, 0.15))
        )
        return SampleResource(x[None, :].astype(np.float32), sample_rate=SR)
    raise ValueError(kind)


def main(out_path: str = "voice_pool_game.wav", device=DEFAULT_DEVICE) -> dict:
    """Play 6 s of the battle on ``device`` into ``out_path`` in ticks of
    330 ms.  Returns each shot's handle (``(voice, generation)``
    or None when every voice outranked it) and the voices still active at
    the end."""
    cx = FirewheelCtx(AudioGraphConfig(0, 2), device=device)
    pool = VoicePool(
        cx.graph, num_voices=8, max_clip_frames=1 << 15, declick_secs=0.003
    )
    clips = {k: synth_clip(k)
             for k in ("footstep", "laser", "explosion", "engine")}
    pool.preload(*clips.values())

    sink = WavSink(out_path, SR, 2)
    cx.activate(StreamConfig(SR, 2, buffer_frames=512), sink=sink)

    shots = []

    def play(clip, **kw):
        h = pool.play(clips[clip], **kw)
        shots.append(None if h is None else (h._index, h._gen))
        return h

    duration = 6.0
    # The game-loop pattern: each tick schedules the NEXT tick's sounds a
    # little ahead (sample-accurate `when=`), then renders the tick.
    # Per-shot gain/pan/pitch are immediate params, so a voice's settings
    # must land after its previous sound has rendered: interleaving
    # schedule/render (what a game's audio frame does) guarantees that;
    # the pool's busy accounting handles allocation and stealing.
    engine = play("engine", loop=True, gain_db=-18.0, priority=10, when=F, now=0)
    rng = np.random.default_rng(7)
    tick = 0.33
    lead = int(0.05 * SR)  # schedule 50 ms ahead of the render head
    boom_at = int(3.0 * SR)
    boomed = False
    t = 0.0
    while t < duration:
        # the authoritative clock is the RENDER head, not wall/tick time
        now = cx.stream.frames_rendered
        when = now + lead
        if 0.2 < t < duration - 0.9:
            play("footstep", gain_db=-8.0 - rng.uniform(0, 3),
                 pan=rng.uniform(-0.4, 0.4),
                 rate=rng.uniform(0.92, 1.08), when=when, now=now)
            if rng.random() < 0.55:
                play("laser", gain_db=-10.0, pan=rng.uniform(-1, 1),
                     rate=rng.uniform(0.8, 1.3),
                     when=when + int(0.1 * SR), now=now)
        if not boomed and when >= boom_at:
            play("explosion", gain_db=-9.0, priority=5, when=when, now=now)
            if engine is not None:
                engine.set_gain_db(-24.0)  # duck the hum under the blast
            boomed = True
        step = min(tick, duration - t)
        cx.render_offline(step)
        t += step

    active = pool.active_voices(now=cx.stream.frames_rendered)
    cx.deactivate()
    print(f"rendered {duration:.0f}s of battle into {out_path} "
          f"({active} voice(s) still looping at the end)")
    return {"path": out_path, "shots": shots, "active": active}


if __name__ == "__main__":
    main(*sys.argv[1:2])
