"""The port's music player (``firewheel_tpu_torch/music.py``, a copy of the
JAX package's over the port's streaming decks) held against the JAX
package's on the CPU.

A shortened ``examples/music_player.py`` session runs through both
packages' ``FirewheelCtx`` (the port's with ``device="cpu"``): tracks
written from a seed (a WAV intro, a FLAC bed by ``encode_flac`` whose
length is not a block multiple, a WAV outro), the intro played, the bed
queued with a crossfade, then looped past its seam, a crossfade to the
outro and a faded stop.  The audio is held at 1e-6 and the finish events
reported by ``MusicPlayer.poll`` must be equal.  The JAX decks run with
the reference's window refill copying (see
``tests/test_torch_streaming_sampler.py``).
"""

import os

import numpy as np
import pytest

import firewheel_tpu as fj
import firewheel_tpu_torch as ft
from firewheel_tpu_torch.utils.flac_encode import encode_flac
from firewheel_tpu_torch.utils.wav import write_wav

from test_torch_streaming_sampler import _safe_jax_refill  # noqa: F401

SR = 48000


def write_track(path, freqs, secs, seed, level=0.4):
    """An arpeggio with a little noise, 48 kHz stereo."""
    n = int(round(secs * SR))
    t = np.arange(n) / SR
    sig = np.zeros(n)
    step = max(1, n // (4 * len(freqs)))
    for i in range(0, n, step):
        seg = slice(i, min(i + step, n))
        sig[seg] = np.sin(2 * np.pi * freqs[(i // step) % len(freqs)] * t[seg]) \
            * np.exp(-3.0 * (t[seg] - t[seg.start]))
    noise = np.random.default_rng(seed).standard_normal((2, n)) * 0.01
    audio = (level * np.stack([sig, 0.8 * sig]) + noise).astype(np.float32)
    if path.endswith(".flac"):
        encode_flac(audio, SR, path=path)
    else:
        write_wav(path, audio, SR, dtype="i16")


@pytest.fixture(scope="module")
def tracks(tmp_path_factory):
    d = tmp_path_factory.mktemp("music")
    paths = [str(d / name) for name in ("intro.wav", "bed.flac", "outro.wav")]
    write_track(paths[0], [220, 277, 330], 0.6, seed=1)
    # 0.35 s + 17 frames: 16817 frames, not a block multiple (a sub-block seam)
    write_track(paths[1], [110, 165, 220], 16817 / SR, seed=2)
    write_track(paths[2], [330, 277, 220], 0.5, seed=3)
    return paths


def session(pkg, tracks, chunk_buffers=1):
    """The example's session, shortened: returns the audio and the
    finished tracks' names in poll order."""
    intro, bed, outro = tracks
    cx = pkg.FirewheelCtx(device="cpu") if pkg is ft else pkg.FirewheelCtx()
    player = pkg.MusicPlayer(cx.graph_mut(), clock=lambda: cx.stream.frames_rendered,
                             window_secs=0.25)
    sink = pkg.ArraySink()
    cx.activate(pkg.StreamConfig(SR, 2, buffer_frames=512, chunk_buffers=chunk_buffers),
                sink=sink)
    finished = []

    def run(secs, steps):
        for _ in range(steps):
            cx.render_offline(secs)
            player.update()
            finished.extend(os.path.basename(getattr(r, "path", "?") or "?")
                            for _, r in player.poll(cx.poll_events()))

    player.play(intro)
    player.queue(bed, crossfade_secs=0.2)
    run(0.2, 4)
    player.play(bed, loop=True)
    run(0.2, 4)            # past the bed's seam at least once
    player.crossfade_to(outro, 0.2)
    run(0.2, 2)
    player.stop(fade_secs=0.1)
    run(0.2, 1)
    cx.deactivate()
    return sink.audio(2), finished


def test_music_session_matches_jax(tracks):
    ja, je = session(fj, tracks)
    ta, te = session(ft, tracks)
    assert ta.shape == ja.shape
    np.testing.assert_allclose(ta, ja, atol=1e-6, rtol=0)
    assert te == je and len(te) >= 3
    assert np.abs(ta).max() > 0.1
    assert (ta[:, -2000:] == 0).all()  # the faded stop went silent


def test_music_session_chunked_matches_unchunked(tracks):
    """Four buffers a dispatch (the streaming sampler's pipelined
    configuration) gives the one-buffer session's audio and events."""
    a1, e1 = session(ft, tracks)
    a4, e4 = session(ft, tracks, chunk_buffers=4)
    n = min(a1.shape[1], a4.shape[1])
    np.testing.assert_array_equal(a4[:, :n], a1[:, :n])
    assert e4 == e1


def test_loop_seam_is_sample_exact(tmp_path):
    """A looped bed of 16817 frames (not a block multiple): its period is
    its length to the sample, in the port as in JAX."""
    path = str(tmp_path / "sine.wav")
    n = 16817
    tone = 0.5 * np.sin(2 * np.pi * 3 * np.arange(n) / n)
    write_wav(path, np.stack([tone, tone]).astype(np.float32), SR)
    out = []
    for pkg in (fj, ft):
        cx = pkg.FirewheelCtx(device="cpu") if pkg is ft else pkg.FirewheelCtx()
        player = pkg.MusicPlayer(cx.graph_mut(), clock=lambda: cx.stream.frames_rendered)
        sink = pkg.ArraySink()
        cx.activate(pkg.StreamConfig(SR, 2, buffer_frames=512), sink=sink)
        player.play(path, loop=True)
        for _ in range(6):
            cx.render_offline(0.2)
            player.update()
        cx.deactivate()
        out.append(sink.audio(2)[0])
    np.testing.assert_allclose(out[1], out[0], atol=1e-6, rtol=0)
    a = out[1]
    np.testing.assert_allclose(a[2 * n:3 * n], a[n:2 * n], atol=1e-6)
