"""The port's streaming sampler (``firewheel_tpu_torch/nodes/
streaming_sampler.py``) held against the JAX package's on the CPU.

Each case streams the same clip, written from a numpy seed, through both
packages' ``FirewheelCtx`` (the port's with ``device="cpu"``) with the
same control calls, and holds the port's audio to the JAX package's at
1e-6 absolute, besides the checks of ``tests/test_streaming_sampler.py``
themselves.  The JAX engine jit-compiles its chunks, so XLA contracts the
position sums into fused multiply-adds; the port writes them out.

The reference refills its window in place and hands it over through
``jnp.asarray``, which on the CPU aliases the numpy buffer: a refill for
the next pipelined dispatch can rewrite the window under one still
rendering (the flake of ``test_streaming_with_chunked_dispatch``).  The
JAX side here runs with that refill copying (``_safe_jax_refill``), so the
comparison is with the reference's intended output.
"""

import numpy as np
import pytest
import torch

import firewheel_tpu as fj
import firewheel_tpu_torch as ft
from firewheel_tpu.nodes import streaming_sampler as jss
from firewheel_tpu.utils import wav as jwav
from firewheel_tpu_torch.nodes import streaming_sampler as tss
from firewheel_tpu_torch.utils import wav as twav

SR = 48000
TOL = 1e-6


@pytest.fixture(autouse=True)
def _safe_jax_refill(monkeypatch):
    """The reference's ``_refill`` with a fresh, copied window per refill."""
    import jax.numpy as jnp

    def refill(self, start):
        reader = self._node._reader
        ch = reader.num_channels
        self._window = np.array(np.asarray(
            reader.read(start, self.window_frames), np.float32
        ).reshape(ch, self.window_frames))
        self._window_dev = jnp.array(self._window)
        self._window_start = start
        self._window_valid = True
        self.refill_count += 1

    monkeypatch.setattr(jss.StreamingSamplerProcessor, "_refill", refill)


def make_audio(frames, channels=2, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((channels, frames)) * 0.3).astype(np.float32)


class Run:
    """One package's engine streaming one node to the graph outputs."""

    def __init__(self, pkg, node, channels=2, buffer_frames=512,
                 chunk_buffers=1):
        self.cx = (pkg.FirewheelCtx(device="cpu") if pkg is ft
                   else pkg.FirewheelCtx())
        g = self.cx.graph_mut()
        self.node_id = g.add_node(0, channels, node)
        for c in range(channels):
            g.connect(self.node_id, c, g.graph_out_node(), c)
        self.node = node
        self.channels = channels
        self.sink = pkg.ArraySink()
        self.cx.activate(pkg.StreamConfig(SR, channels, buffer_frames=buffer_frames,
                                          chunk_buffers=chunk_buffers),
                         sink=self.sink)

    def proc(self):
        procs = self.cx.stream._processor._processors.values()
        return [p for p in procs if hasattr(p, "refill_count")][0]

    def finish(self):
        events = [e.name for e in self.cx.poll_events()]
        self.cx.deactivate()
        return self.sink.audio(self.channels), events


def both(make_node, drive, **kw):
    """Run ``drive(run)`` in both packages; the port's audio and events
    must be the JAX package's.  Returns the port's run and audio."""
    out = []
    for pkg, mod in ((fj, jss), (ft, tss)):
        run = Run(pkg, make_node(mod, pkg), **kw)
        drive(run)
        out.append((run,) + run.finish())
    (_, ja, je), (trun, ta, te) = out
    assert ta.shape == ja.shape
    np.testing.assert_allclose(ta, ja, atol=TOL, rtol=0)
    assert te == je
    return trun, ta


def wav_reader(pkg_mod, path):
    return (jwav if pkg_mod is jss else twav).WavStreamReader(path)


def test_wav_stream_reader_matches_jax(tmp_path):
    audio = make_audio(SR)
    for dtype in ("f32", "i16"):
        path = str(tmp_path / f"a-{dtype}.wav")
        twav.write_wav(path, audio, SR, dtype=dtype)
        j, t = jwav.WavStreamReader(path), twav.WavStreamReader(path)
        assert (t.num_channels, t.len_frames, t.sample_rate) == (2, SR, SR)
        for start, n in ((1000, 256), (SR - 10, 64), (-20, 50), (SR + 5, 8)):
            np.testing.assert_array_equal(t.read(start, n), j.read(start, n))
        np.testing.assert_array_equal(twav.read_wav(path)[0], jwav.read_wav(path)[0])
    tail = twav.WavStreamReader(str(tmp_path / "a-f32.wav")).read(SR - 10, 64)
    np.testing.assert_allclose(tail[:, :10], audio[:, -10:], atol=1e-7)
    assert (tail[:, 10:] == 0).all()


def test_streaming_matches_jax_and_resident(tmp_path):
    """Windowed disk playback is the JAX package's and the in-memory
    sampler's; the window stays a fraction of the clip and slides."""
    audio = make_audio(SR)
    path = str(tmp_path / "clip.wav")
    twav.write_wav(path, audio, SR)

    def drive(run):
        run.node.play()
        run.cx.render_offline(0.8)
        run.stats = (run.proc().refill_count, run.proc().window_frames)

    trun, got = both(lambda m, p: m.StreamingSamplerNode(
        wav_reader(m, path), window_secs=0.25), drive)
    refills, window_frames = trun.stats
    assert window_frames <= SR // 4 + 2048 and refills >= 3

    res = Run(ft, ft.SamplerNode(100.0))
    res.node.set_sample(ft.SampleResource(audio))
    res.node.play()
    res.cx.render_offline(0.8)
    want, _ = res.finish()
    n = int(0.75 * SR)
    np.testing.assert_allclose(got[:, :n], want[:, :n], atol=1e-6)


def test_callback_reader_network_style():
    frames = SR // 2
    audio = make_audio(frames, channels=1, seed=9)
    calls = []

    def fetch(start, n):
        calls.append((start, n))
        out = np.zeros((1, n), np.float32)
        end = min(start + n, frames)
        if end > start:
            out[:, : end - start] = audio[:, max(start, 0):end]
        return out

    def drive(run):
        run.node.play()
        run.cx.render_offline(0.6)

    _, got = both(lambda m, p: m.StreamingSamplerNode(
        m.CallbackStreamReader(fetch, 1, frames, SR), window_secs=0.1), drive)
    np.testing.assert_allclose(got[0, :frames], audio[0], atol=1e-6)
    assert (got[0, frames:] == 0).all()  # one-shot end: silence
    assert len(calls) >= 6


@pytest.mark.parametrize("rate", [1.0, 0.9, 1.37])
def test_seek_rate_pause_and_stop(tmp_path, rate):
    audio = make_audio(SR)
    path = str(tmp_path / "c.wav")
    twav.write_wav(path, audio, SR)

    def drive(run):
        run.node.set_playback_rate(rate)
        run.node.set_playhead(0.5)
        run.node.play()
        run.cx.render_offline(0.2)
        run.node.pause()
        run.cx.render_offline(0.05)
        run.node.play()
        run.cx.render_offline(0.3)  # reaches the end: a finish event
        run.node.stop()
        run.node.play()
        run.cx.render_offline(0.1)

    _, got = both(lambda m, p: m.StreamingSamplerNode(
        wav_reader(m, path), window_secs=0.2), drive)
    if rate == 1.0:
        np.testing.assert_allclose(got[:, :4000], audio[:, SR // 2:SR // 2 + 4000],
                                   atol=1e-6)


def test_rated_reader_plays_native_pitch():
    """A 24 kHz-rated reader in a 48 kHz stream: a 600 Hz tone sounds at
    600 Hz, and seeks address clip time."""
    clip_sr = 24000
    n = clip_sr * 2
    tone = np.sin(2 * np.pi * 600.0 * np.arange(n) / clip_sr).astype(np.float32)

    def read(start, num):
        out = np.zeros((1, num), np.float32)
        avail = max(0, min(num, n - start))
        if avail:
            out[0, :avail] = tone[start:start + avail]
        return out

    def drive(run):
        run.node.set_playhead(0.5)
        run.node.play()
        run.cx.render_offline(0.5)

    _, got = both(lambda m, p: m.StreamingSamplerNode(
        m.CallbackStreamReader(read, 1, n, sample_rate=clip_sr)), drive,
        channels=1)
    a = got[0, 512:]
    spec = np.abs(np.fft.rfft(a * np.hanning(len(a))))
    assert abs(float(np.fft.rfftfreq(len(a), 1 / SR)[spec.argmax()]) - 600.0) < 8.0


def test_play_at_sample_is_sample_exact(tmp_path):
    """A scheduled play lands on its exact sample inside a chunked
    dispatch, and a scheduled stop and re-play follow it, as in JAX."""
    audio = make_audio(SR // 2, seed=3)
    path = str(tmp_path / "d.wav")
    twav.write_wav(path, audio, SR)
    at = 3 * 512 + 37

    def drive(run):
        run.node.play(at_sample=at)
        run.node.stop(at_sample=at + 4000)
        run.node.play(at_sample=at + 5000 + 11)
        run.cx.render_offline(0.3)

    _, got = both(lambda m, p: m.StreamingSamplerNode(
        wav_reader(m, path), window_secs=0.25), drive, chunk_buffers=2)
    assert (got[:, :at] == 0).all()
    np.testing.assert_allclose(got[:, at:at + 2000], audio[:, :2000], atol=1e-6)


def test_chunked_dispatch_twenty_times(tmp_path):
    """``test_streaming_with_chunked_dispatch`` 20 times over: with
    ``chunk_buffers=4`` the shadow playhead advances by the whole chunk,
    and a refill never rewrites a window a pipelined dispatch reads."""
    audio = make_audio(SR)
    path = str(tmp_path / "chunked.wav")
    twav.write_wav(path, audio, SR)
    n = int(0.75 * SR)
    for _ in range(20):
        run = Run(ft, ft.StreamingSamplerNode(twav.WavStreamReader(path),
                                              window_secs=0.25),
                  chunk_buffers=4)
        run.node.play()
        run.cx.render_offline(0.8)
        windows = run.proc().refill_count
        got, _ = run.finish()
        np.testing.assert_allclose(got[:, :n], audio[:, :n], atol=1e-6)
        assert windows >= 3


def test_refill_never_rewrites_a_window_in_flight(tmp_path):
    """Each refill hands over a new read-only array: a dispatch keeps the
    window it was given, whatever later refills read."""
    audio = make_audio(SR // 2)
    path = str(tmp_path / "e.wav")
    twav.write_wav(path, audio, SR)
    run = Run(ft, ft.StreamingSamplerNode(twav.WavStreamReader(path),
                                          window_secs=0.05), chunk_buffers=2)
    proc = run.proc()
    reader = twav.WavStreamReader(path)
    run.node.play()
    seen = []
    for _ in range(8):
        run.cx.update(max_pump_buffers=0)
        run.cx.stream.pump(2)
        seen.append((proc._window_start, proc._window))
    assert len({id(w) for _, w in seen}) >= 3
    for start, w in seen:  # each still holds what was read into it
        assert not w.flags.writeable
        np.testing.assert_array_equal(w, reader.read(start, w.shape[1]))
    run.finish()


def test_checkpoint_resync(tmp_path):
    """A checkpoint taken mid-stream restores into a fresh engine, whose
    deck resumes at the saved playhead: the resumed audio is the
    uninterrupted stream's."""
    audio = make_audio(SR, seed=13)
    path = str(tmp_path / "f.wav")
    twav.write_wav(path, audio, SR)

    def fresh():
        run = Run(ft, ft.StreamingSamplerNode(twav.WavStreamReader(path),
                                              window_secs=0.2))
        run.node.play()
        return run

    whole = fresh()
    whole.cx.render_offline(0.6)
    want, _ = whole.finish()

    first = fresh()
    first.cx.render_offline(0.3)
    ckpt = str(tmp_path / "ckpt")
    first.cx.save_checkpoint(ckpt)
    head, _ = first.finish()
    second = fresh()
    second.cx.render_offline(0.05)  # elsewhere in the clip
    second.cx.load_checkpoint(ckpt)
    mark = second.sink.audio(2).shape[1]
    second.cx.render_offline(0.3)
    # the restored sequence numbers were adopted: no spurious seek edge
    node = second.proc()._node
    assert node._seek_seq == int(second.cx.node_state(second.node_id)["seek_seq"])
    tail, _ = second.finish()
    n = head.shape[1]
    np.testing.assert_array_equal(head, want[:, :n])
    resumed = want[:, n:n + tail.shape[1] - mark]
    np.testing.assert_allclose(tail[:, mark:mark + resumed.shape[1]], resumed,
                               atol=1e-6)
    assert resumed.shape[1] > SR // 4


def test_kernel_batched_matches_jax():
    """The kernel over a batch of 3 instances (their own rates, playheads
    and windows) against the JAX kernel under ``jit(vmap)``."""
    import jax
    import jax.numpy as jnp
    from firewheel_tpu.core.node import BlockInfo as JB
    from firewheel_tpu_torch.convert import params_from_jax, state_from_jax, state_to_numpy
    from firewheel_tpu_torch.core.node import BlockInfo as TB

    B, F, W = 3, 128, 4096
    audio = make_audio(W, seed=21)
    reader = lambda m: m.CallbackStreamReader(  # noqa: E731
        lambda s, n: np.zeros((2, n), np.float32), 2, 10 * W, SR)
    jn, tn = jss.StreamingSamplerNode(reader(jss)), tss.StreamingSamplerNode(reader(tss))
    jp, tp = jn.activate(SR, F, 0, 2), tn.activate(SR, F, 0, 2)
    kern = jax.jit(jax.vmap(jp.kernel, in_axes=(0, 0, 0, 0, None)))
    bat = lambda t: jax.tree.map(  # noqa: E731
        lambda x: np.broadcast_to(np.asarray(x), (B,) + np.shape(x)).copy(), t)
    js = bat(jax.tree.map(np.asarray, jp.init_state()))
    ts = state_from_jax(js, "cpu")
    params = {
        "raw_gain": np.float32([1.0, 0.5, 0.8]),
        "rate": np.float32([1.0, 0.73, 1.9]),
        "window": np.stack([audio, audio[::-1].copy(), -audio]),
        "window_start": np.uint32([0, 1000, 2**32 - 64]),
        "len_frames": np.uint32([10 * W, 3000, 2**32 - 1]),
        "playing": np.array([True, True, True]),
        "seek_seq": np.uint32([1, 1, 1]),
        "seek_pos": np.uint32([10, 1500, 2**32 - 200]),
        "play_seq": np.uint32([1, 1, 1]),
        "start_offset": np.uint32([0, 37, 127]),
    }
    for blk in range(12):
        if blk == 6:
            params["playing"] = np.array([False, True, True])
        jo, js, jm = kern(params, js, jnp.zeros((B, 0, F)), jnp.zeros((B, 0), bool),
                          JB.make())
        to, ts, tm = tp.kernel(params_from_jax(params, "cpu"), ts,
                               torch.zeros(B, 0, F), torch.zeros(B, 0, dtype=torch.bool),
                               TB.make())
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=TOL, rtol=0)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        jnp_state = state_to_numpy(state_from_jax(jax.tree.map(np.asarray, js), "cpu"))
        tnp_state = state_to_numpy(ts)
        for key in ("playhead", "ended", "finish_count", "seek_seq", "play_seq"):
            np.testing.assert_array_equal(tnp_state[key], jnp_state[key], err_msg=key)
        np.testing.assert_allclose(tnp_state["frac"], jnp_state["frac"], atol=TOL)
    assert np.abs(to.numpy()).max() > 0.05
