"""The port's ``VoicePool`` held against the JAX package's on the CPU.

Each case of ``tests/test_voice_pool.py`` runs as one session in both
packages through ``FirewheelCtx`` (the port on the CPU): the same clips,
the same plays, steals and stops.  The audio must agree within 1e-6 (the
numerics contract); the handles, the dropped shots, each voice's
``busy_until`` and the finished events must be equal; and the case's own
assertions hold on the port's session.  The pool's samplers must run as
one pooled group in the port's executor.  The port has no program cache,
so there is no ``clear_program_cache`` to call between cases.
"""

import types

import numpy as np
import pytest

import firewheel_tpu as jfw
import firewheel_tpu_torch as ft

SR, F = 48000, 128
TOL = 1e-6

PACKAGES = {
    "port": types.SimpleNamespace(
        pkg=ft, ctx=lambda cfg: ft.FirewheelCtx(cfg, device="cpu")),
    "jax": types.SimpleNamespace(pkg=jfw, ctx=lambda cfg: jfw.FirewheelCtx(cfg)),
}


class Session:
    """One case's session in one package: the ctx, the pool, the sink, and
    what the case observed (``rec``)."""

    def __init__(self, side, num_voices=4, **pool_kw):
        self.pkg = side.pkg
        self.cx = side.ctx(self.pkg.AudioGraphConfig(0, 2))
        kw = {"max_clip_frames": 512, "declick_secs": 0.0, **pool_kw}
        self.pool = self.pkg.VoicePool(self.cx.graph, num_voices=num_voices, **kw)
        self.sink = self.pkg.ArraySink()
        self.rec = {"handles": []}
        self.cx.activate(self.pkg.StreamConfig(SR, 2, buffer_frames=F,
                                               deferred_swap=False), sink=self.sink)

    def clip(self, frames, channels=1, value=1.0):
        return self.pkg.SampleResource(np.full((channels, frames), value, np.float32),
                                       sample_rate=SR)

    def ramp(self, frames):
        return self.pkg.SampleResource(
            np.linspace(0.1, 1.0, frames, dtype=np.float32)[None, :], sample_rate=SR)

    def play(self, clip, **kw):
        h = self.pool.play(clip, **kw)
        self.rec["handles"].append(None if h is None else (h._index, h._gen))
        return h

    def render(self, blocks):
        self.cx.render_offline(blocks * F / SR)

    def note(self, key, value):
        self.rec.setdefault(key, []).append(value)

    def close(self):
        self.rec["busy_until"] = [v.busy_until for v in self.pool._voices]
        self.rec["finished"] = [(h._index, h._gen) for h in
                                self.pool.finished_handles(self.cx.poll_events())]
        self.cx.deactivate()
        if self.sink.audio(2).size:
            self.rec["audio"] = self.sink.audio(2)
        return self.rec


# -- the cases: each runs in both packages and checks its own outcome -------


def one_shot_sample_accurate_trigger(s):
    s.play(s.clip(256), when=2 * F, now=0)
    s.render(8)
    rec = s.close()
    L, R = rec["audio"]
    assert np.abs(L[: 2 * F]).max() == 0.0 and L[2 * F: 2 * F + 256].min() > 0.5
    np.testing.assert_allclose(L[2 * F + 300:], 0.0, atol=1e-6)
    np.testing.assert_allclose(L, R, atol=1e-6)
    return rec


def trigger_lands_on_exact_sample(s):
    when = 2 * F + 37
    s.play(s.clip(256), when=when, now=0)
    s.render(8)
    rec = s.close()
    L = rec["audio"][0]
    assert np.abs(L[:when]).max() == 0.0 and L[when: when + 256].min() > 0.5
    return rec


def pan_and_gain(s):
    s.play(s.clip(256), gain_db=-6.0, pan=-1.0, when=F, now=0)
    s.render(5)
    rec = s.close()
    L, R = rec["audio"]
    assert np.abs(L[F: F + 256]).max() > 0.3 and np.abs(R[F: F + 256]).max() < 1e-5
    np.testing.assert_allclose(L[F + 100], 0.501, atol=0.01)
    return rec


def loop_wraps_true_length_not_pad(s):
    s.play(s.clip(300, value=0.5), loop=True, now=0)
    s.render(16)
    rec = s.close()
    assert np.abs(rec["audio"][0][600:900]).min() > 0.1
    return rec


def mono_clip_into_stereo_pool_and_mixdown(s):
    s.play(s.clip(200, channels=1), now=0)
    s.play(s.clip(200, channels=4, value=0.25), now=0)
    s.render(4)
    rec = s.close()
    L, R = rec["audio"]
    assert np.abs(L[:200]).max() > 0.5
    np.testing.assert_allclose(L, R, atol=1e-6)
    return rec


def play_never_dirties_graph_or_program(s):
    s.pool.preload(s.ramp(400), s.clip(256))
    s.render(2)
    program = s.cx.stream._processor._program
    for i in range(6):
        s.play(s.ramp(100 + 37 * i), gain_db=-3.0 * i, pan=0.2 * i - 0.5, now=i * F)
        s.render(1)
    assert not s.cx.graph.needs_compile()
    assert s.cx.stream._processor._program is program
    return s.close()


def steals_lowest_priority_oldest(s):
    clip = s.clip(128)
    h1 = s.play(clip, loop=True, priority=1, now=0)
    h2 = s.play(clip, loop=True, priority=5, now=10)
    h3 = s.play(clip, loop=True, priority=3, now=20)
    assert h3 is not None and not h1.alive and h2.alive
    s.note("active", s.pool.active_voices(now=30))
    s.render(3)
    return s.close()


def drop_when_outranked(s):
    clip = s.clip(128)
    s.play(clip, loop=True, priority=5, now=0)
    s.play(clip, loop=True, priority=5, now=0)
    assert s.play(clip, loop=True, priority=1, now=0) is None
    s.note("active", s.pool.active_voices(now=0))
    s.render(3)
    return s.close()


def one_shots_free_after_duration(s):
    clip = s.clip(256)  # bucket 512: busy 512 stream samples
    s.play(clip, now=0)
    s.play(clip, now=0)
    s.note("active", [s.pool.active_voices(now=100), s.pool.active_voices(now=513)])
    h = s.play(clip, now=600)
    assert h is not None and h.alive
    s.render(8)
    return s.close()


def stale_handle_is_noop(s):
    clip = s.clip(128)
    h1 = s.play(clip, loop=True, gain_db=0.0, now=0)
    v = s.pool._voices[0]
    h2 = s.play(clip, loop=True, gain_db=-12.0, now=10)  # steals
    pct = v.sampler.percent_volume()
    h1.set_gain_db(+6.0)  # stale: must not touch the new sound
    assert v.sampler.percent_volume() == pct
    h2.set_gain_db(-3.0)
    assert v.sampler.percent_volume() != pct and not h1.alive and h2.alive
    s.note("percent", [pct, v.sampler.percent_volume()])
    s.render(4)
    return s.close()


def stop_all_and_handle_stop(s):
    clip = s.clip(128)
    h = s.play(clip, loop=True, now=0)
    s.play(clip, loop=True, now=0)
    s.render(2)
    h.stop()
    s.note("active", s.pool.active_voices(now=1))
    s.render(2)
    s.pool.stop_all()
    s.note("active", s.pool.active_voices(now=1))
    s.render(2)
    return s.close()


def clock_binding(s):
    clip = s.clip(256)
    s.play(clip)  # now from the clock: 0
    s.note("active", s.pool.active_voices())
    s.clock[0] = 1000  # past the 512-sample busy window
    s.note("active", s.pool.active_voices())
    s.render(4)
    return s.close()


def same_voice_scheduled_retrigger(s):
    clip = s.clip(256, value=0.5)
    s.play(clip, when=2 * F, now=2 * F - 1)
    s.play(clip, when=10 * F, now=10 * F - 1)
    s.render(14)
    rec = s.close()
    L = rec["audio"][0]
    assert np.abs(L[2 * F: 2 * F + 256]).max() > 0.3
    assert np.abs(L[10 * F: 10 * F + 256]).max() > 0.3
    assert np.abs(L[6 * F: 8 * F]).max() < 1e-6
    return rec


def bucket_growth(s):
    s.play(s.clip(100), now=0)
    s.note("bucket", s.pool.bucket_frames)
    s.play(s.clip(1000), now=0)
    s.note("bucket", s.pool.bucket_frames)
    s.render(2)
    rec = s.close()
    assert rec["bucket"] == [128, 1024] and np.abs(rec["audio"][0]).max() > 0.3
    return rec


CASES = {
    one_shot_sample_accurate_trigger: {},
    trigger_lands_on_exact_sample: {},
    pan_and_gain: {},
    loop_wraps_true_length_not_pad: {},
    mono_clip_into_stereo_pool_and_mixdown: {},
    play_never_dirties_graph_or_program: {},
    steals_lowest_priority_oldest: {"num_voices": 2},
    drop_when_outranked: {"num_voices": 2},
    one_shots_free_after_duration: {"num_voices": 2},
    stale_handle_is_noop: {"num_voices": 1},
    stop_all_and_handle_stop: {"num_voices": 2},
    clock_binding: {"num_voices": 2, "clock": True},
    same_voice_scheduled_retrigger: {"num_voices": 1},
    bucket_growth: {"num_voices": 2, "max_clip_frames": None},
}


def run(case, side):
    kw = dict(CASES[case])
    clock = [0]
    if kw.pop("clock", False):
        kw["clock"] = lambda: clock[0]
    s = Session(side, **kw)
    s.clock = clock
    return case(s)


@pytest.mark.parametrize("case", list(CASES), ids=lambda c: c.__name__)
def test_session_matches_jax(case):
    got, want = run(case, PACKAGES["port"]), run(case, PACKAGES["jax"])
    assert set(got) == set(want)
    for key in got:
        if key == "audio":
            assert got[key].shape == want[key].shape
            np.testing.assert_allclose(got[key], want[key], atol=TOL, rtol=0)
        else:
            assert got[key] == want[key], key


def test_voices_run_as_one_pooled_group():
    """The N samplers share one ``group_key`` once clips are padded to the
    bucket, and the port's executor runs them as one pooled group (one
    kernel call a block), as JAX traces them as one vmapped kernel."""
    s = Session(PACKAGES["port"], num_voices=6)
    clip = s.clip(333)
    for _ in range(6):
        s.play(clip, now=0)
    s.render(2)
    program = s.cx.stream._processor._program
    groups = [[type(program._procs[ft.node_key(sn.id)]).__name__ for sn in members]
              for kind, members in program._plan]
    assert groups.count(["SamplerProcessor"] * 6) == 1
    assert ["SamplerProcessor"] not in groups
    assert groups.count(["StereoPanProcessor"] * 6) == 1
    keys = {p.group_key() for p in program._procs.values()
            if type(p).__name__ == "SamplerProcessor"}
    assert keys == {((2, 512), "linear")}
    assert np.abs(s.close()["audio"]).max() > 0.5


def test_chip_smoke_clips_are_the_examples(monkeypatch):
    """``chip_smoke.py`` 15(a)'s clips, the port's ``examples.
    voice_pool_game.synth_clip``: the example's tones bit for bit; its noise
    clips seeded from a stable hash of the name (CRC-32), so two processes
    (the card's and the CPU's) make the same ones, the example's own with
    that hash."""
    import inspect
    import zlib

    import chip_smoke
    import examples.voice_pool_game as example
    from firewheel_tpu_torch.examples.voice_pool_game import synth_clip

    assert ("from firewheel_tpu_torch.examples.voice_pool_game import synth_clip"
            in inspect.getsource(chip_smoke.voice_pool_session))
    for kind in ("laser", "engine"):
        np.testing.assert_array_equal(synth_clip(kind).host_data,
                                      example.synth_clip(kind).host_data)
    monkeypatch.setattr(example, "hash", lambda s: zlib.crc32(s.encode()), raising=False)
    for kind in ("footstep", "explosion"):
        a = synth_clip(kind)
        np.testing.assert_array_equal(a.host_data, synth_clip(kind).host_data)
        np.testing.assert_array_equal(a.host_data, example.synth_clip(kind).host_data)