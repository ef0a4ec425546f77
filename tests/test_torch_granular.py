"""The port's granular sampler (``firewheel_tpu_torch/nodes/granular.py``)
held against the JAX package's on the CPU.

Both packages get the same clip, made from a numpy seed, and the same
control calls between blocks.  The JAX kernel runs under ``jit(vmap)``, as
its engine runs it: XLA then contracts the spawn anchors, the SOLA target,
the grain positions and the cursor's advance into fused multiply-adds, and
the port writes those out.  Held exactly: every integer and bool leaf of
the state (the source cursor, the grain ages, the ring's anchors, the slot,
the phase, the sequence numbers, the finish counter) and the ring's
fractional anchors and the cursor's fraction, so that SOLA's choice of lag
is JAX's at every spawn; the audio at 1e-6 absolute (the Hann window's
cosine and the grains' sum may round apart by an ulp).  The cases of
``tests/test_granular.py`` keep their own checks on the port's output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from firewheel_tpu.core.node import BlockInfo as JB
from firewheel_tpu.core.sample_resource import SampleResource as JS
from firewheel_tpu.nodes import GranularSamplerNode as JG
from firewheel_tpu_torch.convert import params_from_jax, state_from_jax, state_to_numpy
from firewheel_tpu_torch.core.node import BlockInfo as TB
from firewheel_tpu_torch.core.sample_resource import SampleResource as TS
from firewheel_tpu_torch.nodes import GranularSamplerNode as TG

SR = 48000
F = 128
TOL = 1e-6
EXACT = ("src_int", "src_frac", "ages", "ring_int", "ring_frac", "slot", "phase",
         "ended", "seek_seq", "play_seq", "finish_count")


def _clip(shape, seed=11):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _tones(n, seed=4, channels=2):
    """A sequence of sine tones, a new frequency every 0.1 s."""
    rng = np.random.default_rng(seed)
    f = rng.uniform(150.0, 900.0, size=n // 4800 + 1)[np.arange(n) // 4800]
    ph = np.cumsum(2 * np.pi * f / SR)
    return np.stack([0.4 * np.sin(ph + c) * (1 - 0.3 * c)
                     for c in range(channels)]).astype(np.float32)


class Pair:
    """A JAX granular sampler and a port granular sampler driven by the
    same calls, B instances each (per-instance tempo and pitch where
    given)."""

    def __init__(self, clip, L=1024, A=4, align=True, tempo=1.0, semitones=0.0,
                 ch_out=2, tempos=None, pitches=None, frames=F):
        self.B = 1 if tempos is None else len(tempos)
        self.frames = frames
        self.nodes = (JG(grain_frames=L, overlap=A, align=align),
                      TG(grain_frames=L, overlap=A, align=align))
        self.nodes[0].set_sample(JS(clip, sample_rate=float(SR)))
        self.nodes[1].set_sample(TS(clip, sample_rate=float(SR)))
        self.call("set_tempo", tempo)
        self.call("set_pitch_semitones", semitones)
        self.call("play")
        self.procs = [n.activate(SR, frames, 0, ch_out) for n in self.nodes]
        self.jkernel = jax.jit(jax.vmap(self.procs[0].kernel,
                                        in_axes=(0, 0, 0, 0, None)))
        self.jstate = self._batched(jax.tree.map(np.asarray, self.procs[0].init_state()))
        self.tstate = state_from_jax(self.jstate, "cpu")
        self.overrides = {}
        if tempos is not None:
            self.overrides["tempo"] = np.asarray(tempos, np.float32)
        if pitches is not None:
            self.overrides["pitch"] = np.asarray(pitches, np.float32)
        self.tsample = torch.from_numpy(clip)[None].expand(self.B, *clip.shape)
        self.jsample = jnp.broadcast_to(jnp.asarray(clip), (self.B,) + clip.shape)
        self.finishes = []

    def _batched(self, tree):
        return jax.tree.map(lambda x: np.broadcast_to(
            np.asarray(x), (self.B,) + np.shape(x)).copy(), tree)

    def call(self, name, *args):
        for n in self.nodes:
            getattr(n, name)(*args)

    def params(self):
        jp, tp = (p.collect_params() for p in self.procs)
        jp = self._batched({k: v for k, v in jp.items() if k != "sample"})
        tp = self._batched({k: v for k, v in tp.items() if k != "sample"})
        for tree in (jp, tp):
            tree.update(self.overrides)
        for k in jp:
            np.testing.assert_array_equal(tp[k], jp[k], err_msg=k)
        jp["sample"] = self.jsample
        tp = params_from_jax(tp, "cpu")
        tp["sample"] = self.tsample
        return jp, tp

    def blocks(self, n):
        """Render ``n`` blocks in both; every block's audio, mask and
        state compared."""
        f = self.frames
        outs = []
        empty = np.zeros((self.B, 0, f), np.float32)
        emask = np.zeros((self.B, 0), bool)
        for _ in range(n):
            jp, tp = self.params()
            jo, self.jstate, jm = self.jkernel(jp, self.jstate, empty, emask, JB.make())
            to, self.tstate, tm = self.procs[1].kernel(
                tp, self.tstate, torch.from_numpy(empty), torch.from_numpy(emask),
                TB.make())
            np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=TOL, rtol=0)
            np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
            self.check_state()
            outs.append(to.numpy())
            self.finishes.append(self.state()["finish_count"].copy())
        return np.concatenate(outs, axis=-1)

    def state(self):
        return state_to_numpy(self.tstate)

    def check_state(self):
        t = self.state()
        j = state_to_numpy(state_from_jax(jax.tree.map(np.asarray, self.jstate), "cpu"))
        assert t.keys() == j.keys()
        for k in EXACT:
            assert t[k].dtype == j[k].dtype, k
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
        for k in ("target", "last", "status"):
            np.testing.assert_allclose(t["gain"][k], j["gain"][k], atol=TOL, err_msg=k)


def ref_granular(sample, L, A, tempo, pitch, n_frames, seek=0, block=F):
    """The grain-loop reference of ``tests/test_granular.py``: an explicit
    loop over grains, the source cursor accumulated per block in f32."""
    P = L // A
    ch, n = sample.shape
    tempo32, pitch32 = np.float32(tempo), np.float32(pitch)
    n_blocks = -(-n_frames // block)
    src_int = np.zeros(n_blocks, np.int64)
    src_frac = np.zeros(n_blocks, np.float32)
    si, sf = seek, np.float32(0.0)
    for b in range(n_blocks):
        src_int[b], src_frac[b] = si, sf
        adv = np.float32(sf + np.float32(block) * tempo32)
        si += int(np.floor(adv))
        sf = np.float32(adv - np.float32(np.floor(adv)))
    out = np.zeros((ch, n_frames), np.float64)
    g = 0
    while g * P < n_frames:
        t = g * P
        b, t_local = t // block, t % block
        rel0 = np.float32(src_frac[b] + np.float32(t_local) * tempo32)
        a_off = np.float32(np.floor(rel0))
        a_int = int(src_int[b]) + int(a_off)
        fr0 = np.float32(rel0 - a_off)
        if rel0 < np.float32(n - src_int[b]):
            ages = np.arange(L)
            ks = t + ages
            m = ks < n_frames
            w = 0.5 * (1.0 - np.cos(2.0 * np.pi * ages / L))
            pos_rel = fr0 + ages.astype(np.float32) * pitch32
            off = np.floor(pos_rel)
            fr = pos_rel - off
            p0 = a_int + off.astype(int)
            valid = p0 < n
            p0c = np.clip(p0, 0, n - 1)
            p1c = np.clip(p0 + 1, 0, n - 1)
            s = sample[:, p0c] + (sample[:, p1c] - sample[:, p0c]) * fr
            out[:, ks[m]] += (s * (w * valid))[:, m]
        g += 1
    return (out * (2.0 / A)).astype(np.float32)


def _peak_hz(seg):
    w = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    return np.argmax(w) * SR / len(seg)


@pytest.mark.parametrize("clip_kind", ["noise", "tones"])
def test_neutral_is_identity_after_warmup(clip_kind):
    """tempo 1, pitch 0 st with SOLA on: an identity once all grains
    overlap, on noise and on periodic tones (lag 0 the strict maximum)."""
    L, A = 1024, 4
    clip = _clip((2, 6000)) if clip_kind == "noise" else _tones(6000)
    pair = Pair(clip, L, A, align=True)
    out = pair.blocks(40)[0]
    warm = L - L // A
    np.testing.assert_allclose(out[:, warm:5000], clip[:, warm:5000], atol=2e-5, rtol=0)


@pytest.mark.parametrize("tempo,semitones", [
    (1.0, 0.0), (0.5, 0.0), (2.0, 0.0), (1.0, 12.0),
    (1.0, -7.0), (0.75, 5.0), (1.31, -3.2),
])
def test_matches_grain_loop_reference(tempo, semitones):
    """align=False: the port is JAX's, and both are the grain loop's to
    the test file's 1e-4."""
    L, A = 1024, 4
    clip = _clip((2, 5000))
    pair = Pair(clip, L, A, align=False, tempo=tempo, semitones=semitones)
    out = pair.blocks(30)[0]
    ref = ref_granular(clip, L, A, tempo, 2.0 ** (semitones / 12.0), 30 * F)
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("tempo,semitones,hz,blocks,span", [
    (0.5, 0.0, 440.0, 150, (4096, 12288)),   # stretch: twice as long
    (1.0, 12.0, 880.0, 90, (2048, 6144)),    # pitch: same length
])
def test_stretch_and_pitch(tempo, semitones, hz, blocks, span):
    n = 8192
    t = np.arange(n) / SR
    clip = np.stack([0.4 * np.sin(2 * np.pi * 440.0 * t)] * 2).astype(np.float32)
    pair = Pair(clip, 1024, 4, tempo=tempo, semitones=semitones)
    out = pair.blocks(blocks)[0]
    fin_block = [int(f[0]) for f in pair.finishes].index(1)
    lo = int(n / tempo)
    assert lo <= (fin_block + 1) * F <= lo + 1024 + 256 + 2 * F
    assert abs(_peak_hz(out[0, span[0]:span[1]]) - hz) < hz / 50


def test_pause_freezes_resume_continues():
    pair = Pair(_clip((2, 6000)), 1024, 4)
    pair.blocks(10)
    src_at_pause = int(pair.state()["src_int"][0])
    pair.call("pause")
    tail = pair.blocks(12)[0]
    assert int(pair.state()["src_int"][0]) == src_at_pause  # cursor frozen
    assert np.abs(tail[:, :F]).max() > 0.0  # the tail rings out
    assert (tail[:, -F:] == 0).all()  # then silence
    pair.call("play")
    pair.blocks(1)
    assert src_at_pause <= int(pair.state()["src_int"][0]) <= src_at_pause + 2 * F


def test_stop_rewinds_and_replays():
    pair = Pair(_clip((2, 6000)), 1024, 4)
    first = pair.blocks(6)[0][:, :F]
    pair.call("stop")
    pair.blocks(10)
    pair.call("play")
    again = pair.blocks(1)[0]
    np.testing.assert_allclose(again, first, atol=1e-6, rtol=0)


@pytest.mark.parametrize("ch_out", [2, 3])
def test_mono_clip_into_more_outputs(ch_out):
    pair = Pair(_clip((1, 4000)), 1024, 4, ch_out=ch_out)
    out = pair.blocks(10)[0]
    if ch_out == 2:
        np.testing.assert_array_equal(out[0], out[1])
    else:
        assert (out[1:] == 0).all()
    assert np.abs(out).max() > 0.0


def test_block_size_guard():
    for cls in (JG, TG):
        with pytest.raises(ValueError, match="max_block_frames"):
            cls(grain_frames=512, overlap=4).activate(SR, 512, 0, 2)
    for cls in (JG, TG):
        with pytest.raises(ValueError, match="overlap"):
            cls(grain_frames=1000, overlap=3)


def test_long_clip_precision_past_2pow24():
    """Playing from a seek past 2^24 frames: positions ride (int base, f32
    offset) pairs, so the neutral identity holds there."""
    L, A = 512, 4
    pos0 = 2**24 + 1237
    n = pos0 + 6000
    clip = np.zeros((1, n), np.float32)
    seg = _clip(6000, seed=2)
    clip[0, pos0:] = seg
    pair = Pair(clip, L, A, align=False, ch_out=1)
    pair.call("set_playhead", pos0 / SR)
    pair.call("play")
    out = pair.blocks(24)[0]
    warm = L - L // A
    np.testing.assert_allclose(out[0, warm:24 * F], seg[warm:24 * F], atol=2e-5, rtol=0)


def test_aligned_anchors_exact_under_tempo_pitch_and_transport():
    """SOLA on a tone sequence through the phase's control sequence:
    tempo 0.75 at +3 st, tempo 1.25 at −5 st, a pause and a resume, a
    seek; the ring's anchors are JAX's at every block."""
    pair = Pair(_tones(SR // 2), 2048, 4, tempo=0.75, semitones=3.0)
    pair.blocks(20)
    pair.call("set_tempo", 1.25)
    pair.call("set_pitch_semitones", -5.0)
    pair.blocks(20)
    pair.call("pause")
    pair.blocks(6)
    pair.call("play")
    pair.blocks(8)
    pair.call("set_playhead", 0.21)
    out = pair.blocks(16)[0]
    assert np.abs(out).max() > 0.1
    assert (pair.state()["ring_int"] > 0).all()


def test_batch_of_four_with_own_tempo_and_pitch():
    """B=4 instances, each its own tempo and pitch, one finishing inside
    the run: against JAX's vmap."""
    tempos = np.float32([0.5, 1.0, 1.6, 2.0])
    pitches = np.float32(2.0 ** (np.array([-12.0, 7.0, -3.0, 12.0]) / 12.0))
    pair = Pair(_tones(6000, seed=8), 1024, 4, tempos=tempos, pitches=pitches)
    out = pair.blocks(64)
    assert np.abs(out).max() > 0.1
    assert pair.state()["finish_count"].tolist() == [0, 1, 1, 1]


def test_cursor_past_2pow31_wraps_as_jax():
    """A seek past 2^31 frames: the JAX package's int32 cursor base wraps
    negative (grains spawn, their taps fall outside the clip), and the
    port wraps the same way."""
    pair = Pair(_clip((2, 3000)), 1024, 4, align=True)
    pair.blocks(3)
    for n in pair.nodes:
        n._sample_rate = SR
    pair.call("set_playhead", (2**31 + 5000) / SR)
    pair.blocks(12)
    st = pair.state()
    # the wrapped (negative) base clamps the installed anchors near 0
    assert st["src_int"][0] > 2**31 and (st["ring_int"][0] < 3000).all()


def test_state_round_trip_through_convert():
    """Mid-stream, the port's state goes to the JAX package and back
    through ``convert.py``, and JAX's to the port: both continue as one."""
    pair = Pair(_tones(20000), 1024, 4, tempo=0.8, semitones=2.0)
    pair.blocks(9)
    handed = state_to_numpy(pair.tstate)
    # uint32 leaves come back as uint32: the JAX tree's dtypes
    jtree = jax.tree.map(np.asarray, pair.jstate)
    for k in EXACT:
        assert handed[k].dtype == np.asarray(jtree[k]).dtype, k
    pair.tstate = state_from_jax(jtree, "cpu")
    pair.blocks(6)
    pair.jstate = jax.tree.map(jnp.asarray, state_to_numpy(pair.tstate))
    pair.jstate["gain"] = type(jtree["gain"])(**pair.jstate["gain"])
    pair.blocks(6)


def test_full_stack_engine_render_matches_jax():
    """Through both packages' ``FirewheelCtx``: a 0.5 s clip stretched to
    twice its length, then silent after its tail, with the finish event."""
    import firewheel_tpu as fj
    import firewheel_tpu_torch as ft

    n = SR // 2
    t = np.arange(n) / SR
    clip = np.stack([0.3 * np.sin(2 * np.pi * 330.0 * t)] * 2).astype(np.float32)
    got = []
    for pkg in (fj, ft):
        cx = pkg.FirewheelCtx(device="cpu") if pkg is ft else pkg.FirewheelCtx()
        g = cx.graph_mut()
        node = pkg.nodes.GranularSamplerNode()
        gid = g.add_node(0, 2, node)
        g.connect(gid, 0, g.graph_out_node(), 0)
        g.connect(gid, 1, g.graph_out_node(), 1)
        node.set_sample(pkg.SampleResource(clip, sample_rate=float(SR)))
        node.set_tempo(0.5)
        node.play()
        sink = pkg.ArraySink()
        cx.activate(pkg.StreamConfig(SR, 2, buffer_frames=512), sink=sink)
        cx.render_offline(1.25)
        events = [(e.name, e.count) for e in cx.poll_events()]
        cx.deactivate()
        got.append((sink.audio(2), events))
    (ja, je), (ta, te) = got
    np.testing.assert_allclose(ta, ja, atol=TOL, rtol=0)
    assert te == je == [("finished", 1)]
    assert abs(_peak_hz(ta[0, 24000:40000]) - 330.0) < 6.0
    assert np.max(np.abs(ta[0, 55000:])) == 0.0
