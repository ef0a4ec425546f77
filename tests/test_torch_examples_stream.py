"""The port's streamed examples (``firewheel_tpu_torch.examples``) on the
CPU beside the JAX package's own (``examples/*.py``, loaded from their
files), on the same inputs:

* ``beep_test``: the WAVs within 1e-6 over the frames both rendered (the
  example's wall-clock poll may stop a loaded machine short of 4 s), the
  440 Hz tone at -12 dB, and the ``--play`` branch through
  ``SoundDeviceSink`` over a stand-in sounddevice module;
* ``effects_chain``: BASELINE config 4 streamed 6 s with the retriggers and
  the cutoff sweep keyed to stream time: each ``update()`` lands on the
  same frame count in both packages, the WAVs within 1e-6, with the JAX
  filter's ``w0``, sine and cosine computed as the port computes them
  (:func:`torch_trig`) and its scan run op by op (:func:`unfused_jax_scan`).
  Under jit XLA folds ``(2π · f) / sr`` into ``f · (2π / sr)``, its f32
  ``sin``/``cos`` part from torch's by an ulp at some of the sweep's 36
  cutoffs, and it contracts the scan into fused multiply-adds; the sweep's
  600 Hz end amplifies those roundings into ~1.6e-5 of the output between
  2 and 4 s.  The test holds the design's ulps themselves, and the rest of
  the chain to 1e-6;
* ``spatial_scene``: the scene streamed 1.5 s with its orbit, cut to 16
  emitters in 4 groups on both sides (``NUM_EMITTERS``, ``GROUPS``; the
  266-node scene runs on the card in ``chip_smoke.py``): the WAVs within
  1e-6, the node count and the meter's reading.
"""

import threading
import time

import numpy as np
import pytest

import firewheel_tpu_torch as ft
import jax
import jax.numpy as jnp
import torch
from firewheel_tpu.ops import iir as jax_iir
from firewheel_tpu_torch.examples import beep_test, effects_chain, spatial_scene
from test_torch_examples import TOL, _load_jax_example, fresh_jax_programs


def _wav(path):
    return ft.load_audio(str(path), device=False)[0].host_data


def _frames_per_update(cls, log):
    """``cls`` (a ``FirewheelCtx``) with the frames rendered after every
    ``update()`` appended to ``log``."""
    class Counting(cls):
        def update(self, *a, **kw):
            result = super().update(*a, **kw)
            log.append(self.stream.frames_rendered if self.stream else None)
            return result

    return Counting


def test_beep_test_matches_jax(tmp_path, capsys):
    _load_jax_example("beep_test").main(str(tmp_path / "jax.wav"))
    printed = capsys.readouterr().out
    got = beep_test.main(str(tmp_path / "port.wav"), device="cpu")
    assert printed == capsys.readouterr().out.replace("port.wav", "jax.wav")
    want, have = _wav(tmp_path / "jax.wav"), _wav(tmp_path / "port.wav")
    n = min(want.shape[1], have.shape[1])
    assert n >= 48000 and have.shape[1] == got["frames"]
    np.testing.assert_allclose(have[:, :n], want[:, :n], atol=TOL, rtol=0)
    spec = np.abs(np.fft.rfft(have[0, :48000]))
    assert np.argmax(spec) == 440
    assert abs(np.abs(have).max() - 10 ** (-12 / 20)) < 1e-4


class _FakeSoundDevice:
    """A stand-in for the ``sounddevice`` module: its output stream's
    callback drains the sink's ring every 5 ms on a thread and keeps what
    it played."""

    def __init__(self):
        self.played = []

    def OutputStream(self, samplerate, channels, dtype, device, callback):
        played = self.played

        class Stream:
            active = True

            def start(self):
                def run():
                    while self.active:
                        out = np.zeros((240, channels), np.float32)
                        callback(out, 240, None, None)
                        played.append(out.copy())
                        time.sleep(0.005)

                self._thread = threading.Thread(target=run, daemon=True)
                self._thread.start()

            def stop(self):
                self.active = False
                self._thread.join()

            def close(self):
                pass

        return Stream()


def test_beep_test_plays_through_the_sound_device_sink(monkeypatch, capsys):
    """``--play`` streams in realtime into ``SoundDeviceSink``: the device
    plays the 440 Hz beep, and the example reports its underflows."""
    from firewheel_tpu_torch.backend import os_audio

    sd = _FakeSoundDevice()
    monkeypatch.setattr(os_audio, "_load_sounddevice", lambda: sd)
    got = beep_test.main("--play", device="cpu")
    assert f"finished (played {got['underflows']} underflows)" in capsys.readouterr().out
    played = np.concatenate(sd.played)[:, 0]
    start = int(np.argmax(np.abs(played) > 0))
    tone = played[start:start + 24000]
    assert got["frames"] >= 24000 and len(tone) == 24000
    assert np.argmax(np.abs(np.fft.rfft(tone))) == 220  # 440 Hz at 2 Hz a bin
    assert abs(np.abs(tone).max() - 10 ** (-12 / 20)) < 1e-4


def _port_trig(freq_hz, sample_rate):
    """``w0``, ``sin(w0)`` and ``cos(w0)`` as the port's filter design
    computes them (``ops/iir.py:_wq``), from float32 cutoffs."""
    w0, sin_w0, cos_w0, _ = ft.ops.iir._wq(
        torch.from_numpy(np.array(freq_hz, np.float32)), torch.tensor(np.float32(1.0)),
        int(sample_rate))
    return w0.numpy(), sin_w0.numpy(), cos_w0.numpy()


def torch_trig(monkeypatch):
    """The JAX filter designs' traced ``w0``, ``sin(w0)`` and ``cos(w0)``
    computed as the port computes them, by torch on the host
    (``jax.pure_callback``); everything else in the design stays XLA's.
    JAX's cached programs are set aside first (:func:`fresh_jax_programs`)."""
    def _wq(freq_hz, q, sample_rate):
        if jax_iir._xp(freq_hz, q) is np:
            return jax_iir_wq(freq_hz, q, sample_rate)
        f = jnp.asarray(freq_hz, jnp.float32)
        shape = jax.ShapeDtypeStruct(f.shape, jnp.float32)
        w0, sin_w0, cos_w0 = jax.pure_callback(
            lambda x: _port_trig(x, sample_rate), (shape, shape, shape), f,
            vmap_method="sequential")
        return w0, sin_w0, cos_w0, sin_w0 / (jnp.float32(2.0) * jnp.asarray(q, jnp.float32))

    fresh_jax_programs(monkeypatch)
    jax_iir_wq = jax_iir._wq
    monkeypatch.setattr(jax_iir, "_wq", _wq)


def test_effects_chain_sweep_design_differs_by_ulps():
    """At the cutoffs the sweep sets (once an ``update()``, 8192 frames
    apart), JAX's jitted design and the port's part by an ulp: XLA folds
    ``(2π · f) / sr`` into ``f · (2π / sr)``, and XLA's f32 sine and cosine
    are not torch's: each within two ulps of the port's."""
    t = np.arange(0.0, effects_chain.DURATION_SECS, 8192 / effects_chain.SR)
    freqs = np.asarray([effects_chain.cutoff_hz(x) for x in t], np.float32)
    xla = jax.jit(lambda f: jax_iir._wq(f, jnp.float32(1.0), effects_chain.SR)[:3])(freqs)
    port = _port_trig(freqs, effects_chain.SR)
    ulps = [np.abs(np.asarray(a).view(np.int32) - b.view(np.int32)) for a, b in zip(xla, port)]
    assert all((u <= 2).all() for u in ulps) and any(u.any() for u in ulps)


def unfused_jax_scan(monkeypatch, node_module):
    """``node_module``'s ``biquad_scan`` (a JAX node module's) run op by op
    (``lax.associative_scan`` unjitted, through a host callback inside the
    jitted render), as the port's plain scan runs it: under jit XLA
    contracts the scan's products into fused multiply-adds, which a pole
    next to 1 amplifies (``test_torch_fx.py``'s ``unfused_jax_eq`` for the
    EQ).  JAX's cached programs are set aside first
    (:func:`fresh_jax_programs`): one traced before the patch would still
    run XLA's fused scan."""
    def host(x, z1, z2, *coeffs):
        # eager: each primitive compiled alone, none fused with another
        y, (o1, o2) = jax_iir.biquad_scan(
            jnp.asarray(x), (jnp.asarray(z1), jnp.asarray(z2)),
            jax_iir.BiquadCoeffs(*map(jnp.asarray, coeffs)))
        return np.asarray(y), np.asarray(o1), np.asarray(o2)

    def biquad_scan(x, z_prev, coeffs):
        shapes = (jax.ShapeDtypeStruct(x.shape, x.dtype),
                  *(jax.ShapeDtypeStruct(z.shape, z.dtype) for z in z_prev))
        y, o1, o2 = jax.pure_callback(host, shapes, x, *z_prev, *coeffs,
                                      vmap_method="sequential")
        return y, (o1, o2)

    fresh_jax_programs(monkeypatch)
    monkeypatch.setattr(node_module, "biquad_scan", biquad_scan)


def test_effects_chain_matches_jax(monkeypatch, tmp_path, capsys):
    from firewheel_tpu.nodes import filter as jax_filter

    unfused_jax_scan(monkeypatch, jax_filter)
    torch_trig(monkeypatch)
    jax_wav, port_wav = tmp_path / "jax.wav", tmp_path / "port.wav"
    monkeypatch.setattr("sys.argv", ["effects_chain.py", str(jax_wav)])
    jax_mod = _load_jax_example("effects_chain")
    jax_frames, port_frames = [], []
    monkeypatch.setattr(jax_mod, "FirewheelCtx",
                        _frames_per_update(jax_mod.FirewheelCtx, jax_frames))
    monkeypatch.setattr(effects_chain, "FirewheelCtx",
                        _frames_per_update(effects_chain.FirewheelCtx, port_frames))
    jax_mod.main()
    printed = capsys.readouterr().out
    got = effects_chain.main(str(port_wav), device="cpu")
    assert capsys.readouterr().out == printed.replace(str(jax_wav), str(port_wav))
    # the control script is keyed to the frames each update() renders
    assert port_frames == jax_frames and got["updates"] == len(jax_frames)
    assert got["frames"] == jax_frames[-1] == int(effects_chain.SR * 6.0)
    want, have = _wav(jax_wav), _wav(port_wav)
    assert have.shape == want.shape == (2, got["frames"])
    np.testing.assert_allclose(have, want, atol=TOL, rtol=0)
    assert np.abs(have).max() > 0.05
    # the control script reached the last retrigger and swept the cutoff
    assert effects_chain.cutoff_hz(3.0) == pytest.approx(600.0)


def test_spatial_scene_matches_jax(monkeypatch, tmp_path, capsys):
    jax_mod = _load_jax_example("spatial_scene")
    for mod in (jax_mod, spatial_scene):
        monkeypatch.setattr(mod, "NUM_EMITTERS", 16)
        monkeypatch.setattr(mod, "GROUPS", 4)
    jax_mod.main(str(tmp_path / "jax.wav"))
    printed = capsys.readouterr().out.splitlines()
    got = spatial_scene.main(str(tmp_path / "port.wav"), device="cpu")
    mine = capsys.readouterr().out.splitlines()
    assert mine[0] == printed[0] == "graph: 42 nodes (16 emitters)"
    assert got["nodes"] == 42
    # the meter's reading as printed (the render times differ)
    assert mine[1].split("; render")[0] == printed[1].split("; render")[0].replace(
        "jax.wav", "port.wav")
    want, have = _wav(tmp_path / "jax.wav"), _wav(tmp_path / "port.wav")
    assert have.shape == want.shape and have.shape[1] >= int(1.5 * 48000)
    np.testing.assert_allclose(have, want, atol=TOL, rtol=0)
    assert np.abs(have).max() > 0.01
