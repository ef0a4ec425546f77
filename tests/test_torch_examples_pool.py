"""The port's sampler-bank examples (``firewheel_tpu_torch.examples``) on
the CPU beside the JAX package's own (``examples/*.py``, loaded from their
files), on the same inputs, the WAVs within 1e-6 and the printed lines
equal:

* ``voice_pool_game``: the 8-voice battle, 6 s in 330 ms ticks: every
  shot's voice and generation (or its drop) equal.  The example seeds its
  noise with ``hash(kind)``, which changes from process to process; the
  port seeds it with the CRC-32 of the name, and here the JAX example's
  ``hash`` is that CRC-32 too;
* ``midi_jukebox``: the demo song written to a ``.mid`` file and played
  from that path on a 24-voice pool, cut on both sides to its first 3 s
  of audio by a capped ``render_offline`` (the sequencer's loop runs on to
  the song's end; the whole 13.7 s runs on the card in ``chip_smoke.py``);
* ``music_player``: the WAV intro, the FLAC bed and the outro as OGG (the
  system's Vorbis codec encodes and decodes here) and as WAV (the codec
  reported missing on both sides): the bounce, the finish events' count.
"""

import zlib

import numpy as np
import pytest

import firewheel_tpu_torch as ft
from firewheel_tpu_torch.examples import midi_jukebox, music_player, voice_pool_game
from firewheel_tpu_torch.utils import vorbis
from test_torch_examples import TOL, _load_jax_example

JUKE_SECS = 3.0


def _wav(path):
    return ft.load_audio(str(path), device=False)[0].host_data


def test_voice_pool_game_matches_jax(monkeypatch, tmp_path, capsys):
    jax_mod = _load_jax_example("voice_pool_game")
    monkeypatch.setattr(jax_mod, "hash", lambda s: zlib.crc32(s.encode()), raising=False)
    shots = []

    class Pool(jax_mod.VoicePool):
        def play(self, *a, **kw):
            h = super().play(*a, **kw)
            shots.append(None if h is None else (h._index, h._gen))
            return h

    monkeypatch.setattr(jax_mod, "VoicePool", Pool)
    jax_mod.main(str(tmp_path / "jax.wav"))
    printed = capsys.readouterr().out
    got = voice_pool_game.main(str(tmp_path / "port.wav"), device="cpu")
    assert capsys.readouterr().out == printed.replace("jax.wav", "port.wav")
    assert got["shots"] == shots and len(shots) > 20
    assert "(1 voice(s) still looping at the end)" in printed and got["active"] == 1
    want, have = _wav(tmp_path / "jax.wav"), _wav(tmp_path / "port.wav")
    assert have.shape == want.shape and have.shape[1] >= 6 * 48000
    np.testing.assert_allclose(have, want, atol=TOL, rtol=0)
    assert np.abs(have).max() > 0.05
    for kind in ("footstep", "laser", "explosion", "engine"):
        np.testing.assert_array_equal(voice_pool_game.synth_clip(kind).host_data,
                                      np.asarray(jax_mod.synth_clip(kind).data))


def _capped(cls, secs):
    """``cls`` (a ``FirewheelCtx``) whose ``render_offline`` stops at
    ``secs`` of stream time."""
    class Capped(cls):
        def render_offline(self, duration_secs):
            left = secs - self.stream.frames_rendered / 48000
            if left > 0:
                super().render_offline(min(duration_secs, left))

    return Capped


def test_midi_jukebox_matches_jax(monkeypatch, tmp_path, capsys):
    song = tmp_path / "demo.mid"
    song.write_bytes(midi_jukebox.demo_song())
    jax_wav, port_wav = tmp_path / "jax.wav", tmp_path / "port.wav"
    jax_mod = _load_jax_example("midi_jukebox")
    assert jax_mod.demo_song() == song.read_bytes()
    monkeypatch.setattr(jax_mod, "FirewheelCtx", _capped(jax_mod.FirewheelCtx, JUKE_SECS))
    monkeypatch.setattr(midi_jukebox, "FirewheelCtx",
                        _capped(midi_jukebox.FirewheelCtx, JUKE_SECS))
    monkeypatch.setattr("sys.argv", ["midi_jukebox.py", str(song), str(jax_wav)])
    jax_mod.main()
    printed = capsys.readouterr().out
    assert midi_jukebox._cli([str(song), str(port_wav)]) == (str(song), str(port_wav))
    got = midi_jukebox.main(str(song), str(port_wav), device="cpu")
    assert capsys.readouterr().out == printed.replace(str(jax_wav), str(port_wav))
    assert printed.startswith("song: 128 notes, 13.7 s, 3 tracks, tempo 140 bpm")
    want, have = _wav(jax_wav), _wav(port_wav)
    assert have.shape == want.shape and have.shape[1] >= JUKE_SECS * 48000
    np.testing.assert_allclose(have, want, atol=TOL, rtol=0)
    np.testing.assert_array_equal(got["audio"], have)
    assert got["peak"] > 0.1 and got["dropped"] == got["skipped"] == 0


def test_midi_jukebox_arguments():
    """The example's ``[song.mid] [out.wav]``: a .mid first is the song,
    anything else the output; with neither, the demo song and the default
    output."""
    assert midi_jukebox._cli([]) == (None, None)
    assert midi_jukebox._cli(["x.wav"]) == (None, "x.wav")
    assert midi_jukebox._cli(["s.mid"]) == ("s.mid", None)
    assert midi_jukebox._cli(["--cpu", "s.mid", "o.wav"]) == ("s.mid", "o.wav")


@pytest.mark.parametrize("codec", [True, False], ids=["ogg_outro", "wav_outro"])
def test_music_player_matches_jax(codec, monkeypatch, tmp_path, capsys):
    if codec and not all(vorbis.available().values()):
        pytest.skip("the system's Vorbis codec is missing here")
    jax_mod = _load_jax_example("music_player")
    from firewheel_tpu.utils import vorbis as jax_vorbis

    both = {"encode": codec, "decode": codec}
    monkeypatch.setattr(jax_vorbis, "available", lambda: both)
    monkeypatch.setattr(vorbis, "available", lambda: both)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jax_mod.main(str(tmp_path / "jax"))
    printed = capsys.readouterr().out
    got = music_player.main(str(tmp_path / "port"), device="cpu")
    assert capsys.readouterr().out == printed.replace(str(tmp_path / "jax"),
                                                      str(tmp_path / "port"))
    assert got["outro"] == (".ogg" if codec else ".wav")
    assert f"{len(got['finished'])} track-finish events" in printed
    assert got["finished"][0] == "_intro.wav" and len(got["finished"]) >= 3
    want, have = _wav(tmp_path / "jax" / "music_demo.wav"), _wav(got["path"])
    assert have.shape == want.shape and have.shape[1] > 6 * 48000
    np.testing.assert_allclose(have, want, atol=TOL, rtol=0)
    assert np.abs(have).max() > 0.1
    # the tracks are removed, the bounce kept
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == ["music_demo.wav"]
