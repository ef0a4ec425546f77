"""The port's examples (``firewheel_tpu_torch.examples``) run on the CPU
beside the JAX package's own (``examples/*.py``, loaded from their files),
with every result that is deterministic held equal:

* ``game_server``: every dispatch's output within 1e-6, the finish events
  of the SFX one-shots and each instance's RMS after the mute and the
  reconnect;
* ``input_effects``: the two-tone through filter → echo → clip for 2 s,
  the WAVs within 1e-6;
* ``visual_node_graph``: the rejected cycle, the DOT file, the compiled
  schedule's table and the rendered audio (within 1e-6).

BASELINE config 3's example (``voice_mixer_64``) is held against JAX in
``test_torch_voice_mixer.py``, the interactive editor in
``test_torch_interactive_editor.py``, the other nine examples in
``test_torch_examples_{stream,bus,pool,serving,autotune}.py``.
"""

import importlib.util
import pathlib
import sys

import numpy as np
import pytest
import torch

import firewheel_tpu_torch as ft
from firewheel_tpu_torch.examples import (
    autotune_mix, beep_test, effects_chain, game_server, input_effects, interactive_graph,
    mastering_bus, midi_jukebox, music_player, session_server, spatial_scene,
    visual_node_graph, voice_mixer_64, voice_pool_game,
)

EXAMPLES = pathlib.Path(__file__).parent.parent / "examples"
TOL = 1e-6


def _load_jax_example(name):
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fresh_jax_programs(monkeypatch):
    """Give the JAX package a program cache of its own for the rest of the
    test.  A new ``ScheduleProgram`` reuses the compiled steps of a cached
    program of the same graph (``firewheel_tpu.executor._PROGRAM_CACHE``),
    traced under whatever the node modules held when it was compiled.  A
    test that patches a JAX module read at trace time calls this before it
    patches: the cache is cleared, so JAX traces afresh under the patch,
    and it is swapped for an empty one that ``monkeypatch`` drops when it
    undoes the test's patches, so no program traced under them serves a
    later test in the worker."""
    from firewheel_tpu import executor as jax_executor

    jax_executor.clear_program_cache()
    monkeypatch.setattr(jax_executor, "_PROGRAM_CACHE", {})


def _recording(cls, log):
    """``cls`` with every ``render_chunk`` output appended to ``log``."""
    class Recording(cls):
        def render_chunk(self, *a, **kw):
            out = super().render_chunk(*a, **kw)
            log.append(np.array(out[0].cpu() if hasattr(out[0], "cpu") else out[0]))
            return out

    return Recording


def test_game_server_matches_jax(monkeypatch, capsys):
    jax_mod = _load_jax_example("game_server")
    jax_outs, port_outs = [], []
    monkeypatch.setattr(jax_mod, "BatchRenderer", _recording(jax_mod.BatchRenderer, jax_outs))
    monkeypatch.setattr(game_server, "BatchRenderer",
                        _recording(game_server.BatchRenderer, port_outs))
    jax_mod.main()
    printed = capsys.readouterr().out
    got = game_server.main(device="cpu")
    assert len(port_outs) == len(jax_outs) == 9
    for c, (a, b) in enumerate(zip(port_outs, jax_outs)):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=0, err_msg=f"dispatch {c}")
    assert got["finished"] == list(range(0, game_server.B, 2))
    assert f"SFX finished in instances: {got['finished']}" in printed
    rms = np.asarray(jax_outs[-1])[:, -4:].std(axis=(1, 2, 3))
    np.testing.assert_allclose(got["rms"], rms, atol=TOL, rtol=0)
    assert got["rms"][7] < 1e-6 and (np.delete(got["rms"], 7) > 1e-3).all()
    assert f"{got['instance_seconds']:.1f} instance-seconds" in printed


def test_input_effects_matches_jax(monkeypatch, tmp_path):
    jax_wav, port_wav = tmp_path / "jax.wav", tmp_path / "port.wav"
    monkeypatch.setattr(sys, "argv", ["input_effects.py", str(jax_wav)])
    _load_jax_example("input_effects").main()
    assert input_effects.main(str(port_wav), device="cpu") == str(port_wav)
    want = ft.load_audio(str(jax_wav), device=False)[0].host_data
    got = ft.load_audio(str(port_wav), device=False)[0].host_data
    assert got.shape == want.shape and got.shape[1] >= 2 * input_effects.SR
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    # the 3 kHz lowpass keeps the 500 Hz tone and cuts the 9 kHz one
    spec = np.abs(np.fft.rfft(got[0, -48000:]))
    assert spec[500] > 30 * spec[9000]


def test_input_effects_mic_needs_sounddevice(monkeypatch):
    from firewheel_tpu_torch.backend import os_audio

    monkeypatch.setattr(os_audio, "os_audio_available", lambda: False)
    with pytest.raises(SystemExit, match="sounddevice"):
        input_effects.main(mic=True, device="cpu")


def test_visual_node_graph_matches_jax(monkeypatch, tmp_path, capsys):
    jax_mod = _load_jax_example("visual_node_graph")
    sinks = []

    class Sink(jax_mod.ArraySink):
        def __init__(self):
            super().__init__()
            sinks.append(self)

    monkeypatch.setattr(jax_mod, "ArraySink", Sink)
    jax_mod.main(str(tmp_path / "jax.html"))
    printed = capsys.readouterr().out
    got = visual_node_graph.main(str(tmp_path / "port.html"), device="cpu")
    assert got["cycle_rejected"]
    assert "(cycle attempt rejected" in printed
    assert got["dot"] == (tmp_path / "jax.dot").read_text()
    assert (tmp_path / "port.dot").read_text() == got["dot"]
    assert got["schedule"] and f"=== compiled schedule ===\n{got['schedule']}\n" in printed
    assert got["ascii"] in printed
    want = sinks[0].audio(2)
    assert got["audio"].shape == want.shape
    np.testing.assert_allclose(got["audio"], want, atol=TOL, rtol=0)
    assert np.abs(got["audio"]).max() > 0.05
    assert "<html" in (tmp_path / "port.html").read_text()


@pytest.mark.parametrize("run", [
    lambda tmp: voice_mixer_64.main(str(tmp / "x.wav")),
    lambda tmp: game_server.main(),
    lambda tmp: input_effects.main(str(tmp / "x.wav")),
    lambda tmp: visual_node_graph.main(str(tmp / "x.html")),
    lambda tmp: interactive_graph.EngineApp(),
    lambda tmp: beep_test.main(str(tmp / "x.wav")),
    lambda tmp: session_server.main(),
    lambda tmp: effects_chain.main(str(tmp / "x.wav")),
    lambda tmp: mastering_bus.main(str(tmp / "x.wav")),
    lambda tmp: spatial_scene.main(str(tmp / "x.wav")),
    lambda tmp: music_player.main(str(tmp)),
    lambda tmp: voice_pool_game.main(str(tmp / "x.wav")),
    lambda tmp: midi_jukebox.main(None, str(tmp / "x.wav")),
    lambda tmp: autotune_mix.main(),
], ids=["voice_mixer_64", "game_server", "input_effects", "visual_node_graph",
        "interactive_graph", "beep_test", "session_server", "effects_chain",
        "mastering_bus", "spatial_scene", "music_player", "voice_pool_game",
        "midi_jukebox", "autotune_mix"])
def test_examples_default_to_the_card(run, monkeypatch, tmp_path):
    """Each example runs on the card unless its caller passes ``device``:
    without one it raises, and it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run(tmp_path)
