"""The repo's examples on the port, one module each, named as the JAX
package's example (``examples/<name>.py``) and run as ``python -m
firewheel_tpu_torch.examples.<name>``.  Each ``main`` takes the example's
arguments and ``device`` (the card by default, :func:`~firewheel_tpu_torch.
device.resolve_device`; ``device="cpu"`` runs the kernels' plain
versions), prints what the example prints and returns what it measured.

* :mod:`.beep_test`: the minimal engine, a 440 Hz beep streamed for 4 s
  (``--play``: to the OS speakers);
* :mod:`.effects_chain`: BASELINE config 4, a pluck through filter → echo
  → clip → reverb with retriggers and a cutoff sweep keyed to stream time;
* :mod:`.spatial_scene`: BASELINE config 5, 266 nodes with 128 orbiting
  emitters;
* :mod:`.voice_mixer_64`: BASELINE config 3, 64 resampling voices streamed
  offline to a WAV;
* :mod:`.mastering_bus`: ducker → compressor → FIR shelf → limiter →
  loudness meter, the dialogue toggled and the meter polled into the R128
  gate;
* :mod:`.session_server`: 16 slots over one program, SFX events, live
  settings, disconnects, pcm16;
* :mod:`.game_server`: 16 game instances on one ``BatchRenderer`` with the
  per-instance control plane;
* :mod:`.music_player`: WAV, FLAC and OGG tracks with crossfades, a loop
  and a faded stop;
* :mod:`.voice_pool_game`: an 8-voice pool's battle with stealing;
* :mod:`.midi_jukebox`: a Standard MIDI File sequenced onto a 24-voice
  pool;
* :mod:`.autotune_mix`: three gains fitted by gradient descent through the
  render;
* :mod:`.input_effects`: a live input through filter → echo → clip;
* :mod:`.visual_node_graph`: live DAG edits and the graph's ASCII, DOT,
  schedule and HTML renders;
* :mod:`.interactive_graph`: the browser editor over a running engine.
"""

__all__ = ["autotune_mix", "beep_test", "effects_chain", "game_server", "input_effects",
           "interactive_graph", "mastering_bus", "midi_jukebox", "music_player",
           "session_server", "spatial_scene", "visual_node_graph", "voice_mixer_64",
           "voice_pool_game"]
