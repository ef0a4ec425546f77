"""The repo's examples on the port, one module each, named as the JAX
package's example (``examples/<name>.py``) and run as ``python -m
firewheel_tpu_torch.examples.<name>``.  Each ``main`` takes the example's
arguments and ``device`` (the card by default, :func:`~firewheel_tpu_torch.
device.resolve_device`; ``device="cpu"`` runs the kernels' plain
versions), prints what the example prints and returns what it measured.

* :mod:`.voice_mixer_64`: BASELINE config 3, 64 resampling voices streamed
  offline to a WAV;
* :mod:`.game_server`: 16 game instances on one ``BatchRenderer`` with the
  per-instance control plane;
* :mod:`.input_effects`: a live input through filter → echo → clip;
* :mod:`.visual_node_graph`: live DAG edits and the graph's ASCII, DOT,
  schedule and HTML renders;
* :mod:`.interactive_graph`: the browser editor over a running engine.
"""

__all__ = ["game_server", "input_effects", "interactive_graph", "visual_node_graph",
           "voice_mixer_64"]
