"""The port's entry points run on the card unless the caller asks for the
CPU (``firewheel_tpu_torch.device.resolve_device``).

With ``torch.cuda.is_available`` patched to False, each entry point raises
``RuntimeError`` when given no device, and runs its plain version when
given ``device="cpu"``: it never falls back to the CPU by itself.
"""

import pytest
import torch

import firewheel_tpu_torch as ft
from firewheel_tpu_torch import mixer
from firewheel_tpu_torch.device import resolve_device
from firewheel_tpu_torch.executor_hybrid import HybridMegaRenderer
from firewheel_tpu_torch.executor_mega import MegaRenderer
from firewheel_tpu_torch.nodes import VolumeNode

K = 2


def _schedule_program(**kw):
    g = ft.AudioGraph(ft.AudioGraphConfig(0, 2))
    v = g.add_node(2, 2, VolumeNode(80.0))
    for c in range(2):
        g.connect(v, c, g.graph_out_node(), c)
    pkg = g.compile(48000, 128)
    return ft.ScheduleProgram(pkg.schedule, dict(pkg.new_node_processors), 48000, **kw)


def _cpu_mixer():
    return mixer.mixer_graph(num_voices=1, device="cpu")


ENTRY_POINTS = {
    "ScheduleProgram": _schedule_program,
    "BatchRenderer": lambda **kw: ft.BatchRenderer(_cpu_mixer(), 2, **kw),
    "MegaRenderer": lambda **kw: MegaRenderer(_cpu_mixer(), 2, K, **kw),
    "HybridMegaRenderer": lambda **kw: HybridMegaRenderer(_cpu_mixer(), 2, K, **kw),
    "mixer_graph": lambda **kw: mixer.mixer_graph(num_voices=1, **kw),
    "effects_chain_graph": lambda **kw: mixer.effects_chain_graph(clip_frames=512, **kw),
    "effects_chain_config4_graph": mixer.effects_chain_config4_graph,
    "random_graph": lambda **kw: mixer.random_graph(0, **kw),
    "mastering_bus_graph": mixer.mastering_bus_graph,
    "voice_mixer_64_graph": lambda **kw: mixer.voice_mixer_64_graph(4, 2, **kw),
}


def _render(obj):
    """One chunk of ``obj`` (a renderer, or a program through the eager
    BatchRenderer) on the CPU."""
    if isinstance(obj, ft.ScheduleProgram):
        obj = ft.BatchRenderer(obj, 2, device="cpu")
    if isinstance(obj, ft.BatchRenderer):
        out, masks, _ = obj.render_chunk(obj.stack_params(), obj.init_state(),
                                         num_blocks=K)
    else:
        out, masks, _ = obj.render_chunk(obj.stack_params(), obj.init_state())
    assert out.device.type == "cpu" and out.shape[:2] == (2, K)
    assert bool(torch.isfinite(out).all()) and masks.shape == out.shape[:3]


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY_POINTS[name]()
    obj = ENTRY_POINTS[name](device="cpu")
    assert obj.device == torch.device("cpu")
    _render(obj)


def test_resolve_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")
    for device in ("cuda", "cuda:0", torch.device("cuda", 1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(device)
