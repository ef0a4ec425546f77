"""Scene files across the packages (``firewheel_tpu_torch/graph/
serialize.py``, a copy of the JAX package's over the port's nodes), and the
port's namespace against the JAX package's.

A scene written by either package's ``save_graph`` loads in the other's
``load_graph`` and renders exactly as the same graph built there directly;
a small scene renders in both packages alike (1e-6).  Every class of the
scene registry imports from the port.  The names of the JAX package's
``__all__``s that the port lacks are the list in ``ROADMAP.md``.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import firewheel_tpu as fj
import firewheel_tpu_torch as ft
from firewheel_tpu.graph import serialize as jser
from firewheel_tpu_torch.graph import serialize as tser

SR, F = 48000, 128
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def kitchen_sink(pkg, wav):
    """One graph holding every scene-file node class, built from ``pkg``'s
    node library; every seeded array made with numpy."""
    n = pkg.nodes
    rng = np.random.default_rng(17)
    g = pkg.AudioGraph(pkg.AudioGraphConfig(0, 2))
    beep = g.add_node(0, 2, n.BeepTestNode(330.0, -15.0, True))
    noise = g.add_node(0, 2, n.NoiseNode("pink", gain_db=-24.0, seed=99))
    lfo = g.add_node(0, 2, n.LFONode("triangle", freq_hz=2.5, depth=0.8))
    smp_node = n.SamplerNode(percent_volume=90.0, quality="cubic")
    smp_node.set_sample(pkg.SampleResource(
        rng.standard_normal((2, 4000)).astype(np.float32) * 0.2, sample_rate=44100.0))
    smp_node.set_loop_range(n.LoopRange.range_secs(0.01, 0.08))
    smp_node.set_playback_rate(1.25)
    smp = g.add_node(0, 2, smp_node)
    gran_node = n.GranularSamplerNode(percent_volume=80.0, grain_frames=1024)
    gran_node.set_sample(pkg.SampleResource(
        rng.standard_normal((2, 5000)).astype(np.float32) * 0.2, sample_rate=44100.0))
    gran_node.set_tempo(0.8)
    gran_node.set_pitch_semitones(3.0)
    gran = g.add_node(0, 2, gran_node)
    stream = g.add_node(0, 2, n.StreamingSamplerNode(
        pkg.utils.wav.WavStreamReader(wav), percent_volume=60.0, window_secs=0.1))

    duck = g.add_node(4, 2, n.DuckerNode(threshold_db=-35.0, duck_db=-9.0))
    mix = g.add_node(12, 2, n.SumNode())
    chain = [
        n.VolumeNode(70.0), n.StereoPanNode(-0.3),
        n.ModDelayNode.chorus(rate_hz=1.2, mix=0.4),
        n.TremoloNode(rate_hz=4.0, depth=0.6, bipolar=False),
        n.StereoWidthNode(1.4),
        n.FilterNode(n.FilterType.PEAKING, 2000.0, 1.2, 4.0),
        n.ParametricEQNode([
            n.EQBand(n.FilterType.LOW_SHELF, 130.0, 0.9, 3.0),
            n.EQBand(n.FilterType.PEAKING, 1800.0, 1.4, -5.0, enabled=False),
        ]),
        n.WaveshaperNode("soft", drive_db=9.0, mix=0.6, dc_block=True),
        n.FirFilterNode(n.design_windowed_sinc("lowpass", 33, SR, 9000.0), gain=0.9),
        n.EchoNode(delay_secs=0.05, feedback=0.25, wet=0.3),
        n.DelayCompNode(delay_frames=64),
        n.ModDelayNode.flanger(feedback=0.5),
        n.ConvolutionReverbNode(
            (rng.standard_normal((2, 600)) * 0.1).astype(np.float32), wet=0.2,
            method="direct"),
        n.CompressorNode(threshold_db=-20.0, ratio=3.0),
        n.GateNode(threshold_db=-55.0, range_db=-70.0, hold_secs=0.02),
        n.LimiterNode(ceiling_db=-2.0), n.HardClipNode(-0.5), n.DbMeterNode(),
        n.LoudnessMeterNode(),
    ]
    ids = [g.add_node(2, 2, node) for node in chain]
    s2m = g.add_node(2, 1, n.StereoToMonoNode())
    spat = g.add_node(1, 2, n.Spatializer3DNode((1.0, 0.0, -2.0), rolloff=0.7))
    g.add_node(1, 2, n.BinauralSpatializerNode((-0.5, 0.2, -1.0)))  # no edges
    g.add_node(1, 2, n.MonoToStereoNode())
    for c in range(2):
        g.connect(noise, c, duck, c)
        g.connect(beep, c, duck, 2 + c)
        for i, src in enumerate((duck, beep, lfo, smp, gran, stream)):
            g.connect(src, c, mix, 2 * i + c)
        prev = mix
        for nid in ids:
            g.connect(prev, c, nid, c)
            prev = nid
        g.connect(prev, c, s2m, min(c, 1))
    g.connect(s2m, 0, spat, 0)
    g.connect(spat, 0, g.graph_out_node(), 0)
    g.connect(spat, 1, g.graph_out_node(), 1)
    return g


def play_all(g):
    for e in g.nodes():
        if type(e.weight.node).__name__ in (
                "SamplerNode", "GranularSamplerNode", "StreamingSamplerNode"):
            e.weight.node.play()


def render(pkg, g, blocks=8):
    """``blocks`` blocks of ``g`` in ``pkg`` (the port on the CPU)."""
    play_all(g)
    sched = g.compile(SR, F)
    procs = dict(sched.new_node_processors)
    if pkg is ft:
        prog = ft.ScheduleProgram(sched.schedule, procs, SR, device="cpu")
        gi, im = torch.zeros((1, 0, F)), torch.zeros((1, 0), dtype=torch.bool)
    else:
        prog = fj.ScheduleProgram(sched.schedule, procs, SR)
        gi, im = jnp.zeros((1, 0, F), jnp.float32), jnp.zeros((1, 0), bool)
    state = prog.init_state()
    outs = []
    for i in range(blocks):
        o, _, state = prog.render_chunk(prog.collect_params(), state, gi, im, i * F)
        outs.append(np.asarray(o))
    return np.concatenate(outs, axis=0)


@pytest.fixture
def wav(tmp_path):
    path = str(tmp_path / "clip.wav")
    rng = np.random.default_rng(3)
    ft.utils.wav.write_wav(path, (rng.standard_normal((2, SR // 4)) * 0.1).astype(
        np.float32), SR)
    return path


@pytest.mark.parametrize("writer,reader", [(fj, ft), (ft, fj)])
def test_scene_crosses_between_packages(tmp_path, wav, writer, reader):
    """The writer's scene loads in the reader's package and renders there
    exactly as the same graph built directly in it."""
    path = str(tmp_path / "scene.npz")
    (jser if writer is fj else tser).save_graph(kitchen_sink(writer, wav), path)
    g2, idmap = (tser if reader is ft else jser).load_graph(path)
    names = sorted(type(e.weight.node).__name__ for e in g2.nodes())
    direct = kitchen_sink(reader, wav)
    assert names == sorted(type(e.weight.node).__name__ for e in direct.nodes())
    assert len(list(g2.edges())) == len(list(direct.edges()))
    for e in g2.nodes():
        node = e.weight.node
        assert type(node).__module__.split(".")[0] == reader.__name__
        if type(node).__name__ == "StreamingSamplerNode":
            assert node._reader.path == wav and node._percent_volume == 60.0
        if type(node).__name__ == "GranularSamplerNode":
            assert (node.grain_frames, node.overlap, node.align) == (1024, 4, True)
            assert node._sample.sample_rate == 44100.0 and not node.is_playing()
    a = render(reader, g2)
    assert np.abs(a).max() > 0.01
    np.testing.assert_array_equal(a, render(reader, direct))


def test_small_scene_renders_alike_in_both(tmp_path):
    """A scene of the port's 1e-6 nodes (sampler, granular, beep, volume,
    pan, sum, clip) saved once renders in both packages within 1e-6."""
    rng = np.random.default_rng(23)
    g = fj.AudioGraph(fj.AudioGraphConfig(0, 2))
    smp = fj.nodes.SamplerNode(80.0)
    smp.set_sample(fj.SampleResource(rng.standard_normal((2, 3000)).astype(np.float32) * 0.3))
    gran = fj.nodes.GranularSamplerNode(grain_frames=512, overlap=4)
    gran.set_sample(fj.SampleResource(rng.standard_normal((1, 4000)).astype(np.float32) * 0.3))
    gran.set_tempo(1.3)
    ids = [g.add_node(0, 2, x) for x in (smp, gran, fj.nodes.BeepTestNode(220.0, -20.0))]
    mix = g.add_node(6, 2, fj.nodes.SumNode())
    vol = g.add_node(2, 2, fj.nodes.VolumeNode(60.0))
    pan = g.add_node(2, 2, fj.nodes.StereoPanNode(0.4))
    clip = g.add_node(2, 2, fj.nodes.HardClipNode(-3.0))
    for c in range(2):
        for i, nid in enumerate(ids):
            g.connect(nid, c, mix, 2 * i + c)
        for a, b in ((mix, vol), (vol, pan), (pan, clip)):
            g.connect(a, c, b, c)
        g.connect(clip, c, g.graph_out_node(), c)
    path = str(tmp_path / "small.npz")
    jser.save_graph(g, path)
    want = render(fj, jser.load_graph(path)[0], blocks=12)
    got = render(ft, tser.load_graph(path)[0], blocks=12)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert np.abs(got).max() > 0.05


def test_registry_classes_import_from_the_port():
    t, j = tser._node_registry(), jser._node_registry()
    assert t.keys() == j.keys()
    for name, cls in t.items():
        assert cls.__name__ == name and cls.__module__.startswith("firewheel_tpu_torch.")
    assert tser.SCENE_VERSION == jser.SCENE_VERSION


def test_unknown_node_class_fails_loudly(tmp_path):
    class WeirdNode(ft.AudioNode):
        def info(self):
            return ft.AudioNodeInfo(0, 2, 1, 2)

    g = ft.AudioGraph(ft.AudioGraphConfig(0, 2))
    g.add_node(1, 1, WeirdNode())
    with pytest.raises(TypeError, match="no serialization spec"):
        tser.save_graph(g, str(tmp_path / "x.npz"))


#: the packages compared name by name (``__all__``)
MODULES = ("", ".core", ".nodes", ".utils", ".graph", ".ops", ".parallel", ".backend")


def roadmap_unported():
    """``{module: names}`` from ROADMAP.md's list of JAX names the port
    lacks (the bullets after its "JAX names not yet in the port" line)."""
    with open(os.path.join(REPO, "ROADMAP.md")) as f:
        text = f.read()
    block = text.split("JAX names not yet in the port", 1)[1].split("\n\n", 2)[1]
    out = {}
    for line in block.splitlines():
        m = re.match(r"- `firewheel_tpu(\.\w+)?`: (.*)", line.strip())
        if m:
            out[m.group(1) or ""] = set(re.findall(r"`(\w+)`", m.group(2)))
    return out


def test_unported_names_are_roadmaps_list():
    import importlib

    listed = roadmap_unported()
    for mod in MODULES:
        j = importlib.import_module("firewheel_tpu" + mod)
        t = importlib.import_module("firewheel_tpu_torch" + mod)
        missing = set(getattr(j, "__all__", ())) - set(getattr(t, "__all__", ()))
        assert missing == listed.get(mod, set()), mod
        assert all(hasattr(t, name) for name in getattr(t, "__all__", ())), mod
    assert set(listed) <= set(MODULES)
    for name in ("GranularSamplerNode", "StreamingSamplerNode", "CallbackStreamReader",
                 "MusicPlayer", "load_audio", "open_stream_reader", "register_format",
                 "load_graph", "save_graph", "Edge", "EdgeID", "NodeID",
                 "CompiledSchedule", "SchedulePackage", "SmootherConfig",
                 "ParamSmoother", "SmootherState", "db_to_gain", "gain_to_db",
                 "percent_volume_to_raw_gain"):
        assert name in ft.__all__, name


def test_param_smoother_matches_jax():
    """The host-side smoother (``core/smoother.py:ParamSmoother``) against
    the JAX package's and against the port's device kernel."""
    from firewheel_tpu.core.smoother import ParamSmoother as JPS
    from firewheel_tpu_torch.core.smoother import smoother_coeffs, smoother_init, \
        smoother_set_and_process

    jps, tps = JPS(0.0, SR, 1024), ft.ParamSmoother(0.0, SR, 1024)
    coeffs = smoother_coeffs(SR)
    state = smoother_init(0.0)
    for target in [1.0, 1.0, 0.3, 0.3, 0.3, 0.3, 0.3, -0.5]:
        tv, ts = tps.set_and_process(target, 512)
        jv, js = jps.set_and_process(target, 512)
        np.testing.assert_array_equal(tv, jv)
        assert ts == js and tps.current_value() == jps.current_value()
        kv, state, _ = smoother_set_and_process(state, torch.tensor(target), 512, coeffs)
        np.testing.assert_allclose(kv.numpy(), tv, atol=1e-6, rtol=0)
    st = ft.SmootherState(**state)
    assert st._asdict().keys() == state.keys()
