"""The port's main path as a whole — the batched 64-node mixer — held
against the JAX package on the CPU.

JAX renders the mixer with ``FilterNode(backend="pallas")`` (the Pallas
kernel in interpret mode, through the JAX ``BatchRenderer``); the port
renders ``mixer_graph()`` through its own ``BatchRenderer``.  Both start
from the same params (made per instance, so the two instances differ) and
render B=2 instances, K=4 blocks a chunk.

Tolerance 1e-6 absolute on audio and state: both packages evaluate the same
float32 ops in the same order (the biquad with the same fused
multiply-adds), but torch's and XLA's f32 sin/cos/exp round independently,
by up to an ulp; the sum of 19 voices, the filter and the echo feedback
carry that to a few ulp of the ~0.7 peak (≈2e-7 measured).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import firewheel_tpu_torch as ft
from firewheel_tpu import AudioGraph, AudioGraphConfig, ScheduleProgram
from firewheel_tpu import nodes as jn
from firewheel_tpu.core.node import BlockInfo as JBlockInfo
from firewheel_tpu.parallel import BatchRenderer as JBatchRenderer
from firewheel_tpu_torch.convert import (
    params_from_jax, state_from_jax, state_to_numpy, tree_map,
)
from firewheel_tpu_torch.core.node import BlockInfo as TBlockInfo

SR = 48000
B = 2
K = 4
F = 128
TOL = 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_mixer(num_voices=19):
    """``__graft_entry__._mixer_graph`` with the Pallas filter backend."""
    g = AudioGraph(AudioGraphConfig(0, 2))
    s = g.add_node(2 * num_voices, 2, jn.SumNode())
    for i in range(num_voices):
        beep = g.add_node(0, 2, jn.BeepTestNode(110.0 * (1 + i % 12), -18.0, True))
        vol = g.add_node(2, 2, jn.VolumeNode(80.0))
        pan = g.add_node(2, 2, jn.StereoPanNode((i / max(num_voices - 1, 1)) * 2 - 1))
        g.connect(beep, 0, vol, 0)
        g.connect(beep, 1, vol, 1)
        g.connect(vol, 0, pan, 0)
        g.connect(vol, 1, pan, 1)
        g.connect(pan, 0, s, 2 * i)
        g.connect(pan, 1, s, 2 * i + 1)
    filt = g.add_node(2, 2, jn.FilterNode(jn.FilterType.LOWPASS, 8000.0,
                                          backend="pallas"))
    echo = g.add_node(2, 2, jn.EchoNode(delay_secs=0.25, feedback=0.3))
    clip = g.add_node(2, 2, jn.HardClipNode(0.0))
    meter = g.add_node(2, 2, jn.DbMeterNode())
    chain = [s, filt, echo, clip, meter, g.graph_out_node()]
    for a, b in zip(chain, chain[1:]):
        g.connect(a, 0, b, 0)
        g.connect(a, 1, b, 1)
    pkg = g.compile(SR, F)
    return ScheduleProgram(pkg.schedule, dict(pkg.new_node_processors), SR)


def instance_params(prog):
    """Two per-instance snapshots: the defaults, and one with another
    cutoff, a quieter voice, a muted voice and a disabled beep."""
    p0 = prog.collect_params()
    p1 = jax.tree.map(np.copy, p0)
    key = {k.split("-")[0]: [] for k in p1}
    for k in p1:
        key[k.split("-")[0]].append(k)
    p1[key["filter"][0]]["freq"] = np.float32(3000.0)
    p1[key["volume"][3]]["raw_gain"] = np.float32(0.09)
    p1[key["volume"][5]]["raw_gain"] = np.float32(0.0)
    p1[key["beep_test"][7]]["enabled"] = np.asarray(False)
    return [p0, p1]


@pytest.fixture(scope="module")
def both():
    jprog = jax_mixer()
    tprog = ft.mixer_graph(device="cpu")
    plist = instance_params(jprog)
    jbr = JBatchRenderer(jprog, B)
    tbr = ft.BatchRenderer(tprog, B, device="cpu")
    return jprog, tprog, jbr, tbr, jbr.stack_params(plist), tbr.stack_params(plist)


def _np(tree):
    return state_to_numpy(state_from_jax(jax.tree.map(np.asarray, tree), "cpu"))


def _assert_close(a, b, tol=TOL):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _assert_close(a[k], b[k], tol)
        else:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_allclose(a[k], b[k], atol=tol, rtol=0, err_msg=k)


def test_compiler_gives_the_same_schedule_and_keys(both):
    jprog, tprog, *_ = both
    assert len(tprog.schedule.schedule) == 64
    assert repr(tprog.schedule) == repr(jprog.schedule)
    assert list(tprog._procs) == list(jprog._procs)
    assert [(k, [repr(sn.id) for sn in m]) for k, m in tprog._plan] == [
        (k, [repr(sn.id) for sn in m]) for k, m in jprog._plan
    ]
    # 3 pooled groups of 19 (beep, volume, pan) and 5 singles
    assert [len(m) for _, m in tprog._plan] == [19, 19, 19, 1, 1, 1, 1, 1]


@pytest.mark.parametrize("kind", ["state", "params"])
def test_stacked_trees_match_jax(both, kind):
    jprog, tprog, jbr, tbr, jparams, tparams = both
    if kind == "state":
        _assert_close(state_to_numpy(tbr.init_state()), _np(jbr.init_state()), 0)
    else:
        _assert_close(state_to_numpy(tparams), _np(jparams), 0)


def test_three_chunks_match_jax(both):
    """Outputs, silence masks and the final state over 3 chunks, with the
    stream clock advancing."""
    jprog, tprog, jbr, tbr, jparams, tparams = both
    jstate, tstate = jbr.init_state(), tbr.init_state()
    start = 0
    for _ in range(3):
        jo, jm, jstate = jbr.render_chunk(jparams, jstate, start_sample=start,
                                          num_blocks=K)
        to, tm, tstate = tbr.render_chunk(tparams, tstate, start_sample=start,
                                          num_blocks=K)
        assert to.shape == (B, K, 2, F) and tm.shape == (B, K, 2)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=TOL, rtol=0)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        start += K * F
    assert float(to.abs().max()) > 0.1  # audible, and the instances differ
    assert not torch.equal(to[0], to[1])
    _assert_close(state_to_numpy(tstate), _np(jstate))


def test_mid_stream_handoff_from_jax(both):
    """JAX renders 2 chunks; its state crosses over; the port's next chunk
    matches JAX's next chunk."""
    jprog, tprog, jbr, tbr, jparams, tparams = both
    jstate = jbr.init_state()
    for c in range(2):
        _, _, jstate = jbr.render_chunk(jparams, jstate, start_sample=c * K * F,
                                        num_blocks=K)
    tstate = state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
    jo, jm, jstate = jbr.render_chunk(jparams, jstate, start_sample=2 * K * F,
                                      num_blocks=K)
    to, tm, tstate = tbr.render_chunk(tparams, tstate, start_sample=2 * K * F,
                                      num_blocks=K)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=TOL, rtol=0)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    _assert_close(state_to_numpy(tstate), _np(jstate))


def test_update_instance_matches_jax(both):
    jprog, tprog, jbr, tbr, jparams, tparams = both
    one = instance_params(jprog)[1]
    jnew = jbr.update_instance(jparams, 0, one)
    tnew = tbr.update_instance(tree_map(torch.clone, tparams), 0, one)
    _assert_close(state_to_numpy(tnew), _np(jnew), 0)


def test_render_block_one_instance_matches_jax(both):
    """The executor with no batch axis: one block of one instance."""
    jprog, tprog, *_ = both
    params = jprog.collect_params()
    jo, jm, jst = jprog.render_block(
        params, jprog.init_state(), jnp.zeros((0, F)), jnp.zeros((0,), bool),
        JBlockInfo.make(0.0, 0),
    )
    to, tm, tst = tprog.render_block(
        params, tprog.init_state(), torch.zeros((0, F)),
        torch.zeros((0,), dtype=torch.bool), TBlockInfo.make(0.0, 0),
    )
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=TOL, rtol=0)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    _assert_close(state_to_numpy(tst), _np(jst))


def test_port_imports_no_jax():
    """Importing the port, rendering one CPU chunk with each lowering
    (eager, megakernel, and hybrid on the effects chain and on the spatial
    scene with speaker, doppler and binaural spatializers), streaming the
    mixer through ``FirewheelCtx`` (with its native ring built), placing
    an emitter in a ``SpatialScene``, importing each module of the sampler
    and formats slice, and streaming a granular voice beside a
    ``MusicPlayer`` deck playing a FLAC file, then saving the scene,
    importing the ``ops`` namespace, validating a node, playing a MIDI
    note through a ``VoicePool``, and importing the scale-out (``parallel``
    with ``distributed``, slicing a batch with no process group), ``viz``,
    the profiler and the OS-audio module, and rendering the entry point's
    chunk (``entry.entry``), leave JAX and the JAX package out of
    ``sys.modules``."""
    code = (
        "import sys\n"
        "import firewheel_tpu_torch as ft\n"
        "from firewheel_tpu_torch.executor_mega import MegaRenderer\n"
        "br = ft.BatchRenderer(ft.mixer_graph(device='cpu'), 2, device='cpu')\n"
        "out, om, st = br.render_chunk(br.stack_params(), br.init_state(),"
        " num_blocks=2)\n"
        "assert out.shape == (2, 2, 2, 128), out.shape\n"
        "mr = MegaRenderer(ft.mixer_graph(device='cpu'), 2, 2, device='cpu')\n"
        "out, om, st = mr.render_chunk(mr.stack_params(), st, 256)\n"
        "assert out.shape == (2, 2, 2, 128), out.shape\n"
        "hb = ft.BatchRenderer(ft.effects_chain_graph(device='cpu'), 2, device='cpu',"
        " lowering='hybrid')\n"
        "out, om, st = hb.render_chunk(hb.stack_params(), hb.init_state(),"
        " num_blocks=2)\n"
        "assert out.shape == (2, 2, 2, 128) and float(out.abs().max()) > 0.01\n"
        "cx = ft.FirewheelCtx(device='cpu')\n"
        "ft.mixer.add_mixer(cx.graph_mut(), 2)\n"
        "sink = ft.ArraySink()\n"
        "cx.activate(ft.StreamConfig(block_frames=128), sink=sink)\n"
        "cx.render_offline(0.05)\n"
        "assert sink.audio(2).shape[1] >= 2400 and ft.RingBuffer(8).is_native\n"
        "cx.deactivate()\n"
        "import tempfile\n"
        "srv = ft.SessionServer(ft.mixer_graph(num_voices=2, device='cpu'), 2,"
        " chunk_blocks=2, device='cpu', output_format='pcm16')\n"
        "h = srv.connect()\n"
        "assert srv.render_fetched() is None and srv.flush().dtype.name == 'int16'\n"
        "srv.save_checkpoint(tempfile.mkdtemp())\n"
        "g = ft.AudioGraph(ft.AudioGraphConfig(0, 2))\n"
        "ft.mixer.add_mixer(g, 2)\n"
        "assert g.compensate_latency(48000).insertions == []\n"
        "for kw in ({}, {'doppler_every': 2}, {'binaural': True}):\n"
        "    p = ft.spatial_scene_graph(4, 2, device='cpu', **kw)\n"
        "    sb = ft.BatchRenderer(p, 2, device='cpu', lowering='hybrid')\n"
        "    out, om, st = sb.render_chunk(sb.stack_params(), sb.init_state(),"
        " num_blocks=2)\n"
        "    assert float(out.abs().max()) > 0.001, kw\n"
        "scene = ft.SpatialScene(ft.AudioListener(forward=(1.0, 0.0, 0.0)))\n"
        "scene.add('e', ft.Spatializer3DNode(), (5.0, 0.0, 0.0))\n"
        "import importlib, numpy as np\n"
        "for m in ('nodes.granular', 'nodes.streaming_sampler', 'core.formats',"
        " 'core.flac', 'core.ranges', 'utils.wav', 'utils.flac_encode', 'utils.mp3',"
        " 'utils.vorbis', 'utils.opus', 'utils.resample', 'music', 'graph.serialize'):\n"
        "    importlib.import_module('firewheel_tpu_torch.' + m)\n"
        "cx = ft.FirewheelCtx(device='cpu')\n"
        "player = ft.MusicPlayer(cx.graph_mut(), clock=lambda: cx.stream.frames_rendered)\n"
        "gran = ft.GranularSamplerNode(grain_frames=512)\n"
        "gran.set_sample(ft.SampleResource(np.ones((2, 4000), np.float32)))\n"
        "gran.play()\n"
        "cx.graph_mut().add_node(0, 2, gran)\n"
        "path = tempfile.mkdtemp() + '/t.flac'\n"
        "ft.encode_flac(np.zeros((2, 3000), np.float32), 48000, path=path)\n"
        "cx.activate(ft.StreamConfig(block_frames=128, buffer_frames=512), sink=ft.ArraySink())\n"
        "player.play(path)\n"
        "cx.render_offline(0.05)\n"
        "ft.save_graph(cx.graph_mut(), tempfile.mkdtemp() + '/s.npz')\n"
        "cx.deactivate()\n"
        "from firewheel_tpu_torch import ops, testing, utils\n"
        "assert len(ops.__all__) == 23 and all(hasattr(ops, n) for n in ops.__all__)\n"
        "assert testing.validate_node(ft.nodes.VolumeNode(80.0), 2, 2, device='cpu')"
        "['vmap'] == 'ok'\n"
        "cx = ft.FirewheelCtx(device='cpu')\n"
        "pool = ft.VoicePool(cx.graph_mut(), num_voices=2, max_clip_frames=256,"
        " clock=lambda: cx.stream.frames_rendered)\n"
        "cx.activate(ft.StreamConfig(block_frames=128, buffer_frames=256), sink=ft.ArraySink())\n"
        "seq = utils.MidiSequencer(pool, utils.parse_midi(bytes.fromhex("
        "'4d546864000000060000000101e04d54726b0000000c00903c40608"
        "03c0000ff2f00')), {0: utils.Instrument(ft.SampleResource("
        "np.ones((1, 200), np.float32)))})\n"
        "seq.start()\n"
        "seq.update()\n"
        "cx.render_offline(0.05)\n"
        "cx.deactivate()\n"
        "assert utils.HttpWavStreamReader and utils.SegmentCache\n"
        "from firewheel_tpu_torch import parallel\n"
        "from firewheel_tpu_torch.parallel import distributed\n"
        "import firewheel_tpu_torch.utils.viz, firewheel_tpu_torch.utils.profiler\n"
        "import firewheel_tpu_torch.backend.os_audio as osa\n"
        "assert parallel.local_batch_slice(8) == slice(0, 8) and len(parallel.__all__) == 5\n"
        "assert all(hasattr(parallel, n) for n in parallel.__all__)\n"
        "assert osa.os_audio_available() in (True, False)\n"
        "from firewheel_tpu_torch import examples\n"
        "for m in examples.__all__:\n"
        "    importlib.import_module('firewheel_tpu_torch.examples.' + m)\n"
        "assert ft.mixer.voice_mixer_64_graph(4, 2, device='cpu')\n"
        "from firewheel_tpu_torch.entry import entry\n"
        "fn, args = entry(device='cpu')\n"
        "assert fn(*args)[0].shape == (2, 4, 2, 128)\n"
        "for m in ('nodes.sampler', 'nodes.reverb', 'ops.fft_conv',"
        " 'ops.direct_conv', 'executor_hybrid', 'processor', 'context',"
        " 'channels', 'backend.context', 'backend.stream', 'backend.ring_buffer',"
        " 'backend.device_info', 'core.events', 'core.interleave',"
        " 'core.silence_mask', 'core.automation', 'serving', 'checkpoint',"
        " '_msgpack', 'graph.latency', 'nodes.spatial', 'nodes.binaural',"
        " 'scene3d', 'ops.pan', 'ops.iir', 'nodes.granular', 'nodes.streaming_sampler',"
        " 'core.formats', 'core.flac', 'core.ranges', 'utils.wav', 'utils.flac_encode',"
        " 'utils.mp3', 'utils.vorbis', 'utils.opus', 'utils.resample', 'music',"
        " 'graph.serialize', 'voice_pool', 'utils.midi', 'utils.net_stream', 'ops',"
        " 'ops.delay', 'testing', 'parallel', 'parallel.distributed', 'utils.viz',"
        " 'utils.profiler', 'backend.os_audio', 'examples.voice_mixer_64',"
        " 'examples.game_server', 'examples.input_effects', 'examples.visual_node_graph',"
        " 'examples.interactive_graph', 'examples.beep_test', 'examples.session_server',"
        " 'examples.effects_chain', 'examples.mastering_bus', 'examples.spatial_scene',"
        " 'examples.music_player', 'examples.voice_pool_game', 'examples.midi_jukebox',"
        " 'examples.autotune_mix', 'entry'):\n"
        "    assert 'firewheel_tpu_torch.' + m in sys.modules, m\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.split('.')[0] == 'firewheel_tpu']\n"
        "print('loaded:', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "loaded: []" in proc.stdout


def test_port_sources_never_import_jax():
    pkg = os.path.join(REPO, "firewheel_tpu_torch")
    for root, dirs, files in os.walk(pkg):
        dirs[:] = [d for d in dirs if d != "_build"]  # build outputs
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as fh:
                    for line in fh:
                        words = line.split()
                        if words[:1] in (["import"], ["from"]) and len(words) > 1:
                            top = words[1].split(".")[0]
                            assert top not in ("jax", "jaxlib", "firewheel_tpu"), (
                                name, line)


def test_batch_renderer_rejects_unported_formats():
    """Every format the JAX package has is ported ("adpcm4" in
    ``tests/test_torch_adpcm.py``); a format neither package has is
    refused."""
    with pytest.raises(ValueError, match="output_format"):
        ft.BatchRenderer(ft.mixer_graph(num_voices=1, device="cpu"), 1, device="cpu",
                         output_format="mp3")
