"""The spatial scene (BASELINE config 5, ``examples/spatial_scene.py``) on
the port, cut to 16 emitters in 4 groups, held against the JAX package on
the CPU.

* the port's ``BatchRenderer`` against JAX's over three chunks, every
  instance with its own positions, volumes and occlusion;
* the port's ``FirewheelCtx`` stream with the example's orbit automation
  and a ``SpatialScene`` listener turn mid-stream against JAX's;
* the megakernel's plain version (``mega_chunk_reference``, the
  spatializer rows on the sequential one-pole) against the port's eager
  render and JAX's ``MegaRenderer(interpret=True)``;
* the hybrid's plain version on the scene with every 4th emitter doppler
  (torch stages between islands) against JAX's ``HybridMegaRenderer
  (interpret=True)`` and JAX's ``BatchRenderer``;
* a JAX fleet checkpoint of the scene restored into the port and rendered
  on;
* the 128-emitter scene's shared memory in the megakernel.

Tolerance 1e-5 on audio and float state, masks and integer state equal:
the eager paths agree to ~1e-7; the megakernel's one-pole is the
sequential recurrence where the eager path and JAX's XLA path run the
associative scan, and JAX's megakernel the Hillis–Steele scan.
"""

import jax
import numpy as np
import pytest
import torch

import firewheel_tpu as fw
from firewheel_tpu import nodes as jn
from firewheel_tpu.executor_pallas import HybridMegaRenderer as JHybrid
from firewheel_tpu.executor_pallas import MegaRenderer as JMegaRenderer
from firewheel_tpu.parallel import BatchRenderer as JBatchRenderer
import firewheel_tpu_torch as ft
from firewheel_tpu_torch import executor_mega as em
from firewheel_tpu_torch import mixer
from firewheel_tpu_torch import nodes as tn
from firewheel_tpu_torch.convert import state_from_jax, state_to_numpy
from firewheel_tpu_torch.executor_hybrid import HybridMegaRenderer

SR, F = 48000, 128
EMITTERS, GROUPS = 16, 4
B, K = 2, 4
KI = 2  # blocks a chunk where JAX's megakernel runs in interpret mode
TOL = 1e-5


def jax_scene(doppler_every=0):
    g = fw.AudioGraph(fw.AudioGraphConfig(0, 2))
    mixer.add_spatial_scene(g, EMITTERS, GROUPS, doppler_every, nodes=jn)
    pkg = g.compile(SR, F)
    return fw.ScheduleProgram(pkg.schedule, dict(pkg.new_node_processors), SR)


def port_scene(doppler_every=0):
    return mixer.spatial_scene_graph(EMITTERS, GROUPS, doppler_every, device="cpu")


def _np(tree):
    return state_to_numpy(state_from_jax(jax.tree.map(np.asarray, tree), "cpu"))


def assert_close(a, b, path=()):
    assert a.keys() == b.keys(), path
    for k in a:
        if isinstance(a[k], dict):
            assert_close(a[k], b[k], path + (k,))
        elif a[k].dtype.kind == "f":
            np.testing.assert_allclose(a[k], b[k], atol=TOL, rtol=0,
                                       err_msg=str(path + (k,)))
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=str(path + (k,)))


def varied(prog, seed=1):
    """Batch-stacked params, each instance with its own emitters."""
    br = ft.BatchRenderer(prog, B, device="cpu")
    return br, mixer.vary_spatial_params(prog, br.stack_params(), seed)


def test_scene_compiles_as_the_jax_package_does():
    jprog, tprog = jax_scene(), port_scene()
    assert len(tprog.schedule.schedule) == EMITTERS * 2 + GROUPS + 6
    assert repr(tprog.schedule) == repr(jprog.schedule)
    assert list(tprog._procs) == list(jprog._procs)
    # the beeps and the spatializers pool into one group each, as in JAX
    assert [(k, [repr(sn.id) for sn in m]) for k, m in tprog._plan] == [
        (k, [repr(sn.id) for sn in m]) for k, m in jprog._plan]
    assert [len(m) for _, m in tprog._plan][:2] == [EMITTERS, EMITTERS]
    assert_close(state_to_numpy(ft.BatchRenderer(tprog, B, device="cpu").init_state()),
                 _np(JBatchRenderer(jprog, B).init_state()))


def test_batch_renderer_matches_jax():
    jprog, tprog = jax_scene(), port_scene()
    tbr, tparams = varied(tprog)
    jbr = JBatchRenderer(jprog, B)
    jparams = state_to_numpy(tparams)
    tstate, jstate = tbr.init_state(), jbr.init_state()
    for c in range(3):
        jo, jm, jstate = jbr.render_chunk(jparams, jstate, start_sample=c * K * F,
                                          num_blocks=K)
        to, tm, tstate = tbr.render_chunk(tparams, tstate, start_sample=c * K * F,
                                          num_blocks=K)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=TOL, rtol=0)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert float(to.abs().max()) > 0.01 and not torch.equal(to[0], to[1])
    assert_close(state_to_numpy(tstate), _np(jstate))


#: (package, node module, FirewheelCtx keywords, StreamConfig, buffers a pump)
STREAMS = {
    "jax": (fw, jn, {}, dict(buffer_frames=F, chunk_buffers=8), 8),
    "port": (ft, tn, {"device": "cpu"}, dict(buffer_frames=8 * F, block_frames=F), 1),
}
DISPATCHES, TURN_AT = 10, 5


def stream_scene(pkg):
    """The scene streamed for DISPATCHES dispatches of 1024 frames: the
    example's orbit (every emitter at 16, over 0.15 s), every emitter in a
    ``SpatialScene`` whose listener turns 30° before dispatch TURN_AT.
    The automation ticks once a dispatch, at the same stream time in both
    packages."""
    mod, nodes, kw, cfg, per_pump = STREAMS[pkg]
    cx = mod.FirewheelCtx(**kw)
    g = cx.graph_mut()
    meter, spats = mixer.add_spatial_scene(g, EMITTERS, GROUPS, nodes=nodes)
    assert mixer.orbit_scene(cx.automation, g, spats, secs=0.15) == EMITTERS
    scene = mod.SpatialScene()
    for spat, _, _ in spats:
        scene.add(spat, g.node(spat), g.node(spat).position())
    sink = mod.ArraySink()
    cx.activate(mod.StreamConfig(SR, 2, **cfg), sink=sink)
    for i in range(DISPATCHES):
        if i == TURN_AT:
            scene.set_listener(forward=(np.sin(np.pi / 6), 0.0, -np.cos(np.pi / 6)))
        cx.update(max_pump_buffers=0)
        cx.stream.pump(per_pump)
    cx.stream.flush()
    reading = nodes.DbMeterNode.read(cx.node_state(meter))
    proc = cx.stream._processor
    state = proc.state_dict()
    state = state_to_numpy(state) if pkg == "port" else _np(state)
    audio = sink.audio(2)
    cx.deactivate()
    return audio, state, reading


def test_stream_with_orbit_matches_jax():
    ja, jstate, jread = stream_scene("jax")
    ta, tstate, tread = stream_scene("port")
    assert ta.shape == ja.shape == (2, DISPATCHES * 8 * F)
    np.testing.assert_allclose(ta, ja, atol=TOL, rtol=0)
    assert_close(tstate, jstate)
    for key in ("peak_db", "rms_db"):
        np.testing.assert_allclose(tread[key], jread[key], atol=1e-3)
    assert np.abs(ta).max() > 0.01


def test_megakernel_plain_version_matches_eager_and_jax():
    jprog, tprog = jax_scene(), port_scene()
    _, tparams = varied(tprog)
    mega = em.MegaRenderer(tprog, B, KI, device="cpu")
    eager = ft.BatchRenderer(tprog, B, device="cpu")
    jmega = JMegaRenderer(jprog, batch=B, num_blocks=KI, tile=B, interpret=True)
    jparams = state_to_numpy(tparams)
    assert em.supports_megakernel(tprog)
    spatial = em.OPS[tn.spatial.Spatializer3DProcessor].code
    assert int((mega.lowered.ops[:, em.OP] == spatial).sum()) == EMITTERS
    ms = es = mega.init_state()
    js = jmega.init_state()
    for c in range(2):
        mo, mm, ms = mega.render_chunk(tparams, ms, c * KI * F)
        eo, emk, es = eager.render_chunk(tparams, es, start_sample=c * KI * F,
                                         num_blocks=KI)
        jo, jm, js = jmega.render_chunk(jparams, js, c * KI * F)
        np.testing.assert_allclose(mo.numpy(), eo.numpy(), atol=TOL, rtol=0)
        assert torch.equal(mm, emk)
        np.testing.assert_allclose(mo.numpy(), np.asarray(jo), atol=TOL, rtol=0)
        np.testing.assert_array_equal(mm.numpy(), np.asarray(jm))
    assert float(mo.abs().max()) > 0.01
    assert_close(state_to_numpy(ms), state_to_numpy(es))
    assert_close(state_to_numpy(ms), _np(js))


def test_megakernel_plain_version_while_emitters_move():
    """Every 4th spatializer gets new params a chunk: the gain and pan
    smoothers ramp inside the chunk; the plain version against eager."""
    tprog = port_scene()
    mega = em.MegaRenderer(tprog, B, K, device="cpu")
    eager = ft.BatchRenderer(tprog, B, device="cpu")
    params = mega.stack_params()
    ms = es = mega.init_state()
    ramped = False
    for c in range(3):
        mixer.vary_spatial_params(tprog, params, c, moving_every=4)
        mo, mm, ms = mega.render_chunk(params, ms, c * K * F)
        eo, emk, es = eager.render_chunk(params, es, start_sample=c * K * F,
                                         num_blocks=K)
        np.testing.assert_allclose(mo.numpy(), eo.numpy(), atol=TOL, rtol=0)
        assert torch.equal(mm, emk)
        assert_close(state_to_numpy(ms), state_to_numpy(es))
        ramped |= any(bool((v["gain"]["status"] == 1).any()) for k, v in ms.items()
                      if k.startswith("spatializer"))
    assert ramped


def test_hybrid_with_doppler_matches_jax():
    """Every 4th emitter doppler: 4 torch stages between 5 islands; the
    doppler spatializers run eagerly, the others in the islands' plain
    version."""
    jprog, tprog = jax_scene(4), port_scene(4)
    assert repr(tprog.schedule) == repr(jprog.schedule)
    assert not em.supports_megakernel(tprog)
    with pytest.raises(ValueError, match="not eligible"):
        em.MegaRenderer(tprog, B, KI, device="cpu")
    hy = HybridMegaRenderer(tprog, B, KI, device="cpu")
    assert [kind for kind, _ in hy.segments] == ["mega", "xla"] * 4 + ["mega"]
    jhy = JHybrid(jprog, batch=B, num_blocks=KI, tile=B, interpret=True)
    jbr = JBatchRenderer(jprog, B)
    tparams = hy.stack_params()
    jparams = state_to_numpy(tparams)
    hs, js, xs = hy.init_state(), jhy.init_state(), jbr.init_state()
    for c in range(2):
        ho, hm, hs = hy.render_chunk(tparams, hs, start_sample=c * KI * F)
        jo, jm, js = jhy.render_chunk(jparams, js, start_sample=c * KI * F)
        xo, xm, xs = jbr.render_chunk(jparams, xs, start_sample=c * KI * F, num_blocks=KI)
        for o, m in ((jo, jm), (xo, xm)):
            np.testing.assert_allclose(ho.numpy(), np.asarray(o), atol=TOL, rtol=0)
            np.testing.assert_array_equal(hm.numpy(), np.asarray(m))
    assert float(ho.abs().max()) > 0.01
    assert_close(state_to_numpy(hs), _np(js))
    assert_close(state_to_numpy(hs), _np(xs))


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    """JAX renders two chunks and saves its fleet; the port restores the
    file and renders the third chunk as JAX does."""
    jprog, tprog = jax_scene(4), port_scene(4)
    tbr, tparams = varied(tprog, seed=3)
    jbr = JBatchRenderer(jprog, B)
    jparams = state_to_numpy(tparams)
    js = jbr.init_state()
    for c in range(2):
        _, _, js = jbr.render_chunk(jparams, js, start_sample=c * K * F, num_blocks=K)
    ck = str(tmp_path / "ck")
    jbr.save_checkpoint(ck, js)
    ts, _ = tbr.restore_checkpoint(ck)
    assert_close(state_to_numpy(ts), _np(js))
    jo, jm, js = jbr.render_chunk(jparams, js, start_sample=2 * K * F, num_blocks=K)
    to, tm, ts = tbr.render_chunk(tparams, ts, start_sample=2 * K * F, num_blocks=K)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=TOL, rtol=0)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert float(to.abs().max()) > 0.01
    assert_close(state_to_numpy(ts), _np(js))


def test_binaural_scene_renders_like_jax():
    g = fw.AudioGraph(fw.AudioGraphConfig(0, 2))
    mixer.add_spatial_scene(g, EMITTERS, GROUPS, binaural=True, nodes=jn)
    pkg = g.compile(SR, F)
    jprog = fw.ScheduleProgram(pkg.schedule, dict(pkg.new_node_processors), SR)
    tprog = mixer.spatial_scene_graph(EMITTERS, GROUPS, binaural=True, device="cpu")
    assert not em.supports_megakernel(tprog)
    jbr, tbr = JBatchRenderer(jprog, B), ft.BatchRenderer(tprog, B, device="cpu")
    tparams = tbr.stack_params()
    jparams = state_to_numpy(tparams)
    js, ts = jbr.init_state(), tbr.init_state()
    for c in range(2):
        jo, jm, js = jbr.render_chunk(jparams, js, start_sample=c * K * F, num_blocks=K)
        to, tm, ts = tbr.render_chunk(tparams, ts, start_sample=c * K * F, num_blocks=K)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=TOL, rtol=0)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert float(to.abs().max()) > 0.01
    assert_close(state_to_numpy(ts), _np(js))


@pytest.mark.parametrize("frames", [128, 256])
def test_full_scene_shared_memory(frames):
    """The 128-emitter scene has 258 arena buffers: its arena fits one
    instance a CTA in blocks of 128 frames; at 256 it fits no CTA, so the
    kernel keeps the buffers in a device-memory workspace (``spills``) and
    only the rest on chip, and ``check_launchable`` accepts it.
    ``shared_bytes`` counts the layout the kernel takes."""
    g = ft.AudioGraph(ft.AudioGraphConfig(0, 2))
    mixer.add_spatial_scene(g)
    pkg = g.compile(SR, frames)
    prog = ft.ScheduleProgram(pkg.schedule, dict(pkg.new_node_processors), SR,
                              device="cpu")
    assert len(prog.schedule.schedule) == 266
    assert prog.schedule.num_buffers == 258
    lw = em.lower_schedule(prog)
    tables = (lw.ops.size + lw.io.size + lw.consts.size + lw.out_row.size
              + lw.in_bufs.size)
    rest = (em.ECHO_WORDS * lw.echo_channels + lw.num_buffers + lw.num_words
            + lw.scan_words)
    arena = lw.num_buffers * frames
    round4 = lambda n: -(-n // 4) * 4  # noqa: E731
    if frames == 128:
        assert not em.spills(lw)
        assert em.shared_bytes(lw, 1) == 4 * (round4(tables) + round4(arena + rest))
        assert em.shared_bytes(lw, 1) <= em.MAX_SHARED_BYTES < em.shared_bytes(lw, 2)
        em.check_launchable(lw, 1, "MegaRenderer")
        with pytest.raises(ValueError, match="shared memory"):
            em.check_launchable(lw, 2, "MegaRenderer")
    else:
        assert em.spills(lw)
        assert 4 * (round4(tables) + round4(arena + rest)) > em.MAX_SHARED_BYTES
        for tile in (1, 8):
            assert em.shared_bytes(lw, tile) == 4 * (round4(tables) + tile * round4(rest))
            em.check_launchable(lw, tile, "MegaRenderer")
        with pytest.raises(ValueError, match="shared memory"):
            em.check_launchable(lw, 9, "MegaRenderer")
