"""BASELINE config 3 (``mixer.voice_mixer_64_graph``, the graph of
``examples/voice_mixer_64.py``: poolable resampling samplers → group sums
→ a mixer sum → volume → pan → clip) held against the JAX package's own
graph on the CPU, both built by ``mixer.add_voice_mixer_64`` from their own
nodes.

Batched (8 voices, 2 groups, B=4, K=4, three chunks carrying state, every
instance its own rates, playheads, bus volume and pan, one instance's
params replaced mid-way by ``update_instance``) through both packages'
``BatchRenderer``: outputs within 1e-6 (the repo's numerics contract),
masks and every integer state leaf (the playheads as int64 ↔ uint32)
equal.  The port's hybrid lowering (one torch stage of the 64 pooled
samplers, one island of the sums and the bus, K3's plain version on the
CPU) bit for bit its eager path at the full 64 voices.  Streamed as the
example streams it (1024-frame buffers, 8 a dispatch) against JAX's
``FirewheelCtx``: within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import firewheel_tpu as fw
from firewheel_tpu import nodes as jn
from firewheel_tpu.parallel import BatchRenderer as JaxBatchRenderer
import firewheel_tpu_torch as ft
from firewheel_tpu_torch import mixer
from firewheel_tpu_torch.convert import state_from_jax, state_to_numpy
from firewheel_tpu_torch.examples import voice_mixer_64
from firewheel_tpu_torch.executor_hybrid import partition_schedule

SR, F = 48000, 128
TOL = 1e-6


def _normalize(tree):
    return state_to_numpy(state_from_jax(jax.tree.map(np.asarray, tree), "cpu"))


def _program(pkg, num_voices, groups):
    mod = fw if pkg == "jax" else ft
    g = mod.AudioGraph(mod.AudioGraphConfig(0, 2))
    ids = mixer.add_voice_mixer_64(g, num_voices, groups,
                                   nodes=jn if pkg == "jax" else None)
    pk = g.compile(SR, F)
    if pkg == "jax":
        return fw.ScheduleProgram(pk.schedule, dict(pk.new_node_processors), SR), g, ids
    return ft.ScheduleProgram(pk.schedule, dict(pk.new_node_processors), SR,
                              device="cpu"), g, ids


def _to_jax_params(template, tree):
    """The port's stacked params (numpy) in the JAX tree's dtypes."""
    if isinstance(template, dict):
        return {k: _to_jax_params(v, tree.get(k, v)) for k, v in template.items()}
    if isinstance(tree, np.ndarray):
        return tree.astype(np.asarray(template).dtype)
    return template


def _assert_states(got, want):
    assert got.keys() == want.keys()
    for key in want:
        flat_g = jax.tree_util.tree_leaves_with_path(got[key])
        flat_w = dict(jax.tree_util.tree_leaves_with_path(want[key]))
        assert len(flat_g) == len(flat_w), key
        for path, a in flat_g:
            b = flat_w[path]
            assert a.dtype == b.dtype and a.shape == b.shape, (key, path)
            if a.dtype.kind == "f":
                np.testing.assert_allclose(a, b, atol=TOL, rtol=0, err_msg=f"{key}{path}")
            else:
                np.testing.assert_array_equal(a, b, err_msg=f"{key}{path}")


def test_batched_equals_jax_over_three_chunks():
    b, k = 4, 4
    tprog, tg, tids = _program("port", 8, 2)
    jprog, jg, jids = _program("jax", 8, 2)
    tbr = ft.BatchRenderer(tprog, b, device="cpu")
    jbr = JaxBatchRenderer(jprog, b)
    tp = mixer.vary_voice_mixer_params(tprog, tbr.stack_params(), seed=3)
    jp = jax.tree.map(jnp.asarray, _to_jax_params(
        jax.tree.map(np.asarray, jbr.stack_params()), state_to_numpy(tp)))
    ts, js = tbr.init_state(), jbr.init_state()
    for c in range(3):
        if c == 2:
            # a client retunes voice 3 of instance 2: one instance's slice
            for g, ids in ((tg, tids), (jg, jids)):
                g.node(ids["voices"][3]).set_playback_rate(1.5)
            tp = tbr.update_instance(tp, 2, tprog.collect_params())
            jp = jbr.update_instance(jp, 2, jprog.collect_params())
        start = c * k * F
        to, tm, ts = tbr.render_chunk(tp, ts, start_sample=start, num_blocks=k)
        jo, jm, js = jbr.render_chunk(jp, js, start_sample=start, num_blocks=k)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=TOL, rtol=0,
                                   err_msg=f"chunk {c}")
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        _assert_states(state_to_numpy(ts), _normalize(js))
    assert 0.01 < np.abs(to.numpy()).max() <= 1.0
    # the instances differ (their own rates, playheads, volume and pan)
    assert np.abs(to.numpy()[0] - to.numpy()[1]).max() > 1e-3


def test_partition_is_one_torch_stage_and_one_island():
    """The 64 pooled samplers are one torch stage (the sampler has no
    megakernel row) and the two-level sum, volume, pan and clip one
    8-node K3 island; the eager executor pools the samplers as one group."""
    prog = mixer.voice_mixer_64_graph(device="cpu")
    assert [(kind, len(n)) for kind, n in partition_schedule(prog)] == [
        ("xla", 64), ("mega", 8)]
    assert [len(m) for _, m in prog._plan][0] == 64


def test_hybrid_bit_for_bit_eager_at_64_voices():
    """B=2, K=2, two chunks carrying state, per-instance params: the
    hybrid (torch stage, then ``island_chunk_reference``) equals eager
    exactly, outputs, masks and state."""
    b, k = 2, 2
    prog = mixer.voice_mixer_64_graph(device="cpu")
    eager = ft.BatchRenderer(prog, b, device="cpu")
    hybrid = ft.BatchRenderer(prog, b, device="cpu", lowering="hybrid")
    params = mixer.vary_voice_mixer_params(prog, eager.stack_params(), seed=5)
    es = hs = eager.init_state()
    for c in range(2):
        eo, em_, es = eager.render_chunk(params, es, start_sample=c * k * F, num_blocks=k)
        ho, hm, hs = hybrid.render_chunk(params, hs, start_sample=c * k * F, num_blocks=k)
        np.testing.assert_array_equal(ho.numpy(), eo.numpy())
        np.testing.assert_array_equal(hm.numpy(), em_.numpy())
        _assert_states(state_to_numpy(hs), state_to_numpy(es))
    assert np.abs(eo.numpy()).max() > 0.01


def test_example_stream_equals_jax_firewheel_ctx(tmp_path):
    """The port's example (``examples.voice_mixer_64.main``: 64 voices,
    1024-frame blocks, 8 buffers a dispatch, to a WAV) for 0.1 s against
    JAX's ``FirewheelCtx`` stream of the same graph, one buffer a dispatch
    (one compile; a dispatch's blocks render as one each)."""
    stats = voice_mixer_64.main(str(tmp_path / "vm64.wav"), device="cpu", secs=0.1)
    port = ft.load_audio(str(tmp_path / "vm64.wav"), device=False)[0].host_data
    cx = fw.FirewheelCtx()
    mixer.add_voice_mixer_64(cx.graph_mut(), nodes=jn)
    sink = fw.ArraySink()
    cx.activate(fw.StreamConfig(SR, 2, buffer_frames=1024, chunk_buffers=1), sink=sink)
    cx.render_offline(0.1)
    cx.deactivate()
    want = sink.audio(2)
    assert port.shape == want.shape and port.shape[1] >= int(0.1 * SR)
    assert stats["frames_rendered"] == port.shape[1]
    np.testing.assert_allclose(port, want, atol=TOL, rtol=0)
    assert np.isfinite(port).all() and np.abs(port).max() > 0.01


@pytest.mark.parametrize("graph", ["voice_mixer_64", "effects_chain", "mastering_bus"])
def test_hybrid_staging_is_bit_for_bit_the_stacked_staging(graph, monkeypatch):
    """A torch stage writes its live-outs into one f32[B, K, n, F], which
    an island that reads them all in order takes as its operand without a
    copy (``executor_hybrid._packed``); the same chunks with every island's
    live-ins stacked from the buffers instead, as before, are equal bit
    for bit.  Config 3's island takes the samplers' stage whole, the
    effects chain's the sampler's, the mastering bus's two islands the
    noise's and the FIR's."""
    from firewheel_tpu_torch import executor_hybrid

    b, k = 2, 2
    prog = {"voice_mixer_64": lambda: mixer.voice_mixer_64_graph(16, 4, device="cpu"),
            "effects_chain": lambda: mixer.effects_chain_graph(device="cpu"),
            "mastering_bus": lambda: mixer.mastering_bus_graph(device="cpu")}[graph]()
    taken = []
    packed = executor_hybrid._packed

    def spy(views):
        got = packed(views)
        taken.append(got is not None)
        return got

    runs = []
    for take in (spy, lambda views: None):
        monkeypatch.setattr(executor_hybrid, "_packed", take)
        hybrid = ft.BatchRenderer(prog, b, device="cpu", lowering="hybrid")
        params = hybrid.stack_params()
        if graph == "voice_mixer_64":
            mixer.vary_voice_mixer_params(prog, params, seed=7)
        elif graph == "effects_chain":
            mixer.vary_effects_params(params)
        else:
            mixer.vary_mastering_params(prog, params, seed=7)
        st = hybrid.init_state()
        outs = []
        for c in range(2):
            o, m, st = hybrid.render_chunk(params, st, start_sample=c * k * F, num_blocks=k)
            outs.append((o.numpy(), m.numpy()))
        runs.append((outs, state_to_numpy(st)))
    for (o1, m1), (o2, m2) in zip(runs[0][0], runs[1][0]):
        np.testing.assert_array_equal(o1, o2)
        np.testing.assert_array_equal(m1, m2)
    _assert_states(runs[0][1], runs[1][1])
    # every island here reads one stage's live-outs whole
    assert taken and all(taken)
