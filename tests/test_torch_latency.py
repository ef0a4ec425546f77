"""Latency compensation in the port (``graph/latency.py``, copied, and
``nodes/delay.py:DelayCompNode``), held against the JAX package.

Both packages build the same graphs from their own node classes; the
pass's arrivals and insertions must be equal (node ids by ``repr``), a
second pass must insert nothing, the compensated graph must render as
JAX's does (1e-6 abs), and ``DelayCompProcessor``'s kernel must equal
JAX's, output, line and mask, for D = 0, shorter and longer than a block.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import firewheel_tpu as fw
from firewheel_tpu import nodes as jn
from firewheel_tpu.nodes.delay import DelayCompNode as JaxDelayComp
import firewheel_tpu_torch as ft
from firewheel_tpu_torch import nodes as tn

SR, F = 48000, 128
TOL = 1e-6
PACKAGES = {"jax": (fw, jn, JaxDelayComp), "port": (ft, tn, tn.DelayCompNode)}


def diamond(pkg, manual=False):
    """beep → {delay 240, direct} → sum → out (a parallel bus whose direct
    side arrives early); ``manual``: the direct side through a hand-placed
    240-frame delay already."""
    mod, nodes, Delay = PACKAGES[pkg]
    g = mod.AudioGraph(mod.AudioGraphConfig(0, 2))
    beep = g.add_node(0, 2, nodes.BeepTestNode(440.0, -12.0, True))
    slow = g.add_node(2, 2, Delay(delay_secs=0.005))
    mix = g.add_node(4, 2, nodes.SumNode())
    direct = g.add_node(2, 2, Delay(delay_frames=240)) if manual else beep
    for ch in range(2):
        g.connect(beep, ch, slow, ch)
        g.connect(slow, ch, mix, ch)
        if manual:
            g.connect(beep, ch, direct, ch)
        g.connect(direct, ch, mix, 2 + ch)
        g.connect(mix, ch, g.graph_out_node(), ch)
    return g


def cascade(pkg):
    """Two stacked merges, 100 frames early at each."""
    mod, nodes, Delay = PACKAGES[pkg]
    g = mod.AudioGraph(mod.AudioGraphConfig(0, 1))
    src = g.add_node(0, 1, nodes.BeepTestNode(440.0, -12.0, True))
    d100 = g.add_node(1, 1, Delay(delay_frames=100))
    s1 = g.add_node(2, 1, nodes.SumNode())
    s2 = g.add_node(2, 1, nodes.SumNode())
    g.connect(src, 0, d100, 0)
    g.connect(d100, 0, s1, 0)
    g.connect(src, 0, s1, 1)
    g.connect(s1, 0, s2, 0)
    g.connect(src, 0, s2, 1)
    g.connect(s2, 0, g.graph_out_node(), 0)
    return g


def impulse_bus(pkg, d=200):
    """graph_in → {delay d, direct} → sum → out."""
    mod, nodes, Delay = PACKAGES[pkg]
    g = mod.AudioGraph(mod.AudioGraphConfig(1, 1))
    delay = g.add_node(1, 1, Delay(delay_frames=d))
    mix = g.add_node(2, 1, nodes.SumNode())
    g.connect(g.graph_in_node(), 0, delay, 0)
    g.connect(delay, 0, mix, 0)
    g.connect(g.graph_in_node(), 0, mix, 1)
    g.connect(mix, 0, g.graph_out_node(), 0)
    return g


GRAPHS = {"diamond": diamond, "manual": lambda pkg: diamond(pkg, manual=True),
          "cascade": cascade, "impulse": impulse_bus}


def report(g):
    arrivals = sorted((repr(k), v) for k, v in g.path_latencies(SR).items())
    rep = g.compensate_latency(SR)
    ins = [(repr(i.src_node), repr(i.dst_node), repr(i.delay_node), i.frames,
            i.channels) for i in rep.insertions]
    return arrivals, ins, rep.output_latency_frames, rep.total_inserted_frames


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_compensation_matches_jax_and_is_idempotent(graph):
    jg, pg = GRAPHS[graph]("jax"), GRAPHS[graph]("port")
    assert report(pg) == report(jg)
    again = report(pg)
    assert again[1] == [] and again == report(jg)
    want = {"diamond": 1, "manual": 0, "cascade": 2, "impulse": 1}[graph]
    assert len(report(GRAPHS[graph]("port"))[1]) == want
    assert pg.output_latency_frames(SR) == jg.output_latency_frames(SR)


def test_negative_latency_rejected():
    class Bad(tn.BeepTestNode):
        def latency_frames(self, sample_rate):
            return -1

    g = ft.AudioGraph(ft.AudioGraphConfig(0, 2))
    bad = g.add_node(0, 2, Bad(440.0, -12.0))
    g.connect(bad, 0, g.graph_out_node(), 0)
    with pytest.raises(ValueError, match="latency_frames"):
        g.path_latencies(SR)


def render(pkg, g, blocks=4, impulse=True):
    """Compile ``g`` and render ``blocks`` blocks in one chunk, with a unit
    impulse at the graph input's first sample where it has one."""
    mod = PACKAGES[pkg][0]
    pk = g.compile(SR, F)
    kw = {} if pkg == "jax" else {"device": "cpu"}
    prog = mod.ScheduleProgram(pk.schedule, dict(pk.new_node_processors), SR, **kw)
    ni = prog.num_graph_inputs
    gi = np.zeros((blocks, ni, F), np.float32)
    if ni and impulse:
        gi[0, 0, 0] = 1.0
    im = np.zeros((blocks, ni), bool)
    if pkg == "jax":
        out, _, _ = prog.render_chunk(prog.collect_params(), prog.init_state(),
                                      jnp.asarray(gi), jnp.asarray(im), 0)
        return np.asarray(out)
    out, _, _ = prog.render_chunk(prog.collect_params(), prog.init_state(),
                                  torch.from_numpy(gi), torch.from_numpy(im), 0)
    return out.numpy()


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_compensated_graph_renders_as_jax(graph):
    outs = {}
    for pkg in PACKAGES:
        g = GRAPHS[graph](pkg)
        g.compensate_latency(SR)
        outs[pkg] = render(pkg, g)
    np.testing.assert_allclose(outs["port"], outs["jax"], atol=TOL, rtol=0)
    assert np.abs(outs["port"]).max() > 0.1
    if graph == "impulse":
        # one pulse of 2 at the delayed position, as the JAX package's test
        y = outs["port"].transpose(1, 0, 2).reshape(-1)
        assert np.flatnonzero(np.abs(y) > 1e-6).tolist() == [200]
        assert y[200] == pytest.approx(2.0)


@pytest.mark.parametrize("delay", [0, 37, F, 300])
@pytest.mark.parametrize("frames", [F, 100])
def test_delay_comp_kernel_matches_jax(delay, frames):
    """Four blocks of random input with random silence flags (the line
    drains after its input goes silent), D = 0, shorter than a block, one
    block and longer; blocks of 128 and of 100 frames."""
    rng = np.random.default_rng(delay + frames)
    jp = JaxDelayComp(delay_frames=delay).activate(SR, F, 2, 2)
    tp = tn.DelayCompNode(delay_frames=delay).activate(SR, F, 2, 2)
    js, ts = jp.init_state(), tp.init_state()
    for b in range(4):
        x = rng.standard_normal((2, frames)).astype(np.float32)
        mask = np.array([b >= 2, bool(rng.integers(2))])
        x[mask] = 0.0
        jy, js, jm = jp.kernel({}, js, jnp.asarray(x), jnp.asarray(mask), None)
        ty, ts, tm = tp.kernel({}, ts, torch.from_numpy(x), torch.from_numpy(mask),
                               None)
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
        np.testing.assert_array_equal(ts["buf"].numpy(), np.asarray(js["buf"]))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert tp.group_key() == jp.group_key() and ts["buf"].shape == (2, delay)


def test_delay_comp_renders_as_torch_stage_on_hybrid():
    """The delay has a device function in K2/K3 (its line in device memory,
    as the echo's): the hybrid renders the compensated diamond as one
    island and the megakernel renders it whole, each equal to the eager
    path bit for bit (their plain versions here; ``chip_smoke.py`` 12(d)
    holds the kernels on the card)."""
    from firewheel_tpu_torch.executor_mega import MegaRenderer

    g = diamond("port")
    g.compensate_latency(SR)
    pk = g.compile(SR, F)
    prog = ft.ScheduleProgram(pk.schedule, dict(pk.new_node_processors), SR,
                              device="cpu")
    outs = []
    for lowering in ("xla", "hybrid"):
        br = ft.BatchRenderer(prog, 2, device="cpu", lowering=lowering)
        outs.append(br.render_chunk(br.stack_params(), br.init_state(),
                                    num_blocks=4)[0])
        if lowering == "hybrid":
            hy = br._chunk_cache[("hybrid", 4)]
            assert [kind for kind, _ in hy.segments] == ["mega"]
    mega = MegaRenderer(prog, 2, 4, device="cpu")
    outs.append(mega.render_chunk(mega.stack_params(), mega.init_state(), 0)[0])
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
    assert float(outs[0].abs().max()) > 0.1


def test_ctx_output_latency_frames():
    """Inactive it needs the rate; active it reads the stream's; a graph
    edited by compensate_latency reports the compensated latency."""
    cx = ft.FirewheelCtx(device="cpu")
    with pytest.raises(RuntimeError, match="not activated"):
        cx.output_latency_frames()
    g = cx.graph_mut()
    beep = g.add_node(0, 2, tn.BeepTestNode(440.0, -12.0, True))
    slow = g.add_node(2, 2, tn.DelayCompNode(delay_secs=0.005))
    mix = g.add_node(4, 2, tn.SumNode())
    for ch in range(2):
        g.connect(beep, ch, slow, ch)
        g.connect(slow, ch, mix, ch)
        g.connect(beep, ch, mix, 2 + ch)
        g.connect(mix, ch, g.graph_out_node(), ch)
    assert cx.output_latency_frames(sample_rate=SR) == 240
    assert cx.output_latency_frames(sample_rate=96000) == 480
    assert len(g.compensate_latency(SR).insertions) == 1
    sink = ft.ArraySink()
    cx.activate(ft.StreamConfig(sample_rate=SR, buffer_frames=256, block_frames=F),
                sink=sink)
    try:
        assert cx.output_latency_frames(sample_rate=96000) == 240
        cx.render_offline(0.02)
        audio = sink.audio(2)
    finally:
        cx.deactivate()
    # both sides aligned: twice the beep, 240 frames late
    assert np.abs(audio[:, :240]).max() == 0.0
    assert np.abs(audio).max() == pytest.approx(2 * 0.2512, abs=2e-3)
