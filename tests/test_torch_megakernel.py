"""The megakernel lowering (``firewheel_tpu_torch.executor_mega``) on the CPU.

On the CPU ``MegaRenderer`` runs ``mega_chunk_reference``: the kernel's
plain version, which walks the op table and the leaf list that
``lower_schedule`` builds and calls the port's node kernels row by row.

* Against the port's eager ``BatchRenderer``: bit for bit
  (``torch.equal``).  Both call the same node kernels in the same order;
  the eager path stacks pooled groups, and torch's CPU kernels round a
  stacked tensor as they round its members.
* Against the JAX ``BatchRenderer`` (``FilterNode(backend="pallas")``, K1
  in interpret mode): 1e-5 on audio and state, masks equal.  torch's and
  XLA's f32 sin/cos/exp differ by an ulp; the sum, filter and echo feedback
  carry that to a few ulp of the output.
* Against the JAX megakernel in interpret mode: the same, except
  ``clip_count``, which JAX's megakernel freezes (a Mosaic workaround) and
  the port counts as the XLA path does.
"""

import types

import jax
import numpy as np
import pytest
import torch

import firewheel_tpu_torch as ft
import test_megakernel as jax_mega_tests
import test_torch_mixer
from firewheel_tpu.executor_pallas import MegaRenderer as JMegaRenderer
from firewheel_tpu.parallel import BatchRenderer as JBatchRenderer
from firewheel_tpu_torch import nodes as tn
from firewheel_tpu_torch.convert import state_from_jax, state_to_numpy
from firewheel_tpu_torch.core.node import NodeProcessor
from firewheel_tpu_torch.executor_mega import (
    OPS, MegaRenderer, lower_schedule, supports_megakernel,
)
from firewheel_tpu_torch.mixer import random_graph, vary_params

B = 2
K = 4
F = 128
TOL = 1e-5


def _assert_equal_trees(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _assert_equal_trees(a[k], b[k])
        else:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def _mega_vs_eager(prog, batch, seed, chunks=3):
    """Render ``chunks`` chunks with both lowerings from the same varied
    params; assert bit equality of outputs, masks and state."""
    mega = MegaRenderer(prog, batch, K)
    eager = ft.BatchRenderer(prog, batch)
    params = vary_params(mega.stack_params(), seed)
    ms, es = mega.init_state(), eager.init_state()
    for c in range(chunks):
        mo, mm, ms = mega.render_chunk(params, ms, start_sample=c * K * F)
        eo, em, es = eager.render_chunk(params, es, start_sample=c * K * F,
                                        num_blocks=K)
        assert mo.shape == (batch, K, prog.num_graph_outputs, F)
        assert mm.shape == (batch, K, prog.num_graph_outputs)
        assert torch.equal(mo, eo), float((mo - eo).abs().max())
        assert torch.equal(mm, em)
    _assert_equal_trees(ms, es)
    return mo, mm


def test_plain_version_matches_eager_on_the_mixer():
    out, masks = _mega_vs_eager(ft.mixer_graph(num_voices=3), B, seed=7)
    assert float(out.abs().max()) > 0.01


@pytest.mark.parametrize("seed", range(5))
def test_plain_version_matches_eager_on_random_graphs(seed):
    prog = random_graph(seed)
    sched = prog.schedule.schedule
    ins = [ib for sn in sched for ib in sn.input_buffers]
    # an unconnected input, fan-out, pan 1→2 and sum 4→2, reused buffers
    assert any(ib.should_clear for ib in ins)
    readers: dict = {}
    for ib in ins:
        if not ib.should_clear:
            key = (ib.buffer_index, ib.generation)
            readers[key] = readers.get(key, 0) + 1
    assert max(readers.values()) > 1
    shapes = {(len(sn.input_buffers), len(sn.output_buffers)) for sn in sched}
    assert {(1, 2), (4, 2)} <= shapes
    n_buffers = sum(len(sn.output_buffers) for sn in sched) + sum(
        ib.should_clear for ib in ins)
    assert prog.schedule.num_buffers < n_buffers
    # an echo shorter than a chunk: the kernel keeps its early echoes aside
    lowered = lower_schedule(prog)
    assert any(r[0] == OPS[tn.delay.EchoProcessor].code and r[7] < K * F
               for r in lowered.ops)
    _mega_vs_eager(prog, 3, seed)


def _jax_params3(jprog):
    """Two instances of the 3-voice mixer: the defaults, and one with another
    cutoff, a quieter voice, a muted voice and a disabled beep."""
    p0 = jprog.collect_params()
    p1 = jax.tree.map(np.copy, p0)
    by_kind: dict = {}
    for k in p1:
        by_kind.setdefault(k.split("-")[0], []).append(k)
    p1[by_kind["filter"][0]]["freq"] = np.float32(3000.0)
    p1[by_kind["volume"][0]]["raw_gain"] = np.float32(0.09)
    p1[by_kind["volume"][1]]["raw_gain"] = np.float32(0.0)
    p1[by_kind["beep_test"][2]]["enabled"] = np.asarray(False)
    return [p0, p1]


def _np(tree):
    return state_to_numpy(state_from_jax(jax.tree.map(np.asarray, tree), "cpu"))


def _assert_close_np(a, b, tol=TOL, skip=()):
    assert a.keys() == b.keys()
    for k in a:
        if k in skip:
            continue
        if isinstance(a[k], dict):
            _assert_close_np(a[k], b[k], tol, skip)
        else:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_allclose(a[k], b[k], atol=tol, rtol=0, err_msg=k)


def test_plain_version_matches_jax_batch_renderer():
    jprog = test_torch_mixer.jax_mixer(num_voices=3)
    tprog = ft.mixer_graph(num_voices=3)
    plist = _jax_params3(jprog)
    jbr = JBatchRenderer(jprog, B)
    mega = MegaRenderer(tprog, B, K)
    jparams, tparams = jbr.stack_params(plist), mega.stack_params(plist)
    jstate, tstate = jbr.init_state(), mega.init_state()
    for c in range(3):
        jo, jm, jstate = jbr.render_chunk(jparams, jstate, start_sample=c * K * F,
                                          num_blocks=K)
        to, tm, tstate = mega.render_chunk(tparams, tstate, start_sample=c * K * F)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=TOL, rtol=0)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert float(to.abs().max()) > 0.01 and not torch.equal(to[0], to[1])
    _assert_close_np(state_to_numpy(tstate), _np(jstate))


def _port_mixer_program():
    """``tests/test_megakernel.py:mixer_program`` built from the port's
    classes: the same graph, node keys and params."""
    fn = jax_mega_tests.mixer_program
    env = dict(fn.__globals__)
    env.update(AudioGraph=ft.AudioGraph, AudioGraphConfig=ft.AudioGraphConfig,
               ScheduleProgram=ft.ScheduleProgram, BeepTestNode=tn.BeepTestNode,
               VolumeNode=tn.VolumeNode, SumNode=tn.SumNode,
               StereoPanNode=tn.StereoPanNode, HardClipNode=tn.HardClipNode)
    return types.FunctionType(fn.__code__, env)()


def test_plain_version_matches_jax_megakernel():
    jprog = jax_mega_tests.mixer_program()
    tprog = _port_mixer_program()
    assert repr(tprog.schedule) == repr(jprog.schedule)
    b, k = 8, 2
    p = jprog.collect_params()
    clip = next(key for key in p if key.startswith("hard_clip"))
    p[clip]["threshold"] = np.float32(0.05)  # so that samples clip
    jmega = JMegaRenderer(jprog, batch=b, num_blocks=k, tile=8, interpret=True)
    jbr = JBatchRenderer(jprog, b)
    mega = MegaRenderer(tprog, b, k)
    jo, jm, jst = jmega.render_chunk(jmega.stack_params([p] * b),
                                     jmega.init_state(), 0)
    _, _, xst = jbr.render_chunk(jbr.stack_params([p] * b), jbr.init_state(),
                                 num_blocks=k)
    to, tm, tst = mega.render_chunk(mega.stack_params([p] * b),
                                    mega.init_state(), 0)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=TOL, rtol=0)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    mine, frozen, counted = _np(tst), _np(jst), _np(xst)
    _assert_close_np(mine, frozen, skip=("clip_count",))
    # JAX's megakernel freezes the clip counter; the port counts like XLA
    assert int(frozen[clip]["clip_count"].max()) == 0
    assert int(mine[clip]["clip_count"].min()) > 0
    np.testing.assert_array_equal(mine[clip]["clip_count"],
                                  counted[clip]["clip_count"])


class _Opaque(tn.volume.VolumeProcessor):
    """A processor class with no device function."""


def test_eligibility():
    mixer = ft.mixer_graph()
    assert supports_megakernel(mixer)

    g = ft.AudioGraph(ft.AudioGraphConfig(2, 2))
    v = g.add_node(2, 2, tn.VolumeNode(80.0))
    for c in range(2):
        g.connect(g.graph_in_node(), c, v, c)
        g.connect(v, c, g.graph_out_node(), c)
    pkg = g.compile(48000, F)
    streamed = ft.ScheduleProgram(pkg.schedule, dict(pkg.new_node_processors), 48000)
    assert streamed.num_graph_inputs == 2
    assert not supports_megakernel(streamed)
    with pytest.raises(ValueError, match="not eligible"):
        MegaRenderer(streamed, B, K)
    with pytest.raises(ValueError, match="not eligible"):
        lower_schedule(streamed)

    prog = ft.mixer_graph(num_voices=1)
    proc = next(p for p in prog._procs.values() if type(p) in OPS and type(p) is not
                tn.dummy.DummyProcessor)
    proc.supports_megakernel = False  # an instance that opts out
    assert not supports_megakernel(prog)

    prog = ft.mixer_graph(num_voices=1)
    proc = next(p for p in prog._procs.values()
                if isinstance(p, tn.volume.VolumeProcessor))
    proc.__class__ = _Opaque  # a subclass is not its parent's device function
    assert isinstance(proc, NodeProcessor) and not supports_megakernel(prog)

    with pytest.raises(ValueError, match="tile"):
        MegaRenderer(mixer, 3, K, tile=2)


def test_state_hands_over_mid_stream():
    """Eager → mega → eager equals three eager chunks, bit for bit."""
    prog = ft.mixer_graph(num_voices=3)
    eager = ft.BatchRenderer(prog, B)
    mega = MegaRenderer(prog, B, K)
    params = vary_params(eager.stack_params(), 3)
    ref_state = eager.init_state()
    ref = []
    for c in range(3):
        o, m, ref_state = eager.render_chunk(params, ref_state,
                                             start_sample=c * K * F, num_blocks=K)
        ref.append((o, m))
    st = eager.init_state()
    o0, m0, st = eager.render_chunk(params, st, start_sample=0, num_blocks=K)
    o1, m1, st = mega.render_chunk(params, st, start_sample=K * F)
    o2, m2, st = eager.render_chunk(params, st, start_sample=2 * K * F, num_blocks=K)
    for (o, m), (ro, rm) in zip([(o0, m0), (o1, m1), (o2, m2)], ref):
        assert torch.equal(o, ro) and torch.equal(m, rm)
    _assert_equal_trees(st, ref_state)


def test_lowering_reproduces_the_schedule():
    prog = ft.mixer_graph()
    lw = lower_schedule(prog)
    sched = prog.schedule.schedule
    assert lw.ops.shape == (62, 9) and lw.num_buffers == 40 == prog.schedule.num_buffers
    assert sum(leaf.tree == "state" for leaf in lw.leaves) == 139
    assert sum(leaf.tree == "params" for leaf in lw.leaves) == 102
    assert list(lw.keys) == [ft.node_key(sn.id) for sn in sched[1:-1]]
    for row, sn in zip(lw.ops, sched[1:-1]):
        n_in, n_out, at = int(row[1]), int(row[2]), int(row[3])
        assert lw.io[at: at + n_in].tolist() == [ib.buffer_index for ib in sn.input_buffers]
        assert lw.io[at + n_in: at + 2 * n_in].tolist() == [
            int(ib.should_clear) for ib in sn.input_buffers]
        assert lw.io[at + 2 * n_in: at + 2 * n_in + n_out].tolist() == [
            ob.buffer_index for ob in sn.output_buffers]
        # the row's slots are its node's leaves
        mine = lw.slots[row[4]: row[4] + row[5]]
        assert {lw.leaves[i].key for i in mine} <= {ft.node_key(sn.id)}
    assert lw.out_row.tolist() == [[ib.buffer_index, int(ib.should_clear)]
                                   for ib in sched[-1].input_buffers]
    # a random graph's unconnected input lowers with its clear flag set
    rg = lower_schedule(random_graph(0))
    clears = [rg.io[int(r[3]) + int(r[1]): int(r[3]) + 2 * int(r[1])] for r in rg.ops]
    assert any(c.any() for c in clears)


def test_graph_outputs_read_cleared_and_flagged_channels_as_zero():
    """A graph output left unconnected reads as silent zeros."""
    g = ft.AudioGraph(ft.AudioGraphConfig(0, 2))
    b = g.add_node(0, 1, tn.BeepTestNode(440.0, -6.0, True))
    g.connect(b, 0, g.graph_out_node(), 0)
    pkg = g.compile(48000, F)
    prog = ft.ScheduleProgram(pkg.schedule, dict(pkg.new_node_processors), 48000)
    mega = MegaRenderer(prog, B, K)
    out, masks, _ = mega.render_chunk(mega.stack_params(), mega.init_state(), 0)
    assert float(out[:, :, 0].abs().max()) > 0.1 and not bool(masks[:, :, 0].any())
    assert not bool(out[:, :, 1].any()) and bool(masks[:, :, 1].all())
