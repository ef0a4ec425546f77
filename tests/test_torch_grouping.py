"""``ScheduleProgram``'s last options in the port, on the CPU beside the JAX
package (the counterpart of ``tests/test_grouping.py``):

* ``group_nodes=False`` walks every node alone: its plan has only singles,
  and over 3 blocks of the 16-emitter scene it renders what the pooled plan
  renders (1e-6, masks equal), both held against JAX's ``group_nodes=False``
  program at 1e-6;
* ``strip_masks=True`` leaves the audio bit for bit and every output mask
  the not-silent constant, as JAX's does; ``MegaRenderer`` and the hybrid
  refuse such a program;
* ``render_fn`` is the pure one-block function ``render_block`` calls, and
  it composes with autograd.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import firewheel_tpu as fw
import firewheel_tpu_torch as ft
from firewheel_tpu.core.node import BlockInfo as JBlockInfo
from firewheel_tpu_torch.convert import params_from_jax, tree_map
from firewheel_tpu_torch.core.node import BlockInfo as TBlockInfo
from firewheel_tpu_torch.executor_hybrid import HybridMegaRenderer
from firewheel_tpu_torch.executor_mega import MegaRenderer

SR, F, BLOCKS = 48000, 128, 3
TOL = 1e-6


def build_scene(mod, n_emit=16):
    """``test_grouping.build_scene`` in either package (``mod``): 16 beeps
    through 3D spatializers into 4 group sums and a master sum."""
    g = mod.AudioGraph(mod.AudioGraphConfig(0, 2))
    n, per = mod.nodes, n_emit // 4
    sums = [g.add_node(2 * per, 2, n.SumNode()) for _ in range(4)]
    master = g.add_node(8, 2, n.SumNode())
    for i, s in enumerate(sums):
        g.connect(s, 0, master, 2 * i)
        g.connect(s, 1, master, 2 * i + 1)
    for i in range(n_emit):
        a = 2 * math.pi * i / n_emit
        e = g.add_node(0, 1, n.BeepTestNode(110 * 2 ** ((i % 24) / 12), -30, True))
        sp = g.add_node(1, 2, n.Spatializer3DNode(position=(3 * math.sin(a), 0,
                                                            -3 * math.cos(a))))
        g.connect(e, 0, sp, 0)
        slot = i % per
        g.connect(sp, 0, sums[i // per], 2 * slot)
        g.connect(sp, 1, sums[i // per], 2 * slot + 1)
    g.connect(master, 0, g.graph_out_node(), 0)
    g.connect(master, 1, g.graph_out_node(), 1)
    pkg = g.compile(SR, F)
    return pkg, dict(pkg.new_node_processors)


def port_program(**kw):
    pkg, procs = build_scene(ft)
    return ft.ScheduleProgram(pkg.schedule, procs, SR, device="cpu", **kw)


def render_port(prog, blocks=BLOCKS):
    state, params = prog.init_state(), prog.collect_params()
    outs = []
    for b in range(blocks):
        out, mask, state = prog.render_block(params, state, torch.zeros((0, F)),
                                             torch.zeros((0,), dtype=torch.bool),
                                             TBlockInfo.make(stream_sample=b * F))
        outs.append((out, mask))
    return outs


def test_ungrouped_plan_has_only_singles():
    grouped, ungrouped = port_program(), port_program(group_nodes=False)
    assert max(len(m) for k, m in grouped._plan if k == "group") >= 16
    assert all(k == "single" and len(m) == 1 for k, m in ungrouped._plan)
    assert len(ungrouped._plan) == len(ungrouped.schedule.schedule) - 2


def test_grouped_equals_ungrouped_and_jax():
    pkg, procs = build_scene(fw)
    jprog = fw.ScheduleProgram(pkg.schedule, procs, SR, group_nodes=False)
    js, jp = jprog.init_state(), jprog.collect_params()
    want = []
    for b in range(BLOCKS):
        out, mask, js = jprog.render_block(jp, js, jnp.zeros((0, F), jnp.float32),
                                           jnp.zeros((0,), bool),
                                           JBlockInfo.make(stream_sample=b * F))
        want.append((np.asarray(out), np.asarray(mask)))
    grouped = render_port(port_program())
    ungrouped = render_port(port_program(group_nodes=False))
    for (go, gm), (uo, um), (jo, jm) in zip(grouped, ungrouped, want):
        assert float(uo.abs().max()) > 1e-3
        np.testing.assert_allclose(go.numpy(), uo.numpy(), atol=TOL, rtol=0)
        np.testing.assert_array_equal(gm.numpy(), um.numpy())
        for o, m in ((go, gm), (uo, um)):
            np.testing.assert_allclose(o.numpy(), jo, atol=TOL, rtol=0)
            np.testing.assert_array_equal(m.numpy(), jm)


def test_strip_masks_keeps_the_audio_bit_for_bit():
    """The mixer with its second voice's beep off (a silent branch) and a
    graph input left unconnected: the audio of the ablation is the plain
    program's, and its masks all read not silent, as JAX's do."""
    def build(mod, **kw):
        g = mod.AudioGraph(mod.AudioGraphConfig(2, 2))
        _, voices = ft.mixer.add_mixer(g, 2, "auto", nodes=mod.nodes)
        g.node(voices[1][0]).set_enabled(False)
        pkg = g.compile(SR, F)
        extra = {"device": "cpu"} if mod is ft else {}
        return mod.ScheduleProgram(pkg.schedule, dict(pkg.new_node_processors), SR,
                                   **kw, **extra)

    plain, stripped = build(ft), build(ft, strip_masks=True)
    jprog = build(fw, strip_masks=True)
    gi, im = torch.zeros((2, F)), torch.tensor([True, False])
    ps, ss, js = plain.init_state(), stripped.init_state(), jprog.init_state()
    for b in range(BLOCKS):
        info = TBlockInfo.make(stream_sample=b * F)
        po, pm, ps = plain.render_block(plain.collect_params(), ps, gi, im, info)
        so, sm, ss = stripped.render_block(stripped.collect_params(), ss, gi, im, info)
        jo, jm, js = jprog.render_block(jprog.collect_params(), js, jnp.zeros((2, F)),
                                        jnp.asarray(im.numpy()),
                                        JBlockInfo.make(stream_sample=b * F))
        assert torch.equal(po, so) and float(po.abs().max()) > 1e-3
        assert not sm.any() and not np.asarray(jm).any()
        np.testing.assert_allclose(so.numpy(), np.asarray(jo), atol=TOL, rtol=0)


@pytest.mark.parametrize("make", [
    lambda p: MegaRenderer(p, 1, 1, device="cpu"),
    lambda p: HybridMegaRenderer(p, 1, 1, device="cpu"),
    lambda p: ft.BatchRenderer(p, 1, device="cpu", lowering="hybrid").render_chunk(
        ft.BatchRenderer(p, 1, device="cpu").stack_params(), None, num_blocks=1),
], ids=["MegaRenderer", "HybridMegaRenderer", "BatchRenderer-hybrid"])
def test_kernel_lowerings_refuse_strip_masks(make):
    g = ft.AudioGraph(ft.AudioGraphConfig(0, 2))
    ft.mixer.add_mixer(g, 2, "pallas")
    pkg = g.compile(SR, F)
    prog = ft.ScheduleProgram(pkg.schedule, dict(pkg.new_node_processors), SR,
                              device="cpu", strip_masks=True)
    with pytest.raises(ValueError, match="strip_masks"):
        make(prog)
    # the eager path renders it
    br = ft.BatchRenderer(prog, 1, device="cpu")
    out, _, _ = br.render_chunk(br.stack_params(), br.init_state(), num_blocks=1)
    assert float(out.abs().max()) > 1e-3


def test_render_fn_is_render_blocks_function():
    prog = ft.mixer_graph(num_voices=2, filter_backend="auto", device="cpu")
    params, state = params_from_jax(prog.collect_params(), "cpu"), prog.init_state()
    gi, im = torch.zeros((0, F)), torch.zeros((0,), dtype=torch.bool)
    info = TBlockInfo.make(stream_sample=0)
    want = prog.render_block(prog.collect_params(), state, gi, im, info)
    got = prog.render_fn(params, state, gi, im, info)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # batched over a leading axis, and differentiable in a param leaf
    key = next(k for k in params if k.startswith("beep_test"))
    gain = params[key]["gain"].clone().requires_grad_(True)
    batched = tree_map(lambda t: torch.stack([t, t]), params)
    batched[key] = dict(batched[key], gain=torch.stack([gain, 2 * gain]))
    bstate = tree_map(lambda t: torch.stack([t, t]), state)
    out, _, _ = prog.render_fn(batched, bstate, torch.zeros((2, 0, F)),
                               torch.zeros((2, 0), dtype=torch.bool), info)
    assert out.shape == (2, 2, F) and torch.equal(out[0], got[0])
    out.square().sum().backward()
    assert gain.grad is not None and float(gain.grad.abs()) > 0
