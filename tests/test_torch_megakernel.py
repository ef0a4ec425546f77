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

import functools
import math
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
from firewheel_tpu_torch import mixer
from firewheel_tpu_torch import nodes as tn
from firewheel_tpu_torch.convert import state_from_jax, state_to_numpy
from firewheel_tpu_torch.core.node import NodeProcessor
from firewheel_tpu_torch.core.smoother import SMOOTHER_ACTIVE, SMOOTHER_INACTIVE
from firewheel_tpu_torch.executor_hybrid import HybridMegaRenderer
from firewheel_tpu_torch.executor_mega import (
    BOOL, GROUP, INT64, IO, LEAF_COUNT, LEAF_STATE, LEAF_TYPE, LEAF_WORD, N_CLEAR,
    N_IN, N_OUT, OP, OPS, WORD, WORD32, MegaRenderer, _leaf_values,
    check_launchable, lower_schedule, pack_leaves, shared_bytes,
    supports_megakernel, unpack_leaf,
)
from firewheel_tpu_torch.mixer import effects_chain_graph, random_graph, vary_params

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
    mega = MegaRenderer(prog, batch, K, device="cpu")
    eager = ft.BatchRenderer(prog, batch, device="cpu")
    params = vary_params(mega.stack_params(), seed)
    ms, es = mega.init_state(), eager.init_state()
    f = prog.max_block_frames
    for c in range(chunks):
        mo, mm, ms = mega.render_chunk(params, ms, start_sample=c * K * f)
        eo, em, es = eager.render_chunk(params, es, start_sample=c * K * f,
                                        num_blocks=K)
        assert mo.shape == (batch, K, prog.num_graph_outputs, f)
        assert mm.shape == (batch, K, prog.num_graph_outputs)
        assert torch.equal(mo, eo), float((mo - eo).abs().max())
        assert torch.equal(mm, em)
    _assert_equal_trees(ms, es)
    return mo, mm


def test_plain_version_matches_eager_on_the_mixer():
    out, masks = _mega_vs_eager(ft.mixer_graph(num_voices=3, device="cpu"), B, seed=7)
    assert float(out.abs().max()) > 0.01


@pytest.mark.parametrize("seed", range(5))
def test_plain_version_matches_eager_on_random_graphs(seed):
    prog = random_graph(seed, device="cpu")
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


@pytest.mark.parametrize("frames", [64, 100, 127, 256])
def test_plain_version_matches_eager_at_other_block_sizes(frames):
    """Blocks of 64, 100, 127 and 256 frames: the kernel takes any length,
    127 with a padded float4 at the end of each arena row."""
    prog = random_graph(3, device="cpu", block_frames=frames)
    assert lower_schedule(prog).frames == frames
    _mega_vs_eager(prog, 2, seed=3)


@pytest.mark.parametrize("frames", [64, 100, 127, 128, 1022])
def test_kernel_takes_blocks_of_any_length(frames):
    """The wrapper takes a block of any length (the kernel pads each arena
    row to a whole float4), and refuses, before any launch, more instances a
    CTA than the kernel takes."""
    lw = lower_schedule(random_graph(0, device="cpu", block_frames=frames))
    check_launchable(lw, 1, "MegaRenderer")
    assert shared_bytes(lw, 1) % 16 == 0
    with pytest.raises(ValueError, match="tile 9"):
        check_launchable(lw, 9, "MegaRenderer")


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
    tprog = ft.mixer_graph(num_voices=3, device="cpu")
    plist = _jax_params3(jprog)
    jbr = JBatchRenderer(jprog, B)
    mega = MegaRenderer(tprog, B, K, device="cpu")
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


def _mixer_program(frames, port):
    """``tests/test_megakernel.py:mixer_program`` in blocks of ``frames``,
    from the JAX package's classes or, with ``port``, the port's: the same
    graph, node keys and params."""
    fn = jax_mega_tests.mixer_program
    env = dict(fn.__globals__, F=frames)
    if port:
        env.update(AudioGraph=ft.AudioGraph, AudioGraphConfig=ft.AudioGraphConfig,
                   ScheduleProgram=functools.partial(ft.ScheduleProgram, device="cpu"),
                   BeepTestNode=tn.BeepTestNode,
                   VolumeNode=tn.VolumeNode, SumNode=tn.SumNode,
                   StereoPanNode=tn.StereoPanNode, HardClipNode=tn.HardClipNode)
    return types.FunctionType(fn.__code__, env)()


@pytest.mark.parametrize("frames", [F, 127])
def test_plain_version_matches_jax_megakernel(frames):
    """At the mixer's 128 frames a block, and at 127 (the kernel's padded
    arena rows)."""
    jprog = _mixer_program(frames, port=False)
    tprog = _mixer_program(frames, port=True)
    assert tprog.max_block_frames == frames
    assert repr(tprog.schedule) == repr(jprog.schedule)
    b, k = 8, 2
    p = jprog.collect_params()
    clip = next(key for key in p if key.startswith("hard_clip"))
    p[clip]["threshold"] = np.float32(0.05)  # so that samples clip
    jmega = JMegaRenderer(jprog, batch=b, num_blocks=k, tile=8, interpret=True)
    jbr = JBatchRenderer(jprog, b)
    mega = MegaRenderer(tprog, b, k, device="cpu")
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
    mixer = ft.mixer_graph(device="cpu")
    assert supports_megakernel(mixer)

    g = ft.AudioGraph(ft.AudioGraphConfig(2, 2))
    v = g.add_node(2, 2, tn.VolumeNode(80.0))
    for c in range(2):
        g.connect(g.graph_in_node(), c, v, c)
        g.connect(v, c, g.graph_out_node(), c)
    pkg = g.compile(48000, F)
    streamed = ft.ScheduleProgram(pkg.schedule, dict(pkg.new_node_processors), 48000,
                                  device="cpu")
    assert streamed.num_graph_inputs == 2
    assert not supports_megakernel(streamed)
    with pytest.raises(ValueError, match="not eligible"):
        MegaRenderer(streamed, B, K, device="cpu")
    with pytest.raises(ValueError, match="not eligible"):
        lower_schedule(streamed)

    prog = ft.mixer_graph(num_voices=1, device="cpu")
    proc = next(p for p in prog._procs.values() if type(p) in OPS and type(p) is not
                tn.dummy.DummyProcessor)
    proc.supports_megakernel = False  # an instance that opts out
    assert not supports_megakernel(prog)

    prog = ft.mixer_graph(num_voices=1, device="cpu")
    proc = next(p for p in prog._procs.values()
                if isinstance(p, tn.volume.VolumeProcessor))
    proc.__class__ = _Opaque  # a subclass is not its parent's device function
    assert isinstance(proc, NodeProcessor) and not supports_megakernel(prog)

    with pytest.raises(ValueError, match="tile"):
        MegaRenderer(mixer, 3, K, tile=2, device="cpu")


def test_state_hands_over_mid_stream():
    """Eager → mega → eager equals three eager chunks, bit for bit."""
    prog = ft.mixer_graph(num_voices=3, device="cpu")
    eager = ft.BatchRenderer(prog, B, device="cpu")
    mega = MegaRenderer(prog, B, K, device="cpu")
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
    prog = ft.mixer_graph(device="cpu")
    lw = lower_schedule(prog)
    sched = prog.schedule.schedule
    assert lw.ops.shape == (62, 12) and lw.num_buffers == 40 == prog.schedule.num_buffers
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
        mine = range(row[4], row[4] + row[5])
        assert {lw.leaves[i].key for i in mine} <= {ft.node_key(sn.id)}
    assert lw.out_row.tolist() == [[ib.buffer_index, int(ib.should_clear)]
                                   for ib in sched[-1].input_buffers]
    # a random graph's unconnected input lowers with its clear flag set
    rg = lower_schedule(random_graph(0, device="cpu"))
    clears = [rg.io[int(r[3]) + int(r[1]): int(r[3]) + 2 * int(r[1])] for r in rg.ops]
    assert any(c.any() for c in clears)


def test_graph_outputs_read_cleared_and_flagged_channels_as_zero():
    """A graph output left unconnected reads as silent zeros."""
    g = ft.AudioGraph(ft.AudioGraphConfig(0, 2))
    b = g.add_node(0, 1, tn.BeepTestNode(440.0, -6.0, True))
    g.connect(b, 0, g.graph_out_node(), 0)
    pkg = g.compile(48000, F)
    prog = ft.ScheduleProgram(pkg.schedule, dict(pkg.new_node_processors), 48000,
                              device="cpu")
    mega = MegaRenderer(prog, B, K, device="cpu")
    out, masks, _ = mega.render_chunk(mega.stack_params(), mega.init_state(), 0)
    assert float(out[:, :, 0].abs().max()) > 0.1 and not bool(masks[:, :, 0].any())
    assert not bool(out[:, :, 1].any()) and bool(masks[:, :, 1].all())


def move_smoothed_params(params, step):
    """Move every pan and volume of batch-stacked ``params`` by a small
    ``step``, in place (a pan near +1 moves down): each smoother then ramps
    for ~20 blocks, settles and rests.  Returns ``params``."""
    for p in params.values():
        if "pan" in p:
            p["pan"].copy_(torch.where(p["pan"] > 0.5, p["pan"] - step, p["pan"] + step))
        if "raw_gain" in p:
            p["raw_gain"].mul_(1.0 + step)
    return params


def smoother_statuses(state):
    """Every pan and volume smoother's status in ``state``, flattened."""
    return torch.cat([v[name]["status"].reshape(-1) for v in state.values()
                      for name in ("gain", "pan") if name in v])


def test_plain_version_matches_eager_while_smoothers_move():
    """Pan and volume move mid-stream by a small step: every smoother ramps
    (active: a value per frame), settles (deactivating: the target) and
    rests (inactive) inside the tested chunks, the path on which the kernel
    computes its gains once a block.  Bit for bit against eager."""
    prog = ft.mixer_graph(num_voices=3, device="cpu")
    k = 8
    mega = MegaRenderer(prog, B, k, device="cpu")
    eager = ft.BatchRenderer(prog, B, device="cpu")
    params = mega.stack_params()
    ms = es = mega.init_state()
    seen = []
    for c in range(5):
        if c == 1:
            move_smoothed_params(params, 2e-3)
        mo, mm, ms = mega.render_chunk(params, ms, start_sample=c * k * F)
        eo, em, es = eager.render_chunk(params, es, start_sample=c * k * F,
                                        num_blocks=k)
        assert torch.equal(mo, eo), float((mo - eo).abs().max())
        assert torch.equal(mm, em)
        _assert_equal_trees(ms, es)
        seen.append(smoother_statuses(ms))
    assert float(mo.abs().max()) > 0.01
    assert bool((seen[0] == SMOOTHER_INACTIVE).all())
    assert bool((seen[1] == SMOOTHER_ACTIVE).all())  # moved, still ramping
    assert bool((seen[-1] == SMOOTHER_INACTIVE).all())  # settled, then rested


def _lowered(name):
    """``(program, lowered)`` for the leaf-layout tests: the 64-node mixer,
    the effects chain's island (filter, echo, clip) and random graphs."""
    if name == "mixer":
        prog = ft.mixer_graph(device="cpu")
        return prog, lower_schedule(prog)
    if name == "effects_island":
        prog = effects_chain_graph(clip_frames=512, filter_backend="pallas", device="cpu")
        hy = HybridMegaRenderer(prog, B, K, device="cpu")
        (lw,) = hy.islands.values()
        return prog, lw
    if name == "fx_palette":  # every FX row; the flanger has none
        kinds = tuple(k for k in mixer.FX_KINDS if k != "flanger")
        prog = mixer.fx_palette_graph(num_voices=2, device="cpu", kinds=kinds)
        return prog, lower_schedule(prog)
    _, seed, *frames = name.split("_")  # random_<seed>[_<block frames>]
    prog = random_graph(int(seed), device="cpu",
                        block_frames=int(frames[0]) if frames else F)
    return prog, lower_schedule(prog)


LAYOUT_GRAPHS = ["mixer", "effects_island", "random_0", "random_1", "random_2",
                 "random_1_256", "random_0_127", "fx_palette"]


def _in_memory(prog, leaf):
    """True for a leaf that stays in device memory (a row's line)."""
    return (leaf.tree, leaf.path) in OPS[type(prog._procs[leaf.key])].in_memory


def _random_leaf(leaf, rng, batch):
    """A seeded value for ``leaf`` that uses every bit its type carries:
    uint32 above 2**31 in the int64 carriers, negative int32, and f32 NaN,
    infinities and signed zeros."""
    shape = (batch,) + leaf.shape
    if leaf.dtype == torch.bool:
        return torch.from_numpy(rng.random(shape) < 0.5)
    if leaf.dtype == torch.int64:
        return torch.from_numpy(rng.integers(0, 2**32, shape, dtype=np.int64))
    if leaf.dtype == torch.int32:
        return torch.from_numpy(rng.integers(-2**31, 2**31, shape, dtype=np.int32))
    x = rng.standard_normal(shape).astype(np.float32)
    x.reshape(-1)[:4] = [np.nan, np.inf, -0.0, -np.inf][: x.size]
    return torch.from_numpy(x)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("name", LAYOUT_GRAPHS)
def test_leaf_words_round_trip(name):
    """Every leaf on chip packs into its words and back bit for bit; the
    echo's line stays in device memory; words are laid out leaf after leaf,
    each row's from its WORD column."""
    prog, lw = _lowered(name)
    rng = np.random.default_rng(LAYOUT_GRAPHS.index(name))
    batch = 3
    counts = lw.leaf_words[:, LEAF_COUNT]
    assert lw.leaf_words[:, LEAF_WORD].tolist() == np.concatenate(
        [[0], np.cumsum(counts)[:-1]]).tolist()
    assert lw.num_words == int(counts.sum())
    for row in lw.ops:
        if row[5]:  # a row's words start at its first leaf's
            assert row[WORD] == lw.leaf_words[row[4], LEAF_WORD]
    for i, leaf in enumerate(lw.leaves):
        on_chip = not _in_memory(prog, leaf)
        assert counts[i] == (math.prod(leaf.shape) if on_chip else 0)
        assert lw.leaf_words[i, LEAF_STATE] == (leaf.tree == "state")
        assert lw.leaf_words[i, LEAF_TYPE] == {
            torch.bool: BOOL, torch.int64: INT64}.get(leaf.dtype, WORD32)

    # seeded values with every bit pattern, and the graph's own leaves
    # (params varied per instance, derived filter coefficients included)
    br = ft.BatchRenderer(prog, batch, device="cpu")
    params = vary_params(br.stack_params(), 1)
    keys = set(lw.keys)
    own = _leaf_values(prog, lw, {k: v for k, v in params.items() if k in keys},
                       br.init_state())
    seeded = [_random_leaf(leaf, rng, batch) for leaf in lw.leaves]
    for values in (seeded, own):
        words = pack_leaves(lw, values)
        assert words.dtype == torch.int32 and words.shape == (batch, lw.num_words)
        for i, leaf in enumerate(lw.leaves):
            if not counts[i]:
                continue
            got = unpack_leaf(lw, words, i)
            assert got.dtype == leaf.dtype and got.shape == values[i].shape, leaf
            assert torch.equal(_bits(got), _bits(values[i])), leaf
    types = set(lw.leaf_words[counts > 0, LEAF_TYPE].tolist())
    if name == "mixer":  # bool, uint32-in-int64, f32 and int32 leaves, derived
        assert types == {BOOL, INT64, WORD32}
        assert any(leaf.tree == "derived" for leaf in lw.leaves)
        assert any(leaf.dtype == torch.int32 for leaf in lw.leaves)


@pytest.mark.parametrize("name", LAYOUT_GRAPHS)
def test_shared_bytes_counts_the_kernels_words(name):
    """``shared_bytes`` is the kernel's count (csrc/megakernel.cu:
    shared_bytes), here from the schedule itself: the tables once a CTA
    (rows of 12 words), then per instance the arena, a record of 10 words
    per echo channel, the flags, the leaf words and the rows' scratch, each
    part rounded up to 16 bytes; an arena row of F frames takes F rounded up
    to a float4."""
    prog, lw = _lowered(name)
    procs = [prog._procs[key] for key in lw.keys]
    by_key = {ft.node_key(sn.id): sn for sn in prog.schedule.schedule}
    io = sum(2 * len(by_key[key].input_buffers) + len(by_key[key].output_buffers)
             for key in lw.keys)
    consts = sum(len(OPS[type(p)].consts(p)) for p in procs)
    tables = 12 * len(procs) + io + consts + lw.out_row.size + lw.in_bufs.size
    echo = sum(p.num_inputs for p in procs if OPS[type(p)].line is not None)
    leaf_words = sum(math.prod(leaf.shape) for leaf in lw.leaves
                     if not _in_memory(prog, leaf))
    nb, f = prog.schedule.num_buffers, prog.max_block_frames
    per_instance = nb * (-(-f // 4) * 4) + 10 * echo + nb + leaf_words + lw.scan_words
    for tile in (1, 2, 8):
        assert shared_bytes(lw, tile) == 4 * (
            -(-tables // 4) * 4 + tile * (-(-per_instance // 4) * 4))
    if name == "mixer":  # 40 buffers of 128 frames, 2 echo channels
        assert (nb, echo, leaf_words) == (40, 2, 249)


@pytest.mark.parametrize("name", LAYOUT_GRAPHS)
def test_row_groups_run_side_by_side_safely(name):
    """The kernel runs a group of rows on parts of one warp, reading all of
    their inputs before writing any output: a group is 1, 2 or 4 rows of
    one of dummy, beep, volume and pan, with equal port counts of at most
    two and no cleared input, and no row of it reads or writes a buffer
    that an earlier row of it writes."""
    _, lw = _lowered(name)
    groupable = {OPS[c].code for c in (
        tn.dummy.DummyProcessor, tn.beep_test.BeepTestProcessor,
        tn.volume.VolumeProcessor, tn.pan.StereoPanProcessor)}
    sizes, n = [], 0
    while n < len(lw.ops):
        size = int(lw.ops[n, GROUP])
        assert size in (1, 2, 4) and not lw.ops[n + 1: n + size, GROUP].any()
        rows = lw.ops[n: n + size]
        writes = set()
        for r in rows:
            at, n_in, n_out = int(r[IO]), int(r[N_IN]), int(r[N_OUT])
            ins = set(lw.io[at: at + n_in].tolist())
            outs = set(lw.io[at + 2 * n_in: at + 2 * n_in + n_out].tolist())
            assert not (ins | outs) & writes
            writes |= outs
        if size > 1:
            assert rows[0, OP] in groupable and not rows[:, N_CLEAR].any()
            assert len({tuple(r) for r in rows[:, [OP, N_IN, N_OUT]]}) == 1
            assert rows[0, N_IN] <= 2 and rows[0, N_OUT] <= 2
        sizes.append(size)
        n += size
    if name == "mixer":  # 19 beeps, volumes and pans: 23 steps for 62 rows
        assert sizes == [4, 4, 4, 4, 2, 1] * 3 + [1] * 5
