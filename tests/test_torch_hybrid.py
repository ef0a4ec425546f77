"""The hybrid lowering (``firewheel_tpu_torch.executor_hybrid``) on the CPU.

On the CPU every island runs ``executor_mega.island_chunk_reference``, the
plain version of the island kernel (K3), and the torch stages run the
port's node kernels.

* Partitions and live sets equal the JAX package's on the JAX tests' own
  graphs (``tests/test_hybrid_megakernel.py``, rebuilt from the port's
  classes).
* Against the JAX ``BatchRenderer`` with ``FilterNode(backend="pallas")``
  (K1 in interpret mode, the sequential recurrence the port runs
  everywhere) and against JAX's ``HybridMegaRenderer(interpret=True)``,
  whose island runs the filter as a Hillis–Steele scan: 1e-5 on audio and
  state, masks equal.  The test messages carry the measured worst case.
  The sampler's interpolation weights round by up to an ulp (XLA contracts
  them into FMAs, test_torch_sampler.py), the filter feeds that back, and
  the scan rounds otherwise than the recurrence.
* Against the port's own eager ``BatchRenderer``: bit for bit
  (``torch.equal``): both call the same node kernels on the same tensors.
  The island runs the filter's sequential recurrence whatever its backend,
  so those graphs build their filter with ``backend="pallas"``.
"""

import types

import jax
import numpy as np
import pytest
import torch

import firewheel_tpu_torch as ft
import test_hybrid_megakernel as jh
import test_torch_megakernel as tm
from firewheel_tpu import AudioGraph as JAudioGraph
from firewheel_tpu import AudioGraphConfig as JAudioGraphConfig
from firewheel_tpu import ScheduleProgram as JScheduleProgram
from firewheel_tpu import nodes as jn
from firewheel_tpu.core.sample_resource import SampleResource as JSampleResource
from firewheel_tpu.executor_pallas import HybridMegaRenderer as JHybrid
from firewheel_tpu.executor_pallas import _live_sets as j_live_sets
from firewheel_tpu.executor_pallas import partition_schedule as j_partition
from firewheel_tpu.parallel import BatchRenderer as JBatchRenderer
from firewheel_tpu_torch import mixer
from firewheel_tpu_torch import nodes as tn
from firewheel_tpu_torch.convert import state_from_jax, state_to_numpy
from firewheel_tpu_torch.core.smoother import SMOOTHER_ACTIVE, SMOOTHER_INACTIVE
from firewheel_tpu_torch.executor_hybrid import (
    HybridMegaRenderer, _live_sets, partition_schedule,
)
from firewheel_tpu_torch.executor_mega import island_chunk_reference

B = 4
K = 4
F = 128
TOL = 1e-5


def _port_program(g):
    pkg = g.compile(jh.SR, jh.F)
    return ft.ScheduleProgram(pkg.schedule, dict(pkg.new_node_processors), jh.SR,
                              device="cpu")


def _port(fn):
    """One of ``test_hybrid_megakernel``'s graph builders, built from the
    port's classes: the same graph, node keys and params."""
    env = dict(fn.__globals__)
    env.update(
        AudioGraph=ft.AudioGraph, AudioGraphConfig=ft.AudioGraphConfig,
        SampleResource=ft.SampleResource, _program=_port_program,
        **{name: getattr(tn, name) for name in (
            "BeepTestNode", "ConvolutionReverbNode", "EchoNode", "FilterNode",
            "HardClipNode", "SamplerNode", "StereoPanNode", "SumNode",
            "VolumeNode")},
    )
    return types.FunctionType(fn.__code__, env)()


def _jax_builder(fn):
    """One of the port's ``mixer.py`` builders, built from the JAX
    package's classes."""
    env = dict(fn.__globals__)
    env.update(
        AudioGraph=JAudioGraph, AudioGraphConfig=JAudioGraphConfig,
        SampleResource=JSampleResource,
        ScheduleProgram=lambda s, p, sr, device=None: JScheduleProgram(s, p, sr),
        **{name: getattr(jn, name) for name in (
            "ConvolutionReverbNode", "EchoNode", "FilterNode", "HardClipNode",
            "SamplerNode")},
    )
    env["add_effects_chain"] = types.FunctionType(mixer.add_effects_chain.__code__,
                                                  env, argdefs=(
                                                      mixer.add_effects_chain.__defaults__))
    env["_chain"] = types.FunctionType(mixer._chain.__code__, env)
    return types.FunctionType(fn.__code__, env, argdefs=fn.__defaults__)


GRAPHS = {
    "effects_chain": jh.effects_chain_program,
    "stream_in": jh.stream_in_program,
    "mixer": jh.mixer_program,
}


def _segments(segs):
    return [(kind, [repr(sn.id) for sn in nodes]) for kind, nodes in segs]


@pytest.mark.parametrize("name,min_island,kinds", [
    ("effects_chain", 2, ["xla", "mega", "xla"]),
    ("stream_in", 1, ["mega"]),
    ("mixer", 2, ["mega"]),
    ("effects_chain", 5, ["xla"]),
])
def test_partition_and_live_sets_match_jax(name, min_island, kinds):
    jprog, tprog = GRAPHS[name](), _port(GRAPHS[name])
    assert repr(tprog.schedule) == repr(jprog.schedule)
    tsegs = partition_schedule(tprog, min_island)
    jsegs = j_partition(jprog, min_island)
    assert _segments(tsegs) == _segments(jsegs)
    assert [k for k, _ in tsegs] == kinds
    live = _live_sets(tprog, tsegs)
    assert live == j_live_sets(jprog, jsegs)
    # each island lowers its own rows with the live sets as its operands
    hy = HybridMegaRenderer(tprog, B, K, min_island=min_island, device="cpu")
    assert sorted(hy.islands) == [i for i, k in enumerate(kinds) if k == "mega"]
    for i, lw in hy.islands.items():
        assert list(lw.keys) == _segments(tsegs)[i][1]
        assert lw.in_bufs.tolist() == live[0][i]
        assert lw.out_row.tolist() == [[b, 0] for b in live[1][i]]
    if name == "stream_in":  # graph_in rows are live-ins of the island
        gi = [ob.buffer_index for ob in tprog.schedule.schedule[0].output_buffers]
        assert live[0][0] == sorted(gi) and live[1][-1] == sorted(gi)


def _np(tree):
    return state_to_numpy(state_from_jax(jax.tree.map(np.asarray, tree), "cpu"))


def _worst(a, b):
    """Largest difference over two numpy trees: floats by max abs
    difference; integer and bool leaves must be equal."""
    assert a.keys() == b.keys()
    worst = 0.0
    for k in a:
        if isinstance(a[k], dict):
            worst = max(worst, _worst(a[k], b[k]))
        elif a[k].dtype.kind == "f":
            worst = max(worst, float(np.abs(a[k] - b[k]).max(initial=0.0)))
        else:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    return worst


def _against_jax(tprog, jrender, jstate, chunks=3, batch=B, k=K):
    """Render ``chunks`` chunks with the port's hybrid and with ``jrender``
    from the same per-instance params; return the worst difference of
    outputs and state (masks and integer leaves must be equal)."""
    br = ft.BatchRenderer(tprog, batch, device="cpu", lowering="hybrid")
    tparams = mixer.vary_effects_params(br.stack_params())
    # instance 0 never plays: its masks are set from the first block
    tparams[next(k for k in tparams if k.startswith("sampler"))]["playing"][0] = False
    jparams = state_to_numpy(tparams)
    tstate = br.init_state()
    assert _worst(state_to_numpy(tstate), _np(jstate)) == 0.0
    worst = 0.0
    for c in range(chunks):
        to, tm, tstate = br.render_chunk(tparams, tstate, start_sample=c * k * F,
                                         num_blocks=k)
        jo, jm, jstate = jrender(jparams, jstate, c * k * F)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        worst = max(worst, float(np.abs(to.numpy() - np.asarray(jo)).max()))
    assert float(to.abs().max()) > 0.05 and tm.any() and not tm.all()
    return max(worst, _worst(state_to_numpy(tstate), _np(jstate)))


def test_hybrid_matches_jax_batch_renderer():
    jprog = _jax_builder(mixer.effects_chain_graph)(
        clip_frames=4096, filter_backend="pallas")
    tprog = mixer.effects_chain_graph(clip_frames=4096, filter_backend="pallas",
                                      device="cpu")
    assert repr(tprog.schedule) == repr(jprog.schedule)
    assert list(tprog._procs) == list(jprog._procs)
    jbr = JBatchRenderer(jprog, B)

    def render(params, state, start):
        return jbr.render_chunk(params, state, start_sample=start, num_blocks=K)

    worst = _against_jax(tprog, render, jbr.init_state())
    print(f"hybrid vs JAX BatchRenderer (pallas filter): worst {worst:.3e}")
    assert worst <= TOL, f"hybrid vs JAX BatchRenderer: worst {worst:.3e}"


def test_hybrid_matches_jax_hybrid_interpret():
    jprog = jh.effects_chain_program()
    tprog = mixer.effects_chain_graph(clip_frames=4096, device="cpu")
    assert repr(tprog.schedule) == repr(jprog.schedule)
    jhy = JHybrid(jprog, batch=B, num_blocks=K, tile=B, interpret=True)

    def render(params, state, start):
        return jhy.render_chunk(params, state, start_sample=start)

    worst = _against_jax(tprog, render, jhy.init_state())
    print(f"hybrid vs JAX HybridMegaRenderer(interpret): worst {worst:.3e}")
    assert worst <= TOL, f"hybrid vs JAX HybridMegaRenderer: worst {worst:.3e}"


def test_state_hands_over_from_jax_mid_stream():
    """JAX renders two chunks; its state (uint32 playheads and sequence
    numbers, bool latches, the reverb's tail) crosses into the port, whose
    hybrid renders the third chunk as JAX does."""
    jprog = _jax_builder(mixer.effects_chain_graph)(
        clip_frames=2048, filter_backend="pallas")
    tprog = mixer.effects_chain_graph(clip_frames=2048, filter_backend="pallas",
                                      device="cpu")
    jbr, tbr = JBatchRenderer(jprog, B), ft.BatchRenderer(tprog, B, device="cpu",
                                                          lowering="hybrid")
    tparams = mixer.vary_effects_params(tbr.stack_params())
    jparams = state_to_numpy(tparams)
    jstate = jbr.init_state()
    for c in range(2):
        _, _, jstate = jbr.render_chunk(jparams, jstate, start_sample=c * K * F,
                                        num_blocks=K)
    tstate = state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
    assert _worst(state_to_numpy(tstate), _np(jstate)) == 0.0  # a round trip
    skey = next(k for k in tstate if k.startswith("sampler"))
    assert tstate[skey]["playhead"].dtype == torch.int64
    assert bool(tstate[skey]["prev_playing"].all())
    jo, jm, jstate = jbr.render_chunk(jparams, jstate, start_sample=2 * K * F,
                                      num_blocks=K)
    to, tm, tstate = tbr.render_chunk(tparams, tstate, start_sample=2 * K * F,
                                      num_blocks=K)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    worst = max(float(np.abs(to.numpy() - np.asarray(jo)).max()),
                _worst(state_to_numpy(tstate), _np(jstate)))
    assert worst <= TOL, f"handoff from JAX: worst {worst:.3e}"


def test_config4_fft_reverb_matches_jax():
    """BASELINE config 4: the 0.6 s IR takes the FFT engine."""
    jprog = _jax_builder(mixer.effects_chain_config4_graph)(filter_backend="pallas")
    tprog = mixer.effects_chain_config4_graph(filter_backend="pallas", device="cpu")
    assert repr(tprog.schedule) == repr(jprog.schedule)
    rev = next(p for p in tprog._procs.values() if isinstance(
        p, tn.reverb.ConvolutionReverbProcessor))
    assert (rev._method, rev._partitions) == ("fft", 225)
    jbr = JBatchRenderer(jprog, 2)

    def render(params, state, start):
        return jbr.render_chunk(params, state, start_sample=start, num_blocks=2)

    worst = _against_jax(tprog, render, jbr.init_state(), chunks=2, batch=2, k=2)
    print(f"config 4 hybrid vs JAX BatchRenderer: worst {worst:.3e}")
    assert worst <= TOL, f"config 4: worst {worst:.3e}"


def _assert_equal_trees(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _assert_equal_trees(a[k], b[k])
        else:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def _graph_input(prog, batch, seed):
    """Seeded stream input with one silent channel in four."""
    rng = np.random.default_rng(seed)
    n = prog.num_graph_inputs
    gi = torch.from_numpy((0.3 * rng.standard_normal((batch, K, n, F))).astype(
        np.float32))
    im = torch.from_numpy(rng.random((batch, K, n)) < 0.25)
    return gi.masked_fill(im[..., None], 0.0), im


def _programs():
    return {
        "effects_chain": (mixer.effects_chain_graph(
            clip_frames=2048, filter_backend="pallas", device="cpu"), 2),
        "stream_in": (_port(jh.stream_in_program), 1),
        "mixer": (_port(jh.mixer_program), 2),
    }


@pytest.mark.parametrize("name", ["effects_chain", "stream_in", "mixer"])
def test_hybrid_equals_eager_bit_for_bit(name):
    prog, min_island = _programs()[name]
    hy = HybridMegaRenderer(prog, B, K, min_island=min_island, device="cpu")
    eager = ft.BatchRenderer(prog, B, device="cpu")
    params = hy.stack_params()
    mixer.vary_effects_params(params)
    mixer.vary_params(params, 5)
    hs, es = hy.init_state(), eager.init_state()
    for c in range(3):
        gi, im = _graph_input(prog, B, c)
        ho, hm, hs = hy.render_chunk(params, hs, gi, im, start_sample=c * K * F)
        eo, em, es = eager.render_chunk(params, es, gi, im, start_sample=c * K * F,
                                        num_blocks=K)
        assert torch.equal(ho, eo), float((ho - eo).abs().max())
        assert torch.equal(hm, em)
    assert float(ho.abs().max()) > 0.01
    _assert_equal_trees(hs, es)


@pytest.mark.parametrize("name", ["stream_in", "mixer_voices"])
def test_island_matches_eager_while_smoothers_move(name):
    """Pan and volume move mid-stream by a small step inside an island: its
    smoothers ramp, settle and rest inside the tested chunks (the path on
    which K3 computes its gains once a block), and the island's plain
    version equals eager bit for bit."""
    if name == "stream_in":
        prog, min_island = _port(jh.stream_in_program), 1
    else:  # three voices of beep, volume and pan, then the mixer's chain
        prog, min_island = mixer.mixer_graph(num_voices=3, device="cpu"), 2
    k = 8
    hy = HybridMegaRenderer(prog, B, k, min_island=min_island, device="cpu")
    assert [kind for kind, _ in hy.segments] == ["mega"]
    eager = ft.BatchRenderer(prog, B, device="cpu")
    params = hy.stack_params()
    hs = es = hy.init_state()
    rng = np.random.default_rng(4)
    ni = prog.num_graph_inputs
    seen = []
    for c in range(5):
        if c == 1:
            tm.move_smoothed_params(params, 2e-3)
        # loud stream input: an all-silent block would reset the smoothers
        gi = torch.from_numpy((0.3 * rng.standard_normal((B, k, ni, F))).astype(
            np.float32))
        im = torch.zeros((B, k, ni), dtype=torch.bool)
        ho, hm, hs = hy.render_chunk(params, hs, gi, im, start_sample=c * k * F)
        eo, em, es = eager.render_chunk(params, es, gi, im, start_sample=c * k * F,
                                        num_blocks=k)
        assert torch.equal(ho, eo), float((ho - eo).abs().max())
        assert torch.equal(hm, em)
        _assert_equal_trees(hs, es)
        seen.append(tm.smoother_statuses(hs))
    assert float(ho.abs().max()) > 0.01
    assert bool((seen[0] == SMOOTHER_INACTIVE).all())
    assert bool((seen[1] == SMOOTHER_ACTIVE).all())
    assert bool((seen[-1] == SMOOTHER_INACTIVE).all())


def test_state_hands_over_between_lowerings():
    """eager → hybrid → eager equals three eager chunks, bit for bit."""
    prog = mixer.effects_chain_graph(clip_frames=2048, filter_backend="pallas",
                                     device="cpu")
    eager = ft.BatchRenderer(prog, B, device="cpu")
    hybrid = ft.BatchRenderer(prog, B, device="cpu", lowering="hybrid")
    params = mixer.vary_effects_params(eager.stack_params())
    ref_state = eager.init_state()
    ref = []
    for c in range(3):
        o, m, ref_state = eager.render_chunk(params, ref_state,
                                             start_sample=c * K * F, num_blocks=K)
        ref.append((o, m))
    st = eager.init_state()
    got = []
    for c, r in enumerate((eager, hybrid, eager)):
        o, m, st = r.render_chunk(params, st, start_sample=c * K * F, num_blocks=K)
        got.append((o, m))
    for (o, m), (ro, rm) in zip(got, ref):
        assert torch.equal(o, ro) and torch.equal(m, rm)
    _assert_equal_trees(st, ref_state)


def test_nonzero_status_raises():
    br = ft.BatchRenderer(mixer.effects_chain_graph(clip_frames=512, device="cpu"), B,
                          device="cpu", lowering="hybrid")
    with pytest.raises(ValueError, match="status"):
        br.render_chunk(br.stack_params(), br.init_state(), num_blocks=K, status=1)
    with pytest.raises(ValueError, match="lowering"):
        ft.BatchRenderer(mixer.effects_chain_graph(clip_frames=512, device="cpu"), B,
                         device="cpu", lowering="mosaic")


def test_island_returns_live_outs_as_they_are():
    """graph_in → clip → out with the clip as an island: a flagged live-in
    with nonzero samples leaves the island unzeroed with its flag; the
    graph output then reads it as zero, as the eager path does."""
    g = ft.AudioGraph(ft.AudioGraphConfig(2, 2))
    clip = g.add_node(2, 2, tn.HardClipNode(-6.0))
    for c in range(2):
        g.connect(g.graph_in_node(), c, clip, c)
        g.connect(clip, c, g.graph_out_node(), c)
    pkg = g.compile(48000, F)
    prog = ft.ScheduleProgram(pkg.schedule, dict(pkg.new_node_processors), 48000,
                              device="cpu")
    hy = HybridMegaRenderer(prog, B, K, min_island=1, device="cpu")
    assert [k for k, _ in hy.segments] == ["mega"]
    gi = torch.full((B, K, 2, F), 0.25)
    im = torch.zeros((B, K, 2), dtype=torch.bool)
    im[:, :, 1] = True  # channel 1 flagged silent, though its samples are not
    lw = hy.islands[0]
    params, state = hy.stack_params(), hy.init_state()
    rows, flags, _ = island_chunk_reference(prog, lw, params, state, gi, im, 0, K, B)
    assert torch.equal(flags, im)
    assert float(rows.abs().min()) > 0.2  # both channels, flagged or not
    out, masks, _ = hy.render_chunk(params, state, gi, im)
    eo, em, _ = ft.BatchRenderer(prog, B, device="cpu").render_chunk(params, state, gi, im,
                                                       num_blocks=K)
    assert torch.equal(out, eo) and torch.equal(masks, em)
    assert not bool(out[:, :, 1].any()) and float(out[:, :, 0].abs().min()) > 0.2


def test_the_slice_at_a_small_size():
    """The slice's graph (an 8192-frame clip) through
    ``BatchRenderer(lowering="hybrid")`` with per-instance params: loops on
    even instances, one-shots on odd ones, some finishing mid-run."""
    prog = ft.effects_chain_graph(device="cpu")
    br = ft.BatchRenderer(prog, 8, device="cpu", lowering="hybrid")
    params = mixer.vary_effects_params(br.stack_params())
    state = br.init_state()
    masks = []
    for c in range(4):
        out, om, state = br.render_chunk(params, state, start_sample=c * K * F,
                                         num_blocks=K)
        assert out.shape == (8, K, 2, F) and om.shape == (8, K, 2)
        assert bool(torch.isfinite(out).all())
        masks.append(om)
    skey = next(k for k in state if k.startswith("sampler"))
    s = state_to_numpy(state)[skey]
    # one-shots from frame 7168 at rate 1 and from 5120 at rate 2 finish
    assert s["finish_count"].tolist() == [0, 0, 0, 0, 0, 1, 0, 1]
    assert s["ended"].tolist() == [False] * 5 + [True, False, True]
    assert (s["loop_count"][::2] == 0).all()  # 2048 frames of an 8192 loop
    assert params[skey]["rate"].tolist() == [0.75, 1.0, 1.25, 1.5, 1.75, 2.0, 0.75, 1.0]
    assert not bool(torch.cat(masks, 1).any())  # every tail still rings


def test_port_graph_builder_keeps_jax_keys():
    """``mixer.effects_chain_graph`` is ``bench.py --hybrid``'s graph: same
    schedule and node keys as the JAX package built from the same code."""
    jprog = _jax_builder(mixer.effects_chain_graph)()
    tprog = mixer.effects_chain_graph(device="cpu")
    assert repr(tprog.schedule) == repr(jprog.schedule)
    assert list(tprog._procs) == list(jprog._procs)
    jp, tp = jprog.collect_params(), tprog.collect_params()
    for key in jp:
        for leaf, v in dict(jp[key]).items():
            np.testing.assert_array_equal(np.asarray(tp[key][leaf]), np.asarray(v))
