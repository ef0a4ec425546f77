"""The mastering bus's rows in the megakernel (``csrc/megakernel.cu``: K2
and K3) on the CPU: the compressor, ducker, limiter, loudness meter, LFO,
delay compensator and the meter as a sink.

On the CPU ``MegaRenderer`` and the hybrid's islands run the kernel's plain
versions (``executor_mega.mega_chunk_reference``, ``island_chunk_
reference``): they walk the lowered tables with every leaf packed into its
words and call each row's node kernel.  Held against the port's eager
``BatchRenderer`` bit for bit, they check the lowering of each row (its
leaf layout, line length, constants, structural ints and scratch); the
partition of the bus into islands is held against the JAX package's, and
the bus's hybrid and the witness graph's K2 against the JAX package's eager
render within 1e-6.  The CUDA rows are held against eager on the card by
``chip_smoke.py`` phases 12(c) and 12(d).

Each row graph is a beep (on in two instances of three, a different third
each chunk, so that silence, tails, the lines' drains and the quiet checks
are crossed) → the node(s) under test → out, in blocks of 128 and of 127
frames.  The witness graph reaches the rows the bus lacks: the beep through
a limiter and dry, the latency pass's delay compensators, an LFO, a sum, a
0-output meter.
"""

import jax
import numpy as np
import pytest
import torch

import firewheel_tpu as fw
from firewheel_tpu import nodes as jn
from firewheel_tpu.executor_pallas import _live_sets as j_live_sets
from firewheel_tpu.executor_pallas import partition_schedule as j_partition
from firewheel_tpu.parallel import BatchRenderer as JaxBatchRenderer
import firewheel_tpu_torch as ft
from firewheel_tpu_torch import mixer
from firewheel_tpu_torch import nodes as tn
from firewheel_tpu_torch.convert import state_to_numpy
from firewheel_tpu_torch.executor_hybrid import (
    HybridMegaRenderer, _live_sets, partition_schedule,
)
from firewheel_tpu_torch.executor_mega import (
    AUX0, AUX1, N_OUT, OP, OPS, LEAF_COUNT, MegaRenderer, eligible, lower_schedule,
    scan_words,
)
from test_torch_mastering import _bus_program, _normalize, _to_jax_params, assert_bus_close

SR = 48000
B = 3
K = 3
CHUNKS = 3
TOL = 1e-6

_S = lambda node: (node, 2, 2)  # noqa: E731
#: name → the nodes after the beep, each (node factory over a node module,
#: inputs, outputs); a ducker takes the beep again as its sidechain
ROW_GRAPHS = {
    "compressor": lambda n: [_S(n.CompressorNode(-20.0, 4.0, 0.005, 0.05, 2.0, 6.0))],
    "hard_knee": lambda n: [_S(n.CompressorNode(-24.0, 8.0, 0.001, 0.02, 0.0, 0.0))],
    "ducker": lambda n: [(n.DuckerNode(-30.0, -9.0, 0.01, 0.1), 4, 2)],
    "limiter": lambda n: [_S(n.LimiterNode(-9.0, 0.003, 0.05))],
    # a lookahead of 480 frames, longer than a block
    "long_lookahead": lambda n: [_S(n.LimiterNode(-6.0, 0.01, 0.02))],
    "loudness": lambda n: [_S(n.LoudnessMeterNode())],
    "loudness_sink": lambda n: [(n.LoudnessMeterNode(), 2, 0)],
    "delay_comp_0": lambda n: [_S(n.DelayCompNode(0))],
    "delay_comp_300": lambda n: [_S(n.DelayCompNode(300)), _S(n.DelayCompNode(40))],
    "sink_meter": lambda n: [(n.DbMeterNode(), 2, 0)],
    "lfo": None,  # an LFO alone, one wave shape an instance
    "witness": None,
}


def _graph(name: str, n, frames: int):
    """``name``'s graph from node module ``n`` (the port's or JAX's),
    compiled at 48 kHz in blocks of ``frames``."""
    mod = ft if n is tn else fw
    g = mod.AudioGraph(mod.AudioGraphConfig(0, 2))
    if name == "witness":
        beep = g.add_node(0, 2, n.BeepTestNode(440.0, -6.0, True))
        lim = g.add_node(2, 2, n.LimiterNode(ceiling_db=-9.0, lookahead_secs=0.003))
        lfo = g.add_node(0, 2, n.LFONode(n.LFOShape.TRIANGLE, 3.0, 0.1, 0.0))
        mix = g.add_node(6, 2, n.SumNode())
        meter = g.add_node(2, 0, n.DbMeterNode())
        for c in range(2):
            g.connect(beep, c, lim, c)
            g.connect(lim, c, mix, c)
            g.connect(beep, c, mix, 2 + c)
            g.connect(lfo, c, mix, 4 + c)
            g.connect(mix, c, meter, c)
            g.connect(mix, c, g.graph_out_node(), c)
        # delay compensators on the dry and the LFO's edges into the sum
        g.compensate_latency(SR)
    elif name == "lfo":
        lfo = g.add_node(0, 2, n.LFONode(n.LFOShape.SINE, 5.0, 0.5, 0.1))
        for c in range(2):
            g.connect(lfo, c, g.graph_out_node(), c)
    else:
        beep = g.add_node(0, 2, n.BeepTestNode(330.0, -3.0, True))
        prev, width = beep, 2
        for node, nin, nout in ROW_GRAPHS[name](n):
            nid = g.add_node(nin, nout, node)
            for c in range(nin):
                g.connect(prev if c < width else beep, c % width, nid, c)
            prev, width = nid, nout
        if width == 0:  # a sink: the beep goes out beside it
            prev, width = beep, 2
        for c in range(2):
            g.connect(prev, c, g.graph_out_node(), c)
    pkg = g.compile(SR, frames)
    if n is tn:
        return ft.ScheduleProgram(pkg.schedule, dict(pkg.new_node_processors), SR,
                                  device="cpu")
    return fw.ScheduleProgram(pkg.schedule, dict(pkg.new_node_processors), SR)


def _chunk_params(prog, params, chunk):
    """Each beep on in two instances of three, a different third off each
    chunk; each LFO instance a wave shape of its own."""
    for key, proc in prog._procs.items():
        name = type(proc).__name__
        if name == "BeepTestProcessor":
            on = (np.arange(B) + chunk) % 3 != 0
            params[key]["enabled"].copy_(torch.from_numpy(on))
        elif name == "LFOProcessor":
            params[key]["shape"].copy_(torch.arange(B) % 4 + chunk % 2)
    return params


def _tree_equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_equal(a[k], b[k]) for k in a)
    return torch.equal(a, b)


def _against_eager(prog, other, num_blocks=None, vary=_chunk_params):
    eg = ft.BatchRenderer(prog, B, device="cpu")
    s1, s2 = eg.init_state(), other.init_state()
    f = prog.max_block_frames
    kw = {} if num_blocks is None else {"num_blocks": num_blocks}
    for c in range(CHUNKS):
        params = vary(prog, eg.stack_params(), c)
        o1, m1, s1 = eg.render_chunk(params, s1, start_sample=c * K * f, num_blocks=K)
        o2, m2, s2 = other.render_chunk(params, s2, start_sample=c * K * f, **kw)
        assert torch.equal(o1, o2), (c, float((o1 - o2).abs().max()))
        assert torch.equal(m1, m2), c
        assert _tree_equal(s1, s2), c
    assert float(o1.abs().max()) > 0.01
    return s1


@pytest.mark.parametrize("frames", [128, 127])
@pytest.mark.parametrize("name", list(ROW_GRAPHS))
def test_row_plain_version_matches_eager(name, frames):
    """K2's plain version on each row graph equals eager bit for bit:
    outputs, masks and every state leaf over three chunks."""
    prog = _graph(name, tn, frames)
    _against_eager(prog, MegaRenderer(prog, B, K, device="cpu"))


def _bus_params(prog, params, chunk):
    """``vary_mastering_params``, and the dialogue on in a different third
    of the instances each chunk."""
    mixer.vary_mastering_params(prog, params, seed=7)
    return _chunk_params(prog, params, chunk)


def test_bus_hybrid_matches_eager():
    """The bus's hybrid (two K3 islands around the noise and the FIR) equals
    eager bit for bit."""
    prog = ft.mastering_bus_graph(device="cpu")
    hy = ft.BatchRenderer(prog, B, device="cpu", lowering="hybrid")
    _against_eager(prog, hy, num_blocks=K, vary=_bus_params)


def test_bus_partition_matches_jax():
    """The bus splits as the JAX package splits it: [noise] torch | [beep,
    ducker, sum, compressor] K3 | [FIR] torch | [limiter, loudness meter]
    K3; the live sets are equal."""
    jprog, _ = _bus_program("jax")
    tprog, _ = _bus_program("port")
    assert repr(tprog.schedule) == repr(jprog.schedule)
    jsegs, tsegs = j_partition(jprog), partition_schedule(tprog)
    ids = lambda segs: [(k, [repr(sn.id) for sn in n]) for k, n in segs]  # noqa: E731
    assert ids(tsegs) == ids(jsegs)
    names = [(k, [type(tprog._procs[ft.node_key(sn.id)]).__name__ for sn in n])
             for k, n in tsegs]
    assert names == [
        ("xla", ["NoiseProcessor"]),
        ("mega", ["BeepTestProcessor", "DuckerProcessor", "SumProcessor",
                  "CompressorProcessor"]),
        ("xla", ["FirFilterProcessor"]),
        ("mega", ["LimiterProcessor", "LoudnessMeterProcessor"]),
    ]
    assert _live_sets(tprog, tsegs) == j_live_sets(jprog, jsegs)
    with pytest.raises(ValueError, match="not eligible for the megakernel"):
        MegaRenderer(tprog, 1, 1, device="cpu")  # the noise and the FIR


def test_bus_hybrid_matches_jax():
    """The bus's hybrid on the CPU against the JAX package's eager render of
    the same params: every output sample and state leaf within 1e-6, the
    meter held by its reading (``test_torch_mastering.py``)."""
    b, k = 2, 4
    tprog, ids = _bus_program("port")
    jprog, _ = _bus_program("jax")
    hy = ft.BatchRenderer(tprog, b, device="cpu", lowering="hybrid")
    jbr = JaxBatchRenderer(jprog, b)
    tp = mixer.vary_mastering_params(tprog, hy.stack_params(), seed=3)
    jp = _to_jax_params(jax.tree.map(np.asarray, jbr.stack_params()), state_to_numpy(tp))
    ts, js = hy.init_state(), jbr.init_state()
    for c in range(2):
        start = c * k * 128
        to, tm, ts = hy.render_chunk(tp, ts, start_sample=start, num_blocks=k)
        jo, jm, js = jbr.render_chunk(jp, js, start_sample=start, num_blocks=k)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=TOL, rtol=0)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert np.abs(to.numpy()).max() > 0.05
    assert_bus_close(state_to_numpy(ts), _normalize(js), ft.node_key(ids["meter"]))


@pytest.mark.parametrize("frames", [128, 127])
def test_witness_mega_matches_jax(frames):
    """The witness graph renders whole through K2 (its plain version here)
    and matches the JAX package's eager render within 1e-6: outputs, masks
    and every state leaf."""
    tprog, jprog = _graph("witness", tn, frames), _graph("witness", jn, frames)
    assert repr(tprog.schedule) == repr(jprog.schedule)
    mega = MegaRenderer(tprog, B, K, device="cpu")
    jbr = JaxBatchRenderer(jprog, B)
    ts, js = mega.init_state(), jbr.init_state()
    for c in range(CHUNKS):
        tp = _chunk_params(tprog, mega.stack_params(), c)
        jp = _to_jax_params(jax.tree.map(np.asarray, jbr.stack_params()),
                            state_to_numpy(tp))
        to, tm, ts = mega.render_chunk(tp, ts, c * K * frames)
        jo, jm, js = jbr.render_chunk(jp, js, start_sample=c * K * frames, num_blocks=K)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=TOL, rtol=0)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert np.abs(to.numpy()).max() > 0.05
    got, want = state_to_numpy(ts), _normalize(js)
    assert got.keys() == want.keys()
    for key in want:
        for leaf in want[key]:
            a, b = got[key][leaf], want[key][leaf]
            assert a.dtype == b.dtype and a.shape == b.shape, (key, leaf)
            if a.dtype.kind == "f":
                np.testing.assert_allclose(a, b, atol=TOL, rtol=0, err_msg=f"{key}/{leaf}")
            else:
                np.testing.assert_array_equal(a, b, err_msg=f"{key}/{leaf}")


SEVEN = ("CompressorProcessor", "DuckerProcessor", "LimiterProcessor",
         "LoudnessMeterProcessor", "LFOProcessor", "DelayCompProcessor",
         "_SinkMeterProcessor")


def test_the_seven_processors_have_rows():
    """Each of the seven has its own device function (codes 19..25) and none
    opts out, so K2 renders the witness graph whole."""
    codes = {t.__name__: op.code for t, op in OPS.items()}
    assert [codes[n] for n in SEVEN] == list(range(19, 26))
    prog = _graph("witness", tn, 128)
    procs = list(prog._procs.values())
    assert {type(p).__name__ for p in procs} >= {"LimiterProcessor", "LFOProcessor",
                                                "DelayCompProcessor",
                                                "_SinkMeterProcessor"}
    assert all(eligible(p) for p in procs)
    bus = ft.mastering_bus_graph(device="cpu")
    for p in bus._procs.values():
        if type(p).__name__ in SEVEN:
            assert p.supports_megakernel and eligible(p)


def _rows(prog):
    lw = lower_schedule(prog)
    by_type = {}
    for key, row in zip(lw.keys, lw.ops):
        by_type.setdefault(type(prog._procs[key]).__name__, []).append(
            (prog._procs[key], row))
    return lw, by_type


def test_rows_lower_their_structure():
    """The structural ints, constants, lines and scratch each row hands the
    kernel: the limiter's line of 144 frames (3 ms) and its scratch (the
    level sequence and the gains), the delay compensators' lines on their
    own echo records, the meter sink's 0 outputs, the loudness meter's hop
    and ring, its float32 K-weighting and weights, and its scratch (the
    shelf's output, the power, the levels)."""
    lw, rows = _rows(_graph("witness", tn, 128))
    (lim, row), = rows["LimiterProcessor"]
    assert (row[AUX0], row[AUX1]) == (144, 0) and lim.lookahead == 144
    comps = rows["DelayCompProcessor"]
    assert [(int(r[AUX0]), int(r[AUX1])) for _, r in comps] == [(144, 2), (144, 4)]
    assert lw.echo_channels == 6
    (sink, row), = rows["_SinkMeterProcessor"]
    assert row[N_OUT] == 0 and row[OP] == 25
    (lfo, row), = rows["LFOProcessor"]
    assert row[OP] == 23
    # the lines stay in device memory: no leaf words
    lines = [i for i, leaf in enumerate(lw.leaves) if leaf.path in (("delay",), ("buf",))]
    assert len(lines) == 3 and all(lw.leaf_words[i, LEAF_COUNT] == 0 for i in lines)
    assert lw.scan_words == _round4(144 + 128) + 128

    bus = ft.mastering_bus_graph(device="cpu")
    first, second = HybridMegaRenderer(bus, 1, 1, device="cpu").islands.values()
    rows = {type(bus._procs[key]).__name__: (bus._procs[key], row)
            for lw in (first, second) for key, row in zip(lw.keys, lw.ops)}
    lw = second
    meter, row = rows["LoudnessMeterProcessor"]
    assert (row[AUX0], row[AUX1]) == (4800, 31)
    consts = OPS[type(meter)].consts(meter)
    assert len(consts) == 12 and consts[10:] == (1.0, 1.0)
    assert consts[:5] == tuple(float(np.float32(c)) for c in meter._shelf)
    assert lw.scan_words == scan_words(6, 128) + 128 == 128 + 6 * 127 + 128
    for name in ("CompressorProcessor", "DuckerProcessor"):
        proc, row = rows[name]
        assert OPS[type(proc)].scan(proc, 128) == scan_words(0, 128) == 128
    assert first.scan_words == 128
    duck, row = rows["DuckerProcessor"]
    assert (row[1], row[N_OUT]) == (4, 2)  # two main inputs and a sidechain


def _round4(n):
    return (n + 3) // 4 * 4
