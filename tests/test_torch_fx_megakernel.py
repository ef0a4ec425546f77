"""The FX palette's rows in the megakernel (``csrc/megakernel.cu``: K2 and
K3) on the CPU.

On the CPU ``MegaRenderer`` and the hybrid's islands run the kernel's plain
versions (``executor_mega.mega_chunk_reference``, ``island_chunk_
reference``): they walk the lowered tables with every leaf packed into its
words and call each row's node kernel.  Held against the port's eager
``BatchRenderer`` bit for bit, they check the lowering of each FX row (its
leaf layout, line length, constants and scratch); the partition of the
palette into islands is held against the JAX package's.  The CUDA rows are
held against eager on the card by ``chip_smoke.py`` phase 13(c).

Each row graph is a few voices (beep → volume → pan, one in three disabled
each chunk, so that silence, tails and resets are crossed) → sum → the
node(s) under test → out, in blocks of 128 and of 127 frames.
"""

import numpy as np
import pytest
import torch

import firewheel_tpu as fw
import firewheel_tpu_torch as ft
from firewheel_tpu import nodes as jn
from firewheel_tpu.executor_pallas import _live_sets as j_live_sets
from firewheel_tpu.executor_pallas import partition_schedule as j_partition
from firewheel_tpu_torch import mixer
from firewheel_tpu_torch import nodes as tn
from firewheel_tpu_torch.executor_hybrid import _live_sets, partition_schedule
from firewheel_tpu_torch.executor_mega import (
    AUX0, AUX1, OP, OPS, MegaRenderer, lower_schedule, scan_words,
)
from firewheel_tpu_torch.nodes.beep_test import BeepTestProcessor

SR = 48000
B = 4
K = 3
CHUNKS = 3

_S = lambda node: (node, 2, 2)  # noqa: E731
#: name → the inserts after the sum, each (node, inputs, outputs)
ROW_GRAPHS = {
    "eq": lambda: [_S(mixer.fx_insert("eq"))],
    "eq_one_band_off": lambda: [_S(tn.ParametricEQNode([
        tn.EQBand(tn.FilterType.LOW_SHELF, 150.0, 0.8, 4.0),
        tn.EQBand(tn.FilterType.PEAKING, 1500.0, 1.2, -6.0, enabled=False)]))],
    "chorus": lambda: [_S(mixer.fx_insert("chorus"))],
    "vibrato": lambda: [_S(tn.ModDelayNode.vibrato())],
    # a line of 50 samples, shorter than a block
    "short_line": lambda: [_S(tn.ModDelayNode(2.0, 0.0002, 0.0003, 0.5,
                                              max_delay_secs=0.001))],
    "tremolo": lambda: [_S(mixer.fx_insert("tremolo"))],
    "ring_mod": lambda: [_S(tn.TremoloNode(40.0, 1.0, 0.3, bipolar=True))],
    "gate": lambda: [_S(tn.GateNode(-30.0, -60.0, 0.002, 0.02, 0.001, 4.0))],
    "width": lambda: [_S(tn.StereoWidthNode(1.7))],
    "pitch": lambda: [(tn.StereoToMonoNode(), 2, 1), (tn.PitchShiftNode(7.0, 0.5), 1, 1),
                      (tn.MonoToStereoNode(), 1, 2)],
    **{f"shape_{c}": (lambda c=c: [_S(tn.WaveshaperNode(c, 9.0, 0.7))])
       for c in tn.waveshaper.SHAPES},
    **{f"shape_{c}_dc": (lambda c=c: [_S(tn.WaveshaperNode(c, 6.0, 0.6, dc_block=True))])
       for c in ("tanh", "fold")},
}


def row_graph(name: str, frames: int = 128, voices: int = 3):
    g = ft.AudioGraph(ft.AudioGraphConfig(0, 2))
    s = g.add_node(2 * voices, 2, tn.SumNode())
    for i in range(voices):
        mixer.add_fx_voice(g, s, i, mixer.FX_VOICES[i])
    prev, width = s, 2
    for node, nin, nout in ROW_GRAPHS[name]():
        nid = g.add_node(nin, nout, node)
        for c in range(nin):
            g.connect(prev, c % width, nid, c)
        prev, width = nid, nout
    for c in range(2):
        g.connect(prev, c, g.graph_out_node(), c)
    pkg = g.compile(SR, frames)
    return ft.ScheduleProgram(pkg.schedule, dict(pkg.new_node_processors), SR, device="cpu")


def _chunk_params(prog, params, chunk):
    """``vary_fx_params``, and each beep on or off for the chunk."""
    mixer.vary_fx_params(prog, params, seed=3)
    rng = np.random.default_rng(100 + chunk)
    for key, proc in prog._procs.items():
        if isinstance(proc, BeepTestProcessor):
            en = params[key]["enabled"]
            en.copy_(torch.from_numpy(rng.random(en.shape[0]) < 0.67))
    return params


def _tree_equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_equal(a[k], b[k]) for k in a)
    return torch.equal(a, b)


def _against_eager(prog, other, num_blocks=None):
    eg = ft.BatchRenderer(prog, B, device="cpu")
    s1, s2 = eg.init_state(), other.init_state()
    f = prog.max_block_frames
    kw = {} if num_blocks is None else {"num_blocks": num_blocks}
    for c in range(CHUNKS):
        params = _chunk_params(prog, eg.stack_params(), c)
        o1, m1, s1 = eg.render_chunk(params, s1, start_sample=c * K * f, num_blocks=K)
        o2, m2, s2 = other.render_chunk(params, s2, start_sample=c * K * f, **kw)
        assert torch.equal(o1, o2), (c, float((o1 - o2).abs().max()))
        assert torch.equal(m1, m2), c
        assert _tree_equal(s1, s2), c
    assert float(o1.abs().max()) > 0.01


@pytest.mark.parametrize("frames", [128, 127])
@pytest.mark.parametrize("name", list(ROW_GRAPHS))
def test_row_plain_version_matches_eager(name, frames):
    """K2's plain version on each FX row graph equals eager bit for bit:
    outputs, masks and every state leaf over three chunks."""
    prog = row_graph(name, frames)
    _against_eager(prog, MegaRenderer(prog, B, K, device="cpu"))


def test_palette_hybrid_matches_eager():
    """The palette's hybrid (two K3 islands around the flanger) equals eager
    bit for bit."""
    prog = mixer.fx_palette_graph(num_voices=3, device="cpu")
    hy = ft.BatchRenderer(prog, B, device="cpu", lowering="hybrid")
    _against_eager(prog, hy, num_blocks=K)


def test_palette_partition_matches_jax():
    """The palette splits as the JAX package splits it: the voices, sum,
    clip, EQ and chorus one island, the flanger a torch stage, the rest
    (tremolo to meter) a second island; the live sets are equal."""
    g = fw.AudioGraph(fw.AudioGraphConfig(0, 2))
    mixer.add_fx_palette(g, 3, nodes=jn)
    pkg = g.compile(SR, 128)
    jprog = fw.ScheduleProgram(pkg.schedule, dict(pkg.new_node_processors), SR)
    tprog = mixer.fx_palette_graph(num_voices=3, device="cpu")
    assert repr(tprog.schedule) == repr(jprog.schedule)
    jsegs, tsegs = j_partition(jprog), partition_schedule(tprog)
    ids = lambda segs: [(k, [repr(sn.id) for sn in n]) for k, n in segs]  # noqa: E731
    assert ids(tsegs) == ids(jsegs)
    assert [k for k, _ in tsegs] == ["mega", "xla", "mega"]
    assert [type(tprog._procs[ft.node_key(sn.id)]).__name__ for sn in tsegs[1][1]] == [
        "ModDelayProcessor"]
    assert _live_sets(tprog, tsegs) == j_live_sets(jprog, jsegs)


def test_rows_lower_their_structure():
    """The structural ints and constants each FX row hands the kernel: the
    EQ's band count, the curve and the DC blocker, the tremolo's polarity,
    the lines' lengths and first records, the DC blocker's pole as float32,
    and the most scratch a row needs."""
    kinds = tuple(k for k in mixer.FX_KINDS if k != "flanger")
    prog = mixer.fx_palette_graph(num_voices=2, device="cpu", kinds=kinds)
    lw = lower_schedule(prog)
    by_type = {}
    for key, row in zip(lw.keys, lw.ops):
        proc = prog._procs[key]
        by_type.setdefault(type(proc).__name__, []).append((proc, row))
    (eq, row), = by_type["ParametricEQProcessor"]
    assert row[OP] == OPS[type(eq)].code and row[AUX0] == 3
    (trem, row), = by_type["TremoloProcessor"]
    assert row[AUX0] == 0
    shapes = [(int(r[AUX0]), int(r[AUX1])) for _, r in by_type["WaveshaperProcessor"]]
    assert shapes == [(tn.waveshaper.SHAPES.index("soft"), 0),
                      (tn.waveshaper.SHAPES.index("fold"), 1)]
    (chorus, row), = by_type["ModDelayProcessor"]
    assert (row[AUX0], row[AUX1]) == (chorus._window, 0) and chorus._window == 1154
    (pitch, row), = by_type["PitchShiftProcessor"]
    assert (row[AUX0], row[AUX1]) == (4096, 2) and lw.echo_channels == 3
    fold = by_type["WaveshaperProcessor"][1][0]
    assert OPS[type(fold)].consts(fold) == (float(np.float32(fold._dc_r)),)
    assert lw.scan_words == scan_words(6, 128) == 128 + 6 * 127
