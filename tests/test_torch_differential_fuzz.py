"""The differential fuzzer on the port: random DAGs over the JAX fuzzer's
whole node palette, compiled by the port and rendered by each of its
executors, against the port's naive interpreter and the JAX package.

``mixer.fuzz_graph`` is the port's copy of ``build_random_graph``
(``tests/test_differential_fuzz.py``): it draws from the rng in the same
order, so a seed gives the same graph in either package.  Each graph is
rendered

* by ``ScheduleProgram.render_block`` over 5 blocks (topological order,
  buffer allocation and aliasing, node pooling, mask threading, graph-out
  zeroing) against ``testing.interpret_block``, which walks the builder's
  own records with one buffer a (node, port): 1e-5 absolute, masks equal,
  the JAX test's tolerance;
* on ``JAX_SEEDS`` against the JAX package's ``render_block`` of the same
  graph, the port starting from JAX's params and initial state carried by
  ``convert.py``: 1e-5, masks equal;
* batched at B=2 with instance 1's own params (``fuzz_instance_params``)
  and random stream input, two chunks of K=4: ``MegaRenderer`` where the
  program ``supports_megakernel`` and ``BatchRenderer(lowering="hybrid")``
  on every seed (on the CPU: K2's and K3's plain versions,
  ``mega_chunk_reference`` and ``island_chunk_reference``) against the
  eager ``BatchRenderer`` (``chunk_fn``) from the same params and state:
  bit for bit (``torch.equal``) on outputs, masks and every state leaf, as
  ``test_torch_megakernel.py`` and ``test_torch_hybrid.py`` hold the
  lowerings against eager.

The fuzz found one divergence: K2's and K3's row for a filter ran K1's
sequential recurrence whatever the filter's backend, while eager runs the
``"auto"`` filter's associative scan; at B=16 with rows 0-7 on their own
params (seed 8, a 233 Hz filter) the two states parted by 2.6e-5.  The
``"auto"`` filter now lowers to the EQ's row of one band, which runs K7's
scan as eager does (``executor_mega.op_for``);
``test_auto_filter_lowers_to_the_scan`` pins it.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import firewheel_tpu as fw
from firewheel_tpu import nodes as jn
import firewheel_tpu_torch as ft
from firewheel_tpu_torch import mixer
from firewheel_tpu_torch.convert import params_from_jax, state_from_jax
from firewheel_tpu_torch.core.node import BlockInfo
from firewheel_tpu_torch.executor import node_key
from firewheel_tpu_torch.executor_hybrid import HybridMegaRenderer
from firewheel_tpu_torch.executor_mega import (
    OPS, MegaRenderer, op_for, supports_megakernel,
)
from firewheel_tpu_torch.nodes.eq import ParametricEQProcessor
from firewheel_tpu_torch.nodes.filter import FilterProcessor
from firewheel_tpu_torch.testing import interpret_block
from test_differential_fuzz import build_random_graph

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR, F = 48000, 128
BLOCKS = 5
TOL = 1e-5
SEEDS = range(12)
#: the chunked fuzzer's seeds (``tests/test_differential_chunked.py``)
CHUNKED_SEEDS = range(1000, 1004)
#: seeds held against the JAX package's render: 0 (stream inputs, white
#: noise, the EQ, delay compensators of 69, 108 and 165 frames, a
#: waveshaper), 1 (white noise, an echo, a tremolo), 4 (stream inputs, both
#: channel adapters, stereo width, a delay compensator of 226 frames, a
#: filter) and 7 (stream inputs, pink noise, a volume, stereo width, two
#: tremolos)
JAX_SEEDS = (0, 1, 4, 7)
B, K, CHUNKS = 2, 4, 2


def _records(created):
    return [(k, n_in, n_out) for k, _, n_in, n_out in created]


def _compile(g, device="cpu"):
    pkg = g.compile(SR, F)
    prog = ft.ScheduleProgram(pkg.schedule, dict(pkg.new_node_processors), SR,
                              device=device)
    return prog, {node_key(nid): p for nid, p in pkg.new_node_processors}


def _graph(seed):
    """``(graph, created, edges)`` of a seed, the pooling-heavy graph for
    ``"pooling"``."""
    if seed == "pooling":
        return mixer.fuzz_pooling_graph()
    return mixer.fuzz_graph(np.random.default_rng(seed))


def _kinds(procs):
    return {type(p).__name__ for p in procs.values()}


def _jax_graph(n_in):
    return fw.AudioGraph(fw.AudioGraphConfig(n_in, 2))


@pytest.mark.parametrize("seed", list(SEEDS) + list(CHUNKED_SEEDS))
def test_fuzz_graph_draws_as_the_jax_fuzzer(seed):
    """The same node kinds, keys, port counts, params and edges as
    ``build_random_graph`` for the same seed, and the same rng position
    after it; built with the JAX package's nodes, the same graph."""
    j_rng, t_rng, x_rng = (np.random.default_rng(seed) for _ in range(3))
    jg, jc, je = build_random_graph(j_rng)
    tg, tc, te = mixer.fuzz_graph(t_rng)
    xg, xc, xe = mixer.fuzz_graph(x_rng, graph_factory=_jax_graph, nodes=jn)
    assert _records(tc) == _records(jc) == _records(xc)
    assert te == je == xe
    assert j_rng.random() == t_rng.random() == x_rng.random()
    assert (tg.node_info(tg.graph_in_node()).num_outputs
            == jg.fuzz_num_inputs == xg.node_info(xg.graph_in_node()).num_outputs)
    for (_, jid, *_), (_, tid, *_), (_, xid, *_) in zip(jc, tc, xc):
        jnode, tnode, xnode = jg.node(jid), tg.node(tid), xg.node(xid)
        assert type(jnode).__name__ == type(tnode).__name__ == type(xnode).__name__
        jp = jnode.activate(SR, F, 2, 2).collect_params()
        tp = tnode.activate(SR, F, 2, 2).collect_params()
        xp = xnode.activate(SR, F, 2, 2).collect_params()
        flat = lambda t: jax.tree.map(np.asarray, jax.tree.leaves(t))  # noqa: E731
        for a, b, c in zip(flat(jp), flat(ft.convert.as_dicts(tp)), flat(xp)):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)


def _render_against_interpreter(seed):
    g, created, edges = _graph(seed)
    prog, procs = _compile(g)
    n_in = prog.num_graph_inputs
    kin = node_key(g.graph_in_node())
    rng = np.random.default_rng(10_000 + (0 if seed == "pooling" else seed))
    params = prog.collect_params()
    exec_state, interp_state = prog.init_state(), prog.init_state()
    for blk in range(BLOCKS):
        gi = torch.from_numpy(rng.standard_normal((n_in, F)).astype(np.float32) * 0.3)
        im = torch.from_numpy(rng.random(n_in) < 0.25)
        info = BlockInfo.make(stream_time_secs=blk * F / SR, stream_sample=blk * F)
        out_e, om_e, exec_state = prog.render_block(params, exec_state, gi, im, info)
        out_i, om_i, interp_state = interpret_block(
            created, edges, procs, params_from_jax(params, "cpu"), interp_state,
            gi, im, info, kin)
        np.testing.assert_allclose(
            out_e.numpy(), out_i.numpy(), atol=TOL, rtol=0,
            err_msg=f"seed={seed} block={blk} graph={[c[0] for c in created]} "
                    f"edges={edges}")
        np.testing.assert_array_equal(om_e.numpy(), om_i,
                                      err_msg=f"seed={seed} block={blk}: masks")
    return procs


@pytest.mark.parametrize("seed", SEEDS)
def test_render_block_matches_the_interpreter(seed):
    _render_against_interpreter(seed)


def test_pooling_heavy_matches_the_interpreter():
    """Six identical voices pool into large groups in the executor's plan;
    the interpreter never pools."""
    g, _, _ = _graph("pooling")
    prog, _ = _compile(g)
    assert max(len(m) for _, m in prog._plan) >= 6
    _render_against_interpreter("pooling")


def test_palette_covers_every_entry_somewhere():
    """The 12 seeds exercise most of the palette (the JAX test's guard
    against an rng change shrinking coverage), the kinds this slice brings
    to the card among them, and stream inputs."""
    names, inputs = set(), 0
    for seed in SEEDS:
        g, _, _ = _graph(seed)
        _, procs = _compile(g)
        names |= _kinds(procs)
        inputs += g.node_info(g.graph_in_node()).num_outputs > 0
    assert len(names) >= 8, f"only {sorted(names)} exercised"
    assert {"NoiseProcessor", "ParametricEQProcessor", "DelayCompProcessor",
            "TremoloProcessor", "StereoWidthProcessor", "MonoToStereoProcessor",
            "StereoToMonoProcessor", "WaveshaperProcessor"} <= names
    assert inputs >= 4


@pytest.mark.parametrize("seed", JAX_SEEDS)
def test_render_block_matches_jax(seed):
    """The port's ``render_block`` of a seed's graph equals the JAX
    package's, from JAX's params and initial state carried by ``convert``."""
    rng = np.random.default_rng(seed)
    jg, _, _ = mixer.fuzz_graph(np.random.default_rng(seed), graph_factory=_jax_graph,
                                nodes=jn)
    g, _, _ = mixer.fuzz_graph(rng)
    prog, procs = _compile(g)
    jpkg = jg.compile(SR, F)
    jprog = fw.ScheduleProgram(jpkg.schedule, dict(jpkg.new_node_processors), SR)
    jparams, jstate = jprog.collect_params(), jprog.init_state()
    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    state = state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
    n_in = prog.num_graph_inputs
    for blk in range(BLOCKS):
        gi = rng.standard_normal((n_in, F)).astype(np.float32) * 0.3
        im = rng.random(n_in) < 0.25
        jo, jm, jstate = jprog.render_block(
            jparams, jstate, jnp.asarray(gi), jnp.asarray(im),
            fw.BlockInfo.make(stream_time_secs=blk * F / SR, stream_sample=blk * F))
        to, tm, state = prog.render_block(
            params, state, torch.from_numpy(gi), torch.from_numpy(im),
            BlockInfo.make(stream_time_secs=blk * F / SR, stream_sample=blk * F))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=TOL, rtol=0,
                                   err_msg=f"seed={seed} block={blk}")
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def _assert_equal_trees(a, b, path=()):
    assert a.keys() == b.keys(), path
    for k in a:
        if isinstance(a[k], dict):
            _assert_equal_trees(a[k], b[k], path + (k,))
        else:
            assert torch.equal(a[k], b[k]), (path + (k,),
                                             float((a[k] - b[k]).abs().max()))


def _lowerings_against_eager(seed, batch, varied):
    """K2's plain version (where eligible) and the hybrid's against eager
    ``chunk_fn``, rows ``0..varied-1`` on their own params: bit for bit."""
    g, created, _ = _graph(seed)
    prog, _ = _compile(g)
    eager = ft.BatchRenderer(prog, batch, device="cpu")
    lowerings = {"hybrid": ft.BatchRenderer(prog, batch, device="cpu", lowering="hybrid")}
    if supports_megakernel(prog):
        lowerings["mega"] = MegaRenderer(prog, batch, K, device="cpu")
    params, init = eager.stack_params(), eager.init_state()
    draw = 0 if seed == "pooling" else seed
    for row in range(varied):
        eager.update_instance(params, row, mixer.fuzz_instance_params(
            prog, g, created, draw, row))
    states = {name: init for name in ("eager", *lowerings)}
    gen = np.random.default_rng(20_000 + draw)
    ni = prog.num_graph_inputs
    for c in range(CHUNKS):
        gi = torch.from_numpy(
            gen.standard_normal((batch, K, ni, F)).astype(np.float32) * 0.3)
        im = torch.from_numpy(gen.random((batch, K, ni)) < 0.25)
        gi = gi.masked_fill(im[..., None], 0.0)
        eo, em, states["eager"] = eager.render_chunk(
            params, states["eager"], gi, im, start_sample=c * K * F, num_blocks=K)
        for name, r in lowerings.items():
            if name == "mega":
                o, m, states[name] = r.render_chunk(params, states[name], c * K * F)
            else:
                o, m, states[name] = r.render_chunk(params, states[name], gi, im,
                                                    start_sample=c * K * F, num_blocks=K)
            assert torch.equal(m, em), (seed, name, c)
            assert torch.equal(o, eo), (seed, name, c, float((o - eo).abs().max()))
            _assert_equal_trees(states[name], states["eager"], (seed, name))
    return prog, eo


@pytest.mark.parametrize("seed", list(SEEDS) + ["pooling"])
def test_lowerings_match_eager(seed):
    """At B=2, instance 1 on its own params."""
    _, eo = _lowerings_against_eager(seed, B, 2)
    assert not torch.equal(eo[0], eo[1]) or float(eo.abs().max()) == 0.0


@pytest.mark.parametrize("seed", [2, 8])
def test_auto_filter_lowers_to_the_scan(seed):
    """The graphs with a filter, at B=16 with rows 0-7 on their own params
    (the card's 18(a) in small): the ``"auto"`` filter's row is the EQ's
    device function with one band, and K2/K3 equal eager bit for bit."""
    prog, _ = _lowerings_against_eager(seed, 16, 8)
    filters = [p for p in prog._procs.values() if isinstance(p, FilterProcessor)]
    assert filters and all(op_for(p).code == OPS[ParametricEQProcessor].code
                           and op_for(p).aux(p) == (1, 0) for p in filters)
    lowered = HybridMegaRenderer(prog, 1, K, device="cpu").islands.values()
    assert OPS[FilterProcessor].code not in {int(c) for lw in lowered for c in lw.ops[:, 0]}


def test_k2_eligibility_of_the_seeds():
    """Graphs with noise (no K2 device function) or stream inputs go to the
    hybrid only; of seeds 0-11, 6, 9 and 11 and the pooling graph are K2's."""
    eligible = []
    for seed in list(SEEDS) + ["pooling"]:
        g, _, _ = _graph(seed)
        prog, procs = _compile(g)
        ok = supports_megakernel(prog)
        if "NoiseProcessor" in _kinds(procs) or prog.num_graph_inputs:
            assert not ok, seed
        if ok:
            eligible.append(seed)
    assert eligible == [6, 9, 11, "pooling"]


def test_fuzzers_import_no_jax():
    """The fuzz builders and the edit and chunked streams run without JAX."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from firewheel_tpu_torch import mixer, testing\n"
        "g, c, e = mixer.fuzz_graph(np.random.default_rng(0))\n"
        "mixer.fuzz_pooling_graph()\n"
        "testing.edit_fuzz(0, rounds=1, device='cpu')\n"
        "testing.chunked_fuzz(1000, buffers=1, device='cpu')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('firewheel_tpu.') or m == 'firewheel_tpu']\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
