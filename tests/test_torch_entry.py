"""The port's entry point (``firewheel_tpu_torch/entry.py``) on the CPU
beside the JAX package's (``__graft_entry__.py``):

* ``entry(device="cpu")``'s chunk (the batched 64-node mixer, K=4 blocks
  for B=2 instances) against ``__graft_entry__.entry()``'s on the same
  params and state (through ``convert.py``): outputs and float state within
  1e-6, masks and the rest equal; the same for ``chunk_step`` on the
  mixer built with ``strip_masks`` (audio and state only: the masks carry
  no meaning) and with ``state_light``;
* the dry run's unsharded step against the same step built from the JAX
  package's ``render_fn`` (``_dryrun_impl``'s ``make_step(None)``), each
  voice its own frequency and pan, at 1e-6;
* ``dryrun_multichip`` on one and on four gloo ranks (dp=2 × vp=2),
  started from a fresh process, each rank's rows against the unsharded
  step at 1e-5, and in place in a process group of one;
* without a card the entry points raise, and never fall back to the CPU.
"""

import datetime
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import __graft_entry__ as graft
import firewheel_tpu as fw
from firewheel_tpu.core.node import BlockInfo as JBlockInfo
from firewheel_tpu.parallel import BatchRenderer as JBatchRenderer
from firewheel_tpu_torch import entry as te
from firewheel_tpu_torch.convert import params_from_jax, state_from_jax, state_to_numpy
from test_torch_stream import _normalize, assert_trees_close

TOL = 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OK_LINES = ("dryrun_multichip OK: mesh dp={dp} vp={vp}",
            "BatchRenderer OK: dp={n}, sharded == unsharded",
            "VoiceParallelMixer OK: vp={n}, all_reduce mixdown == unsharded",
            "SessionServer OK: dp={n}, capacity {b}")


def port_entry(**graph):
    """``entry(device="cpu")``, or its step on the mixer built with
    ``strip_masks``/``state_light``."""
    if not graph:
        return te.entry(device="cpu")
    return te.chunk_step(te._mixer_graph(device="cpu", **graph))


def jax_entry(**graph):
    """``__graft_entry__.entry()``, or its steps on the mixer built with
    ``strip_masks``/``state_light``."""
    if not graph:
        return graft.entry()
    program = graft._mixer_graph(**graph)
    br = JBatchRenderer(program, batch=te.BATCH)
    fn = jax.vmap(program.chunk_fn(te.BLOCKS), in_axes=(0, 0, 0, 0, None, None))
    return fn, (br.stack_params(), br.init_state(),
                jnp.zeros((te.BATCH, te.BLOCKS, 0, te.BLOCK), jnp.float32),
                jnp.ones((te.BATCH, te.BLOCKS, 0), bool),
                jnp.zeros((), jnp.uint32), jnp.zeros((), jnp.uint32))


def _equal_trees(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _equal_trees(a[k], b[k])
        else:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("graph", [{}, {"strip_masks": True}, {"state_light": True}],
                         ids=["mixer", "strip_masks", "state_light"])
def test_entry_matches_jax(graph):
    jfn, jargs = jax_entry(**graph)
    jout, jmask, jstate = jfn(*jargs)
    fn, args = port_entry(**graph)
    assert len(args) == len(jargs) == 6
    # the same graph, params and state: the node keys are JAX's
    params, state = params_from_jax(jargs[0], "cpu"), state_from_jax(jargs[1], "cpu")
    _equal_trees(args[0], params)
    _equal_trees(args[1], state)
    assert args[2].shape == jargs[2].shape == (2, 4, 0, 128)
    assert args[3].shape == jargs[3].shape and args[3].dtype == torch.bool
    assert args[4].dtype == args[5].dtype == torch.int64
    out, mask, new_state = fn(params, state, *args[2:])
    assert out.shape == (2, 4, 2, 128) and float(out.abs().max()) > 0.01
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=TOL, rtol=0)
    if graph.get("strip_masks"):
        assert not mask.any()  # every flag the not-silent constant
    else:
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert_trees_close(state_to_numpy(new_state), _normalize(jstate))


def test_strip_masks_keeps_the_audio():
    """The ablation changes no sample of the chunk, only its masks."""
    fn, args = port_entry()
    sfn, sargs = port_entry(strip_masks=True)
    out, _, st = fn(*args)
    sout, _, sst = sfn(*sargs)
    assert torch.equal(out, sout)
    _equal_trees(st, sst)


def jax_dryrun_step(vprog, mprog, k_blocks):
    """``__graft_entry__._dryrun_impl``'s ``make_step(None)``: per instance,
    each block's voices through ``render_fn`` under ``vmap``, summed, then
    the master; ``lax.scan`` over the blocks → ``outs [K, B, ch, F]``."""
    block = vprog.max_block_frames

    def step(vparams, vstate, mparams, mstate, start_sample):
        def one_block(carry, _):
            vstate, mstate, sample = carry
            info = JBlockInfo(stream_time_secs=sample.astype(jnp.float32) / te.SR,
                              stream_sample=sample,
                              stream_status=jnp.zeros((), jnp.uint32))

            def per_instance(vp_, vs_, mp_, ms_):
                def one_voice(p, s):
                    out, _, s2 = vprog.render_fn(p, s, jnp.zeros((0, block), jnp.float32),
                                                 jnp.zeros((0,), bool), info)
                    return out, s2

                outs, vs2 = jax.vmap(one_voice)(vp_, vs_)
                mout, _, ms2 = mprog.render_fn(mp_, ms_, jnp.sum(outs, axis=0),
                                               jnp.zeros((2,), bool), info)
                return mout, vs2, ms2

            mout, vstate, mstate = jax.vmap(per_instance)(vparams, vstate, mparams, mstate)
            return (vstate, mstate, sample + jnp.uint32(block)), mout

        (vstate, mstate, _), outs = jax.lax.scan(
            one_block, (vstate, mstate, start_sample), None, length=k_blocks)
        return outs, vstate, mstate

    return step


def _jax_programs():
    def compile_(g):
        pkg = g.compile(te.SR, te.DRYRUN_BLOCK)
        return fw.ScheduleProgram(pkg.schedule, dict(pkg.new_node_processors), te.SR)

    g = fw.AudioGraph(fw.AudioGraphConfig(0, 2))
    voice = te.add_dryrun_voice(g, nodes=fw.nodes)
    vprog = compile_(g)
    g = fw.AudioGraph(fw.AudioGraphConfig(num_graph_inputs=2, num_graph_outputs=2))
    te.add_dryrun_master(g, nodes=fw.nodes)
    return vprog, compile_(g), voice


def test_dryrun_step_matches_jax():
    """The unsharded 2-D step at dp=2 × vp=2's shapes (B=4, V=4)."""
    b, v, k = 4, 4, te.DRYRUN_BLOCKS

    def stacked(snaps, shape):
        return jax.tree.map(lambda *xs: np.stack(xs).reshape(shape + np.shape(xs[0])),
                            *snaps)

    jv, jm, jvoice = _jax_programs()
    jvp = stacked(te.dryrun_snapshots(jv, jvoice, b * v), (b, v))
    jvs = stacked([jax.tree.map(np.asarray, jv.init_state())] * (b * v), (b, v))
    jmp = stacked([jm.collect_params()] * b, (b,))
    jms = stacked([jax.tree.map(np.asarray, jm.init_state())] * b, (b,))
    jout, jvs2, jms2 = jax.jit(jax_dryrun_step(jv, jm, k))(
        jvp, jvs, jmp, jms, jnp.zeros((), jnp.uint32))

    tv, tm, _ = te.dryrun_programs("cpu")
    out, vs2, ms2 = te.make_step(tv, tm, k)(
        params_from_jax(jvp, "cpu"), state_from_jax(jvs, "cpu"),
        params_from_jax(jmp, "cpu"), state_from_jax(jms, "cpu"), 0)
    assert out.shape == (b, k, 2, te.DRYRUN_BLOCK) and float(out.abs().max()) > 0.01
    np.testing.assert_allclose(out.numpy(), np.asarray(jout).transpose(1, 0, 2, 3),
                               atol=TOL, rtol=0)
    assert_trees_close(state_to_numpy(vs2), _normalize(jvs2))
    assert_trees_close(state_to_numpy(ms2), _normalize(jms2))
    # every voice its own: instances differ, and so do a voice's two halves
    o = out.numpy()
    assert all(np.abs(o[i] - o[0]).max() > 1e-3 for i in range(1, b))


def run_dryrun(n: int) -> tuple:
    """``dryrun_multichip(n, device="cpu")`` from a fresh process, as a
    user's script calls it (not from this test process, whose JAX runtime
    holds threads) → ``(each rank's numbers, everything printed)``; a rank
    that hangs fails it within 2 minutes."""
    code = ("import json\n"
            "from firewheel_tpu_torch import entry as te\n"
            "te.RANK_TIMEOUT = 60\n"
            f"got = te.dryrun_multichip({n}, device='cpu')\n"
            "print('RESULT', json.dumps(got), flush=True)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    line = next(x for x in proc.stdout.splitlines() if x.startswith("RESULT "))
    return json.loads(line[len("RESULT "):]), proc.stdout


@pytest.mark.parametrize("n", [1, 4])
def test_dryrun_multichip_on_gloo_ranks(n):
    got, printed = run_dryrun(n)
    vp = 2 if n % 2 == 0 else 1
    for line in OK_LINES:
        assert line.format(dp=n // vp, vp=vp, n=n, b=2 * n) in printed, printed
    assert [r["rank"] for r in got] == list(range(n))
    for r in got:
        assert r["backend"] == "gloo" and r["device"] == "cpu"
        assert r["step_err"] <= te.STEP_TOL and r["batch_err"] <= te.BATCH_TOL
        assert r["mix_err"] <= te.STEP_TOL and r["collectives"] == 1
        assert r["step_k7"] == 0  # the CPU runs K7's plain version
        assert f"dryrun_multichip rank {r['rank']} of {n}: backend gloo, device cpu" in printed
    # the 2-D layout: rank r at (r // vp, r % vp) of the dp × vp mesh
    rows = {tuple(r["rows"]) for r in got}
    assert len(rows) == n // vp and all(r["voices"][1] - r["voices"][0] == 2 for r in got)


def test_dryrun_multichip_in_place(capfd):
    """A process that has joined a group of ``n`` ranks runs its rank in
    place; another ``n`` is refused."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=1,
                            rank=0, timeout=datetime.timedelta(seconds=60))
    try:
        with pytest.raises(ValueError, match="1 ranks, not 2"):
            te.dryrun_multichip(2, device="cpu")
        (got,) = te.dryrun_multichip(1, device="cpu")
    finally:
        dist.destroy_process_group()
    assert got["step_err"] <= te.STEP_TOL and got["rows"] == [0, 2]
    assert "SessionServer OK: dp=1, capacity 2" in capfd.readouterr().out


@pytest.mark.parametrize("call", [
    lambda: te.entry(),
    lambda: te.dryrun_multichip(1),
    lambda: te._main(["2"]),
], ids=["entry", "dryrun_multichip", "main"])
def test_entry_points_need_the_card(call, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
