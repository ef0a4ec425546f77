"""The live-edit fuzzer on the port (the JAX package's
``tests/test_differential_edits.py``).

``testing.edit_fuzz`` drives a random graph behind the port's
``GraphContext`` and ``GraphProcessor`` on the CPU through rounds of random
edits (add a palette node, remove one, connect, disconnect, poke a param),
each recompiled by ``update`` and installed by the state-migrating swap,
two blocks a round; the naive interpreter mirrors every edit in its own
records (``testing.GraphEditModel``) and carries its own state across
edits.  Seeds 0-3, 7 rounds each, held at 1e-5 absolute (the JAX test's
tolerance).  On ``JAX_SEEDS`` the same edit sequence through the JAX
package's stack (its ``GraphModel``, ``GraphContext`` and processor) gives
the same stream, at the same tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import firewheel_tpu as fw
from firewheel_tpu.core.node import BlockInfo as JBlockInfo
from firewheel_tpu.core.node import stream_time_from_sample as j_stream_time
from firewheel_tpu.executor import clear_program_cache, node_key
from firewheel_tpu.processor import ProcessorStatus as JStatus
from firewheel_tpu.testing import interpret_block as j_interpret
import firewheel_tpu_torch as ft
from firewheel_tpu_torch import mixer, testing
from firewheel_tpu_torch.convert import as_dicts
from test_differential_edits import OPS as JOPS
from test_differential_edits import GraphModel as JGraphModel

SR, F = 48000, 128
TOL = 1e-5
ROUNDS = 7
#: seeds run through the JAX package's stack too
JAX_SEEDS = (0, 2)  # both audible (seed 1 edits itself silent)


@pytest.fixture(autouse=True)
def _fresh_jax_cache():
    clear_program_cache()
    yield
    clear_program_cache()


@pytest.mark.parametrize("seed", range(4))
def test_live_edits_match_the_interpreter(seed):
    blocks = testing.edit_fuzz(seed, ROUNDS, device="cpu")
    assert len(blocks) == 2 * (ROUNDS + 1)
    for tag, out, ref, _ in blocks:
        np.testing.assert_allclose(out, ref, atol=TOL, rtol=0,
                                   err_msg=f"seed={seed} {tag}")


def test_the_edit_model_is_the_jax_models():
    """The port's model and the JAX test's make the same records from the
    same draws, round by round."""
    for seed in range(4):
        models, rngs = [], []
        for m in (JGraphModel(fw.AudioGraph()), testing.GraphEditModel(ft.AudioGraph())):
            rng = np.random.default_rng(seed)
            for _ in range(int(rng.integers(2, 5))):
                m.add(rng)
            m.connect(rng)
            m.connect(rng)
            models.append(m)
            rngs.append(rng)
        jm, tm = models
        for rnd in range(ROUNDS):
            for _ in range(int(rngs[0].integers(1, 3))):
                op = JOPS[int(rngs[0].integers(len(JOPS)))]
                getattr(jm, {"param": "poke_param"}.get(op, op))(rngs[0])
            tm.edit(rngs[1])
            assert [r[0] for r in jm.interp_created()] == \
                [r[0] for r in tm.interp_created()], (seed, rnd)
            assert jm.interp_edges() == tm.interp_edges(), (seed, rnd)
            for jr, tr in zip(jm.created, tm.created):
                assert type(jr["node"]).__name__ == type(tr["node"]).__name__
                jp = jr["node"].activate(SR, F, jr["n_in"], jr["n_out"]).collect_params()
                tp = tr["node"].activate(SR, F, tr["n_in"], tr["n_out"]).collect_params()
                la = [np.asarray(x) for x in jax.tree.leaves(jp)]
                lb = [np.asarray(x) for x in jax.tree.leaves(as_dicts(tp))]
                assert len(la) == len(lb), (seed, rnd)
                for x, y in zip(la, lb):
                    np.testing.assert_array_equal(x, y, err_msg=f"seed={seed} {rnd}")
        assert rngs[0].random() == rngs[1].random()


def _jax_edit_stream(seed):
    """The JAX package's ``run_edit_differential`` sequence → its stream a
    block (interleaved), each also held against JAX's interpreter."""
    rng = np.random.default_rng(seed)
    cx = fw.GraphContext()
    model = JGraphModel(cx.graph)
    kin = node_key(cx.graph.graph_in_node())
    for _ in range(int(rng.integers(2, 5))):
        model.add(rng)
    model.connect(rng)
    model.connect(rng)
    proc = cx.activate(SR, 0, 2, F)
    assert cx.update().graph_error is None
    state, sample, stream = {}, 0, []

    def render():
        nonlocal sample
        out = np.zeros(F * 2, np.float32)
        assert proc.process_interleaved(np.zeros(0, np.float32), out, 0, 2, F,
                                        sample / SR) == JStatus.OK
        procs = {node_key(nid): p for nid, p in proc._processors.items()}
        live = {r["key"] for r in model.created}
        for k in [k for k in state if k not in live]:
            del state[k]
        for r in model.created:
            state.setdefault(r["key"], procs[r["key"]].init_state())
        info = JBlockInfo(j_stream_time(jnp.uint32(sample), float(SR)),
                          jnp.asarray(sample, jnp.uint32), jnp.asarray(0, jnp.uint32))
        rows, _, new = j_interpret(
            model.interp_created(), model.interp_edges(), procs,
            {k: p.collect_params() for k, p in procs.items()}, state,
            jnp.zeros((0, F), jnp.float32), jnp.zeros((0,), bool), info, kin)
        state.clear()
        state.update(new)
        ref = np.zeros(F * 2, np.float32)
        ref[0::2], ref[1::2] = np.asarray(rows[0]), np.asarray(rows[1])
        np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)
        stream.append(out)
        sample += F

    for _ in range(2):
        render()
    for _ in range(ROUNDS):
        for _ in range(int(rng.integers(1, 3))):
            op = JOPS[int(rng.integers(len(JOPS)))]
            getattr(model, {"param": "poke_param"}.get(op, op))(rng)
        assert cx.update().graph_error is None
        for _ in range(2):
            render()

    def pump():
        if proc.process_interleaved(np.zeros(0, np.float32), np.zeros(F * 2, np.float32),
                                    0, 2, F, 0.0) != JStatus.OK:
            proc.drop()

    cx.deactivate(True, pump=pump)
    return stream


@pytest.mark.parametrize("seed", JAX_SEEDS)
def test_live_edits_match_jax(seed):
    port = testing.edit_fuzz(seed, ROUNDS, device="cpu")
    jax_stream = _jax_edit_stream(seed)
    assert len(port) == len(jax_stream)
    for (tag, out, _, _), jout in zip(port, jax_stream):
        np.testing.assert_allclose(out, jout, atol=TOL, rtol=0,
                                   err_msg=f"seed={seed} {tag}")
    assert max(float(np.abs(o).max()) for o in jax_stream) > 0.01


def test_palette_is_the_jax_fuzzers():
    """The edit model draws from ``mixer.FUZZ_PALETTE``, the same kinds in
    the same order as the JAX fuzzer's ``PALETTE``."""
    from test_differential_fuzz import PALETTE

    assert [name for name, _ in mixer.FUZZ_PALETTE] == [name for name, _ in PALETTE]
