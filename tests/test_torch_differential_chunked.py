"""The chunked-dispatch fuzzer on the port (the JAX package's
``tests/test_differential_chunked.py``).

``testing.chunked_fuzz`` renders the random graph of ``mixer.fuzz_graph``
(seeds 1000-1003) through the port's streaming processor on the CPU with
``chunk_blocks=4`` and three 512-frame buffers: one dispatch a buffer,
K blocks chained in a loop with per-block clocks, random stream input
where the graph has inputs (deinterleaved, masks derived per block), and a
random param poke between buffers; the naive interpreter renders each
buffer's blocks from a snapshot taken before the processor consumes it.
Held at 2e-5 absolute (the JAX test's tolerance).  On ``JAX_SEEDS`` the
JAX package's chunked stream of the same graph, input and pokes gives the
same buffers, at the same tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import firewheel_tpu as fw
from firewheel_tpu.core.node import BlockInfo as JBlockInfo
from firewheel_tpu.core.node import stream_time_from_sample as j_stream_time
from firewheel_tpu.executor import clear_program_cache, node_key
from firewheel_tpu.processor import ProcessorStatus as JStatus
from firewheel_tpu.testing import interpret_block as j_interpret
from firewheel_tpu_torch import mixer, testing
from test_differential_chunked import poke_random_param
from test_differential_fuzz import build_random_graph

SR, F = 48000, 128
TOL = 2e-5
K = 4
BUFFERS = 3
SEEDS = range(1000, 1004)
#: seeds run through the JAX package's stream too
JAX_SEEDS = (1001, 1002)  # both audible (1000 and 1003 render silence)


@pytest.fixture(autouse=True)
def _fresh_jax_cache():
    clear_program_cache()
    yield
    clear_program_cache()


@pytest.mark.parametrize("seed", SEEDS)
def test_chunked_dispatch_matches_the_interpreter(seed):
    buffers, kinds = testing.chunked_fuzz(seed, K, BUFFERS, device="cpu")
    assert len(buffers) == BUFFERS
    for i, (got, ref) in enumerate(buffers):
        assert got.shape == (2, K * F)
        np.testing.assert_allclose(got, ref, atol=TOL, rtol=0,
                                   err_msg=f"seed={seed} buffer={i} ({kinds})")


def _jax_chunked_stream(seed):
    """The JAX test's chunked stream of ``seed`` → its buffers ``[2, K·F]``,
    each also held against JAX's interpreter."""
    rng = np.random.default_rng(seed)
    holder = {}

    def factory(n_in):
        holder["cx"] = fw.GraphContext(fw.AudioGraphConfig(n_in, 2))
        return holder["cx"].graph

    g, created, edges = build_random_graph(rng, graph_factory=factory)
    cx, n_in = holder["cx"], g.fuzz_num_inputs
    kin = node_key(g.graph_in_node())
    proc = cx.activate(SR, n_in, 2, F, chunk_blocks=K)
    assert cx.update().graph_error is None
    proc.poll_messages()
    procs = {node_key(nid): p for nid, p in proc._processors.items()}
    state = {k: p.init_state() for k, p in procs.items()}
    span, sample, stream = K * F, 0, []
    for _ in range(BUFFERS):
        gi = rng.standard_normal((span, n_in)).astype(np.float32) * 0.3
        params = {k: p.collect_params() for k, p in procs.items()}
        rows = []
        for b in range(K):
            s = sample + b * F
            info = JBlockInfo(j_stream_time(jnp.uint32(s), float(SR)),
                              jnp.asarray(s, jnp.uint32), jnp.asarray(0, jnp.uint32))
            out, _, state = j_interpret(
                created, edges, procs, params, state, jnp.asarray(gi[b * F:(b + 1) * F].T),
                jnp.zeros((n_in,), bool), info, kin)
            rows.append(np.asarray(out))
        out = np.zeros(span * 2, np.float32)
        assert proc.process_interleaved(gi.reshape(-1), out, n_in, 2, span,
                                        sample / SR) == JStatus.OK
        got = out.reshape(span, 2).T
        np.testing.assert_allclose(got, np.concatenate(rows, axis=1), atol=TOL, rtol=0)
        stream.append(got)
        sample += span
        poke_random_param(rng, cx.graph, created)

    def pump():
        if proc.process_interleaved(np.zeros(F * n_in, np.float32),
                                    np.zeros(F * 2, np.float32), n_in, 2, F,
                                    0.0) != JStatus.OK:
            proc.drop()

    cx.deactivate(True, pump=pump)
    return stream


@pytest.mark.parametrize("seed", JAX_SEEDS)
def test_chunked_dispatch_matches_jax(seed):
    port, _ = testing.chunked_fuzz(seed, K, BUFFERS, device="cpu")
    jax_stream = _jax_chunked_stream(seed)
    for i, ((got, _), jgot) in enumerate(zip(port, jax_stream)):
        np.testing.assert_allclose(got, jgot, atol=TOL, rtol=0,
                                   err_msg=f"seed={seed} buffer={i}")
    assert max(float(np.abs(b).max()) for b in jax_stream) > 0.01


def test_poke_is_the_jax_fuzzers():
    """``testing.poke_fuzz_param`` makes the JAX test's draws and sets the
    same setter to the same value."""
    for seed in SEEDS:
        vals = []
        for poke, graph_factory in ((poke_random_param, None),
                                    (testing.poke_fuzz_param, "port")):
            rng = np.random.default_rng(seed)
            if graph_factory is None:
                g, created, _ = build_random_graph(rng)
            else:
                g, created, _ = mixer.fuzz_graph(rng)
            poke(rng, g, created)
            vals.append([sorted((k, v) for k, v in vars(g.node(c[1])).items()
                                if isinstance(v, (int, float, str)))
                         for c in created])
        assert vals[0] == vals[1], seed
