"""Testing utilities for node authors and framework validation.

PyTorch port of ``firewheel_tpu/testing.py``.  The reference's extension
story is custom audio nodes; its validation story is inline unit tests
against hand-built graphs (``graph/compiler/schedule.rs:392-711``).  This
module ships both:

* :func:`validate_node` — a contract harness for third-party
  :class:`~firewheel_tpu_torch.core.node.AudioNode` implementations.  It
  exercises every way the port's executor calls a kernel — one eager call,
  K blocks chained as the K-block loop of a dispatch chains them, a
  leading batch dimension (instance batching and node pooling) and partial
  blocks — on ``device``, and fails with a named check the moment a kernel
  breaks a rule the executor relies on.

* :class:`NaiveGraphRenderer` — a slow, obviously-correct reference
  renderer: walks the graph's own wiring records in its own Kahn order
  with one dedicated buffer per (node, port) and eager per-node kernel
  calls.  It shares NO machinery with the compiled path (no buffer
  allocator, no pooling, no K-block loop), which makes it the differential
  oracle to hold the executor against, and a debugging aid: render the
  same graph both ways and diff per block.

* :func:`interpret_block` — the functional core of the naive renderer,
  for callers that keep their own wiring records.

* :func:`edit_fuzz` and :func:`chunked_fuzz` — the JAX package's live-edit
  and chunked-dispatch fuzzers (``tests/test_differential_{edits,
  chunked}.py``) on the port's streaming engine: random graphs of
  :func:`~firewheel_tpu_torch.mixer.fuzz_graph`'s palette streamed on any
  device beside :func:`interpret_block` on another, the edits mirrored in a
  :class:`GraphEditModel`.
"""

from __future__ import annotations

from typing import Any, Iterable, Mapping

import numpy as np
import torch

from . import nodes as _NODES
from .context import GraphContext, UpdateStatus
from .convert import params_from_jax, tree_map
from .core.node import (
    AudioNode, BlockInfo, NodeProcessor, stream_time_from_sample,
)
from .device import DEFAULT_DEVICE, resolve_device
from .executor import node_key
from .graph import AudioGraphConfig
from .mixer import FUZZ_PALETTE, FUZZ_POKES, fuzz_graph
from .processor import ProcessorStatus

__all__ = [
    "GraphEditModel",
    "NodeContractError",
    "chunked_fuzz",
    "edit_fuzz",
    "interpret_block",
    "NaiveGraphRenderer",
    "poke_fuzz_param",
    "validate_node",
]


class NodeContractError(AssertionError):
    """A custom node violated the kernel contract; ``check`` names the
    failing stage (see :func:`validate_node`)."""

    def __init__(self, check: str, message: str):
        super().__init__(f"[{check}] {message}")
        self.check = check


# ---------------------------------------------------------------------------
# The naive interpreter
# ---------------------------------------------------------------------------

def interpret_block(
    created: Iterable[tuple],
    edges: Mapping[tuple, tuple],
    procs: Mapping[str, NodeProcessor],
    params: Mapping[str, Any],
    state: Mapping[str, Any],
    graph_in: torch.Tensor,
    in_mask: torch.Tensor,
    info: BlockInfo,
    graph_in_key: str,
    num_graph_outputs: int = 2,
):
    """Render ONE block by walking ``created`` in the given order.

    ``created``: node records in a valid topological order — tuples whose
    FIRST element is the node key and LAST TWO are ``(n_in, n_out)``.
    ``edges``: ``{(dst_key, dst_port) | ("out", out_port): (src_key,
    src_port)}`` — at most one source per input port, as the graph
    contract says.  ``params``: dicts of tensors on ``graph_in``'s device.
    Unconnected inputs read cleared+silent; unconnected graph outputs are
    silent; flagged graph-out channels read zero (schedule.rs:255-313).

    ``graph_in f32[Ni, F]``, ``in_mask bool[Ni]``.  Returns ``(out
    f32[num_graph_outputs, F], out_flags bool[num_graph_outputs] (numpy),
    new_state)``.
    """
    frames = graph_in.shape[-1]
    row = {(graph_in_key, p): graph_in[p] for p in range(graph_in.shape[0])}
    flag = {(graph_in_key, p): bool(in_mask[p]) for p in range(graph_in.shape[0])}
    zeros = graph_in.new_zeros((frames,))
    new_state = dict(state)

    for rec in created:
        k, n_in, n_out = rec[0], rec[-2], rec[-1]
        if k not in params:
            continue  # not activated/scheduled (e.g. dormancy-pruned)
        rows, fl = [], []
        for port in range(n_in):
            src = edges.get((k, port))
            rows.append(zeros if src is None else row[src])
            fl.append(True if src is None else flag[src])
        inputs = torch.stack(rows) if rows else graph_in.new_zeros((0, frames))
        mask = torch.tensor(fl, dtype=torch.bool, device=graph_in.device)
        outs, st, om = procs[k].kernel(params[k], state[k], inputs, mask, info)
        new_state[k] = st
        om = om.cpu().numpy()
        for p in range(n_out):
            row[(k, p)] = outs[p]
            flag[(k, p)] = bool(om[p])

    out_rows, out_flags = [], []
    for port in range(num_graph_outputs):
        src = edges.get(("out", port))
        if src is None:
            out_rows.append(zeros)
            out_flags.append(True)
        else:
            r, f = row[src], flag[src]
            out_rows.append(torch.zeros_like(r) if f else r)
            out_flags.append(f)
    out = torch.stack(out_rows) if out_rows else graph_in.new_zeros((0, frames))
    return out, np.array(out_flags, dtype=bool), new_state


class NaiveGraphRenderer:
    """Reference renderer over an :class:`AudioGraph`: eager, per-node,
    no compiled machinery.  Typical uses::

        ref = NaiveGraphRenderer(graph, 48000, 128, device="cpu")
        out, mask = ref.render_block(graph_in, in_mask)

    Compare against the compiled path to localize a bug, or use it as the
    golden side of a custom-node integration test.  O(nodes) kernel calls
    a block, one buffer a port; never use it for actual rendering.

    ``processors``: pass the compile's activated processors
    (``{NodeID: proc}``) to share live params with a running engine;
    defaults to activating a fresh set from the graph's nodes.  ``device``:
    where state, params and buffers live (the card unless the caller asks
    for the CPU).
    """

    def __init__(
        self,
        graph,
        sample_rate: int,
        max_block_frames: int,
        processors: Mapping | None = None,
        device: str | torch.device = DEFAULT_DEVICE,
    ):
        self.graph = graph
        self.sample_rate = int(sample_rate)
        self.max_block_frames = int(max_block_frames)
        self.device = resolve_device(device)
        gin, gout = graph.graph_in_node(), graph.graph_out_node()
        self._gin_key = node_key(gin)

        entries = {e.id: e for e in graph.nodes()}
        self.num_graph_inputs = entries[gin].num_outputs
        self.num_graph_outputs = entries[gout].num_inputs

        # Own wiring records + own Kahn order (independent of the
        # compiler's topo sort).
        self._edges = {}
        indeg = {nid: 0 for nid in entries}
        adj = {nid: [] for nid in entries}
        for e in graph.edges():
            dst = (
                ("out", e.dst_port)
                if e.dst_node == gout
                else (node_key(e.dst_node), e.dst_port)
            )
            self._edges[dst] = (node_key(e.src_node), e.src_port)
            indeg[e.dst_node] += 1
            adj[e.src_node].append(e.dst_node)
        slot = lambda n: (n.idx.slot, n.idx.generation)  # noqa: E731
        ready = sorted((nid for nid, d in indeg.items() if d == 0), key=slot)
        order = []
        while ready:
            nid = ready.pop(0)
            order.append(nid)
            for dst in adj[nid]:
                indeg[dst] -= 1
                if indeg[dst] == 0:
                    ready.append(dst)
            ready.sort(key=slot)
        assert len(order) == len(entries), "cycle in graph"

        self._created = []
        self._procs = {}
        for nid in order:
            if nid in (gin, gout):
                continue
            ent = entries[nid]
            k = node_key(nid)
            proc = (
                processors.get(nid)
                if processors is not None
                else ent.weight.node.activate(
                    sample_rate, max_block_frames,
                    ent.num_inputs, ent.num_outputs,
                )
            )
            assert proc is not None, f"no processor for {k}"
            self._procs[k] = proc
            self._created.append((k, ent.num_inputs, ent.num_outputs))

        self.state = {
            k: tree_map(lambda t: t.to(self.device), p.init_state())
            for k, p in self._procs.items()
        }
        self._sample = 0

    def collect_params(self):
        return {k: p.collect_params() for k, p in self._procs.items()}

    def render_block(self, graph_in=None, in_mask=None, info=None):
        """Render one max_block_frames block; advances internal state and
        the stream clock (when ``info`` is not given)."""
        frames = self.max_block_frames
        if graph_in is None:
            graph_in = torch.zeros((self.num_graph_inputs, frames))
            in_mask = torch.ones((self.num_graph_inputs,), dtype=torch.bool)
        if info is None:
            info = BlockInfo.make(
                stream_time_secs=self._sample / self.sample_rate,
                stream_sample=self._sample,
                device=self.device,
            )
            self._sample += frames
        out, flags, self.state = interpret_block(
            self._created, self._edges, self._procs,
            params_from_jax(self.collect_params(), self.device), self.state,
            torch.as_tensor(graph_in, dtype=torch.float32, device=self.device),
            torch.as_tensor(in_mask, dtype=torch.bool, device=self.device),
            info, self._gin_key, self.num_graph_outputs,
        )
        return out, flags


# ---------------------------------------------------------------------------
# The differential fuzzers' streams
# ---------------------------------------------------------------------------

#: the fuzzers' stream: 48 kHz, stereo out, blocks of 128 frames
FUZZ_SR, FUZZ_BLOCK = 48000, 128


class GraphEditModel:
    """The live-edit fuzzer's builder-side mirror (the JAX package's
    ``tests/test_differential_edits.py:GraphModel``): creation-ordered node
    records and an explicit edge list, which the interpreter renders from,
    never from the compiled schedule.  Each edit makes the JAX model's rng
    draws in its order; ``nodes`` is the node module (the port's by
    default)."""

    #: the edit kinds a round draws from
    OPS = ("add", "remove", "connect", "disconnect", "poke_param", "poke_param")

    def __init__(self, g, nodes=None):
        self.g = g
        self.nodes = nodes or _NODES
        self.created = []  # {key, nid, n_in, n_out, node}
        self.edges = []    # (src_nid, sp, dst_nid, dp); dst may be graph_out

    def _has_edge_into(self, dst_nid, dp):
        return any(d == dst_nid and p == dp for _, _, d, p in self.edges)

    def add(self, rng):
        _, build = FUZZ_PALETTE[int(rng.integers(len(FUZZ_PALETTE)))]
        node, n_in, n_out = build(rng, self.nodes)
        nid = self.g.add_node(n_in, n_out, node)
        rec = {"key": node_key(nid), "nid": nid, "n_in": n_in, "n_out": n_out,
               "node": node}
        for port in range(n_in):
            if self.created and rng.random() < 0.7:
                src = self.created[int(rng.integers(len(self.created)))]
                sp = int(rng.integers(src["n_out"]))
                self.g.connect(src["nid"], sp, nid, port)
                self.edges.append((src["nid"], sp, nid, port))
        self.created.append(rec)

    def remove(self, rng):
        if len(self.created) < 2:
            return
        rec = self.created.pop(int(rng.integers(len(self.created))))
        self.g.remove_node(rec["nid"])  # removes its edges too
        self.edges = [e for e in self.edges
                      if e[0] != rec["nid"] and e[2] != rec["nid"]]

    def connect(self, rng):
        # dst: a created node's free input (wired only from earlier nodes,
        # so creation order stays a topological order) or a graph output
        go = self.g.graph_out_node()
        choices = []
        for i, rec in enumerate(self.created):
            if i == 0:
                continue
            for dp in range(rec["n_in"]):
                if not self._has_edge_into(rec["nid"], dp):
                    choices.append((i, rec["nid"], dp))
        for dp in range(2):
            if not self._has_edge_into(go, dp):
                choices.append((len(self.created), go, dp))
        if not choices:
            return
        i, dst_nid, dp = choices[int(rng.integers(len(choices)))]
        pool = self.created[:i]
        if not pool:
            return
        src = pool[int(rng.integers(len(pool)))]
        sp = int(rng.integers(src["n_out"]))
        self.g.connect(src["nid"], sp, dst_nid, dp)
        self.edges.append((src["nid"], sp, dst_nid, dp))

    def disconnect(self, rng):
        if not self.edges:
            return
        self.g.disconnect(*self.edges.pop(int(rng.integers(len(self.edges)))))

    def poke_param(self, rng):
        if not self.created:
            return
        node = self.created[int(rng.integers(len(self.created)))]["node"]
        for name, lo, hi in FUZZ_POKES:
            setter = getattr(node, name, None)
            if setter is not None:
                setter(float(rng.uniform(lo, hi)))
                return

    def edit(self, rng):
        """One round: 1–2 edits of random kinds."""
        for _ in range(int(rng.integers(1, 3))):
            getattr(self, self.OPS[int(rng.integers(len(self.OPS)))])(rng)

    def interp_edges(self):
        go = self.g.graph_out_node()
        out = {}
        for s, sp, d, dp in self.edges:
            out[("out", dp) if d == go else (node_key(d), dp)] = (node_key(s), sp)
        return out

    def interp_created(self):
        return [(r["key"], r["nid"], r["n_in"], r["n_out"]) for r in self.created]


def _oracle_info(sample: int, device) -> BlockInfo:
    """The stream's clock for the block at ``sample``, as the processor
    computes it (split-precision time of the wrapped sample)."""
    s = torch.tensor(sample & 0xFFFFFFFF, dtype=torch.int64, device=device)
    return BlockInfo(stream_time_from_sample(s, float(FUZZ_SR)), s,
                     torch.tensor(0, dtype=torch.int64, device=device))


def _oracle_state(state: dict, procs: Mapping, keys, device) -> None:
    """Carry the interpreter's state across an edit: drop removed nodes,
    start added ones at their initial state (in place)."""
    keys = set(keys)
    for k in [k for k in state if k not in keys]:
        del state[k]
    for k in keys:
        if k not in state:
            state[k] = tree_map(lambda t: t.to(device), procs[k].init_state())


def _close(cx, proc, n_in: int) -> None:
    """Stop the processor and finish the context's drop handshake by
    pumping it, as a single-threaded backend does."""
    f = FUZZ_BLOCK

    def pump():
        status = proc.process_interleaved(np.zeros(f * n_in, np.float32),
                                          np.zeros(f * 2, np.float32), n_in, 2, f, 0.0)
        if status != ProcessorStatus.OK:
            proc.drop()

    cx.deactivate(True, pump=pump)


def _oracle_params(procs: Mapping, device) -> dict:
    return params_from_jax({k: p.collect_params() for k, p in procs.items()}, device)


def edit_fuzz(seed: int, rounds: int = 7, device: str | torch.device = DEFAULT_DEVICE,
              oracle_device: str | torch.device = "cpu"):
    """The live-edit fuzzer (the JAX package's ``run_edit_differential``)
    on the port: a random graph behind a :class:`GraphContext` whose
    processor runs on ``device``, two blocks rendered, then ``rounds``
    rounds of random edits (add, remove, connect, disconnect, param pokes),
    each installed by ``update`` through the state-migrating swap and
    followed by two blocks.  The naive interpreter mirrors every edit in
    its own records (:class:`GraphEditModel`) and carries its own state on
    ``oracle_device``, with the processor's node processors.

    Returns ``[(tag, stream f32[2·F] interleaved, oracle f32[2·F], kinds)]``
    a block, as numpy, ``kinds`` the class names of the live nodes."""
    f = FUZZ_BLOCK
    oracle_device = torch.device(oracle_device)
    rng = np.random.default_rng(seed)
    cx = GraphContext()
    model = GraphEditModel(cx.graph)
    kin = node_key(cx.graph.graph_in_node())
    for _ in range(int(rng.integers(2, 5))):
        model.add(rng)
    model.connect(rng)
    model.connect(rng)
    proc = cx.activate(FUZZ_SR, 0, 2, f, device=device)
    res = cx.update()
    assert res.status == UpdateStatus.ACTIVE and res.graph_error is None, res

    blocks, state, sample = [], {}, 0
    no_input = torch.zeros((0, f), device=oracle_device)
    no_mask = torch.zeros((0,), dtype=torch.bool, device=oracle_device)

    def render(tag):
        nonlocal sample
        out = np.zeros(f * 2, np.float32)
        status = proc.process_interleaved(np.zeros(0, np.float32), out, 0, 2, f,
                                          sample / FUZZ_SR)
        assert status == ProcessorStatus.OK, (seed, tag, status)
        procs = {node_key(nid): p for nid, p in proc._processors.items()}
        _oracle_state(state, procs, (r["key"] for r in model.created), oracle_device)
        rows, _, new = interpret_block(
            model.interp_created(), model.interp_edges(), procs,
            _oracle_params(procs, oracle_device), state, no_input, no_mask,
            _oracle_info(sample, oracle_device), kin)
        state.clear()
        state.update(new)
        ref = np.zeros(f * 2, np.float32)
        ref[0::2], ref[1::2] = rows[0].cpu().numpy(), rows[1].cpu().numpy()
        blocks.append((tag, out, ref, sorted({type(r["node"]).__name__
                                              for r in model.created})))
        sample += f

    for b in range(2):
        render(f"init blk{b}")
    for rnd in range(rounds):
        model.edit(rng)
        res = cx.update()
        assert res.status == UpdateStatus.ACTIVE and res.graph_error is None, res
        for b in range(2):
            render(f"round{rnd} blk{b}")
    _close(cx, proc, 0)
    return blocks


def poke_fuzz_param(rng, g, created) -> None:
    """The chunked fuzzer's poke between buffers: the first setter of a
    random node among volume, frequency, feedback, pan, width and depth."""
    node = g.node(created[int(rng.integers(len(created)))][1])
    for name, lo, hi in (
        ("set_percent_volume", 0.0, 150.0),
        ("set_frequency", 100.0, 8000.0),
        ("set_feedback", 0.0, 0.8),
        ("set_pan", -1.0, 1.0),
        ("set_width", 0.0, 2.0),
        ("set_depth", 0.0, 1.0),
    ):
        setter = getattr(node, name, None)
        if setter is not None:
            setter(float(rng.uniform(lo, hi)))
            return


def chunked_fuzz(seed: int, chunk_blocks: int = 4, buffers: int = 3,
                 device: str | torch.device = DEFAULT_DEVICE,
                 oracle_device: str | torch.device = "cpu"):
    """The chunked-dispatch fuzzer (the JAX package's
    ``test_chunked_dispatch_differential``) on the port: the random graph
    of :func:`~firewheel_tpu_torch.mixer.fuzz_graph` drawn from
    ``default_rng(seed)`` behind a :class:`GraphContext` with
    ``chunk_blocks`` blocks a dispatch on ``device``; ``buffers`` buffers of
    ``chunk_blocks`` blocks each, random stream input where the graph has
    inputs, and a random param poke between buffers.  The interpreter
    renders each buffer's blocks first (from a param snapshot taken before
    the processor consumes it) on ``oracle_device``.

    Returns ``[(stream f32[2, frames], oracle f32[2, frames])]`` a buffer,
    as numpy, and the graph's node kinds."""
    f = FUZZ_BLOCK
    oracle_device = torch.device(oracle_device)
    rng = np.random.default_rng(seed)
    holder = {}

    def factory(n_in):
        holder["cx"] = GraphContext(AudioGraphConfig(n_in, 2))
        return holder["cx"].graph

    g, created, edges = fuzz_graph(rng, graph_factory=factory)
    cx = holder["cx"]
    n_in = g.node_info(g.graph_in_node()).num_outputs
    kin = node_key(g.graph_in_node())
    proc = cx.activate(FUZZ_SR, n_in, 2, f, chunk_blocks=chunk_blocks, device=device)
    res = cx.update()
    assert res.status == UpdateStatus.ACTIVE and res.graph_error is None, res
    proc.poll_messages()  # install the shipped schedule before reading it

    procs = {node_key(nid): p for nid, p in proc._processors.items()}
    state = {}
    _oracle_state(state, procs, procs, oracle_device)
    span, sample, buffers_out = chunk_blocks * f, 0, []
    for _ in range(buffers):
        gi = rng.standard_normal((span, n_in)).astype(np.float32) * 0.3
        params = _oracle_params(procs, oracle_device)
        rows = []
        for b in range(chunk_blocks):
            gi_b = torch.from_numpy(np.ascontiguousarray(gi[b * f:(b + 1) * f].T))
            out, _, state = interpret_block(
                created, edges, procs, params, state, gi_b.to(oracle_device),
                torch.zeros((n_in,), dtype=torch.bool, device=oracle_device),
                _oracle_info(sample + b * f, oracle_device), kin)
            rows.append(out.cpu().numpy())
        out = np.zeros(span * 2, np.float32)
        status = proc.process_interleaved(gi.reshape(-1), out, n_in, 2, span,
                                          sample / FUZZ_SR)
        assert status == ProcessorStatus.OK, (seed, status)
        buffers_out.append((out.reshape(span, 2).T, np.concatenate(rows, axis=1)))
        sample += span
        poke_fuzz_param(rng, cx.graph, created)
    _close(cx, proc, n_in)
    return buffers_out, sorted({type(p).__name__ for p in procs.values()})


# ---------------------------------------------------------------------------
# The node contract validator
# ---------------------------------------------------------------------------

def _fail(check, msg):
    raise NodeContractError(check, msg)


def _leaves(tree, path=()):
    """``[(path, leaf)]`` of nested dicts, in key order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k], path + (k,))]
    return [(path, tree)]


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return np.array_equal(a.cpu().numpy(), b.cpu().numpy(), equal_nan=True)


def validate_node(
    node: AudioNode,
    num_inputs: int,
    num_outputs: int,
    *,
    sample_rate: int = 48000,
    max_block_frames: int = 128,
    blocks: int = 4,
    batch: int = 3,
    atol: float = 1e-5,
    seed: int = 0,
    device: str | torch.device = DEFAULT_DEVICE,
) -> dict:
    """Validate a custom node against the port executor's kernel contract,
    on ``device`` (the card unless the caller asks for the CPU).

    Runs the checks in order and raises :class:`NodeContractError` (an
    ``AssertionError`` subclass, pytest-friendly) naming the first failed
    check; returns ``{check_name: "ok"}`` for all passed checks.  Checks,
    in the order the executor relies on them:

    - ``activate``       — ``info()`` ranges admit the port counts;
      ``activate`` returns a :class:`NodeProcessor`.
    - ``pytrees``        — ``init_state`` is a nested dict of tensors and
      ``collect_params`` a nested dict whose leaves convert to tensors.
    - ``eager``          — one kernel call: output ``f32[num_outputs, F]``
      and mask ``bool[num_outputs]`` on ``device``, state' with the keys
      and leaf shapes/dtypes of state (a checkpoint, a pooled group and the
      megakernel's packed leaves all rely on that).
    - ``determinism``    — identical (params, state, inputs) → identical
      outputs and state' (impure kernels break replay and checkpoints).
    - ``scan``           — ``blocks`` blocks chained as a dispatch's
      K-block loop chains them (each block's state' fed to the next, the
      clocks from one tensor, every output kept until the end) match
      blocks run one at a time with each output and state' copied: a
      kernel that returns a view of its state and later writes that state
      in place fails here.
    - ``vmap``           — a leading batch dimension of ``batch`` instances
      (params and state stacked) matches per-instance calls (instance
      batching and node pooling).
    - ``partial_block``  — the kernel accepts ``F//2`` frames (a stream's
      last, shorter block).

    The JAX package's ``jit`` check has no counterpart here: the port
    calls its kernels eagerly, so nothing is traced.
    """
    from .executor_mega import eligible

    device = resolve_device(device)
    report = {}
    rng = np.random.default_rng(seed)
    F = int(max_block_frames)
    to_dev = lambda t: tree_map(lambda x: x.to(device), t)  # noqa: E731

    # -- activate ----------------------------------------------------------
    info_obj = node.info()
    if not (info_obj.num_min_supported_inputs <= num_inputs
            <= info_obj.num_max_supported_inputs):
        _fail(
            "activate",
            f"num_inputs={num_inputs} outside the node's declared "
            f"[{info_obj.num_min_supported_inputs}, "
            f"{info_obj.num_max_supported_inputs}]",
        )
    if not (info_obj.num_min_supported_outputs <= num_outputs
            <= info_obj.num_max_supported_outputs):
        _fail(
            "activate",
            f"num_outputs={num_outputs} outside the node's declared "
            f"[{info_obj.num_min_supported_outputs}, "
            f"{info_obj.num_max_supported_outputs}]",
        )
    proc = node.activate(sample_rate, F, num_inputs, num_outputs)
    if not isinstance(proc, NodeProcessor):
        _fail("activate", f"activate returned {type(proc).__name__}, "
                          "not a NodeProcessor")
    report["activate"] = "ok"

    # -- pytrees -----------------------------------------------------------
    try:
        state0 = proc.init_state()
        params = params_from_jax(proc.collect_params(), device)
    except Exception as e:  # noqa: BLE001 - reported with context
        _fail("pytrees", f"init_state/collect_params raised: {e!r}")
    if not isinstance(state0, dict):
        _fail("pytrees", f"init_state returned {type(state0).__name__}, "
                         "not a dict of tensors")
    for path, leaf in _leaves(state0) + _leaves(params):
        if not isinstance(leaf, torch.Tensor):
            _fail("pytrees", f"leaf {'/'.join(path)} is {type(leaf).__name__}, "
                             "not a tensor (state and params are nested dicts "
                             "of tensors)")
    state0 = to_dev(state0)
    state_leaves = _leaves(state0)
    report["pytrees"] = "ok"

    def make_inputs(frames, r=rng):
        x = r.standard_normal((num_inputs, frames)).astype(np.float32) * 0.3
        return (torch.from_numpy(x).to(device),
                torch.zeros((num_inputs,), dtype=torch.bool, device=device))

    def make_info(sample):
        return BlockInfo.make(stream_time_secs=sample / sample_rate,
                              stream_sample=sample, device=device)

    # -- eager -------------------------------------------------------------
    x0, m0 = make_inputs(F, np.random.default_rng(seed))
    try:
        out, st1, om = proc.kernel(params, state0, x0, m0, make_info(0))
    except Exception as e:  # noqa: BLE001
        _fail("eager", f"kernel raised on a plain eager call: {e!r}")
    if (not isinstance(out, torch.Tensor) or tuple(out.shape) != (num_outputs, F)
            or out.dtype != torch.float32 or out.device != device):
        got = (f"{out.dtype}{list(out.shape)} on {out.device}"
               if isinstance(out, torch.Tensor) else type(out).__name__)
        _fail("eager", f"output is {got}, expected float32[{num_outputs}, {F}] "
                       f"on {device} — fill every output row")
    if (not isinstance(om, torch.Tensor) or tuple(om.shape) != (num_outputs,)
            or om.dtype != torch.bool or om.device != device):
        got = (f"{om.dtype}{list(om.shape)} on {om.device}"
               if isinstance(om, torch.Tensor) else type(om).__name__)
        _fail("eager", f"out_mask is {got}, expected bool[{num_outputs}] on {device}")
    new_leaves = _leaves(st1) if isinstance(st1, dict) else None
    if new_leaves is None or [p for p, _ in new_leaves] != [p for p, _ in state_leaves]:
        _fail("eager", "state' keys differ from init_state()'s — state must be "
                       f"shape-stable ({[p for p, _ in state_leaves]} -> "
                       f"{None if new_leaves is None else [p for p, _ in new_leaves]})")
    for (path, a), (_, b) in zip(state_leaves, new_leaves):
        if not isinstance(b, torch.Tensor) or a.shape != b.shape or a.dtype != b.dtype:
            got = (f"{b.dtype}{list(b.shape)}" if isinstance(b, torch.Tensor)
                   else type(b).__name__)
            _fail("eager", f"state leaf {'/'.join(path)} changed across a block: "
                           f"{a.dtype}{list(a.shape)} -> {got}")
    report["eager"] = "ok"

    # -- determinism -------------------------------------------------------
    out2, st2, _ = proc.kernel(params, state0, x0, m0, make_info(0))
    if not _same(out, out2):
        _fail(
            "determinism",
            "two identical kernel calls produced different outputs — "
            "kernels must be pure (host RNG/side effects belong in "
            "collect_params or state)",
        )
    for (path, a), (_, b) in zip(_leaves(st1), _leaves(st2)):
        if not _same(a, b):
            _fail("determinism", f"state' leaf {'/'.join(path)} differs across "
                                 "identical calls")
    report["determinism"] = "ok"

    # -- scan (a dispatch's K-block loop) ---------------------------------
    xs = [make_inputs(F)[0] for _ in range(blocks)]
    samples = F * torch.arange(blocks, dtype=torch.int64, device=device)
    times = stream_time_from_sample(samples, float(sample_rate))
    status = torch.zeros((), dtype=torch.int64, device=device)
    try:
        st, chained = tree_map(torch.clone, state0), []
        for b in range(blocks):
            o, st, _ = proc.kernel(params, st, xs[b], m0,
                                   BlockInfo(times[b], samples[b], status))
            chained.append(o)
        chained = torch.stack(chained)
    except Exception as e:  # noqa: BLE001
        _fail("scan", f"kernel failed in a chain of {blocks} blocks: {e!r}")
    st = state0
    for b in range(blocks):
        o, st, _ = proc.kernel(params, tree_map(torch.clone, st), xs[b], m0,
                               make_info(b * F))
        o, st = o.clone(), tree_map(torch.clone, st)
        if not np.allclose(chained[b].cpu().numpy(), o.cpu().numpy(), atol=atol):
            _fail(
                "scan",
                f"block {b}: the chained output diverged from blocks run one "
                f"at a time beyond atol {atol} — state is not threading "
                "correctly from block to block (a returned view of state "
                "written in place later?)",
            )
    report["scan"] = "ok"

    # -- vmap (instance batching / pooling) --------------------------------
    tile = lambda t: tree_map(lambda x: torch.stack([x] * batch), t)  # noqa: E731
    xb = torch.stack([make_inputs(F)[0] for _ in range(batch)])
    try:
        ob, _, _ = proc.kernel(tile(params), tile(state0), xb,
                               torch.stack([m0] * batch), make_info(0))
    except Exception as e:  # noqa: BLE001
        _fail("vmap", f"kernel failed on a leading batch dimension: {e!r}")
    if tuple(ob.shape) != (batch, num_outputs, F):
        _fail("vmap", f"batched output has shape {list(ob.shape)}, expected "
                      f"[{batch}, {num_outputs}, {F}]")
    for i in range(batch):
        o_i, _, _ = proc.kernel(params, state0, xb[i], m0, make_info(0))
        if not np.allclose(ob[i].cpu().numpy(), o_i.cpu().numpy(), atol=atol):
            _fail(
                "vmap",
                f"instance {i}: the batched output diverged from the "
                f"per-instance call beyond atol {atol}",
            )
    report["vmap"] = "ok"

    # -- partial blocks ----------------------------------------------------
    half = max(1, F // 2)
    xh, mh = make_inputs(half)
    try:
        oh, _, _ = proc.kernel(params, state0, xh, mh, make_info(0))
    except Exception as e:  # noqa: BLE001
        _fail(
            "partial_block",
            f"kernel raised at frames={half} (< max_block_frames): {e!r} "
            "— a stream's last block is shorter; size state off "
            "max_block_frames but compute off inputs.shape[-1]",
        )
    if tuple(oh.shape) != (num_outputs, half):
        _fail(
            "partial_block",
            f"output at frames={half} has shape {list(oh.shape)}, expected "
            f"[{num_outputs}, {half}]",
        )
    report["partial_block"] = "ok"

    report["supports_megakernel"] = (
        "a row in executor_mega.OPS" if eligible(proc)
        else "no megakernel row (or opted out)"
    )
    return report
