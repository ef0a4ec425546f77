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
"""

from __future__ import annotations

from typing import Any, Iterable, Mapping

import numpy as np
import torch

from .convert import params_from_jax, tree_map
from .core.node import (
    AudioNode, BlockInfo, NodeProcessor, stream_time_from_sample,
)
from .device import DEFAULT_DEVICE, resolve_device
from .executor import node_key

__all__ = [
    "NodeContractError",
    "interpret_block",
    "NaiveGraphRenderer",
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
