"""Schedule executor: runs a :class:`CompiledSchedule` on torch tensors.

PyTorch port of ``firewheel_tpu/executor.py``.  The JAX package walks the
schedule once, at trace time, into one fused XLA program; here the walk
runs eagerly every block: each scheduled node's kernel is called in
topological order over a dict of live buffers (one tensor per arena buffer
index), with a boolean silence flag beside each buffer.  Graph outputs
honor the flags exactly like ``read_graph_outputs`` (schedule.rs:255-287)
by forcing flagged channels to zero.

Every tensor may carry leading batch dimensions (``...``): a single
instance renders with none, :class:`~firewheel_tpu_torch.parallel.mesh.
BatchRenderer` with one.  Node pooling stacks a run of identical nodes on
a member axis right after the batch dimensions and calls the kernel once.

* ``render_block`` — one block: the ``process_block`` analog;
  ``render_fn`` the same pure function, for callers that compose it.
* ``chunk_fn`` / ``render_chunk`` — K blocks in a Python loop (the JAX
  package's ``lax.scan``), with the per-block clocks computed once before
  the loop.  A param leaf may carry a per-block timeline
  (:class:`PerBlock`): block ``b`` of the chunk sees its ``b``-th value.
  A block shorter than ``max_block_frames`` (a stream's tail) advances the
  state by exactly its frames: every kernel reads F from its inputs.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .convert import params_from_jax, tree_map
from .core.node import (
    stream_time_from_sample, wrap_stream_sample, BlockInfo, NodeProcessor,
)
from .device import DEFAULT_DEVICE, resolve_device
from .graph.compiler import CompiledSchedule, NodeID

__all__ = [
    "node_key", "PerBlock", "split_timelines", "refuse_timelines", "ScheduleProgram",
]


def node_key(node_id: NodeID) -> str:
    """Stable string key for state/param dicts: ``repr(NodeID)``, the same
    key as in the JAX package."""
    return repr(node_id)


class PerBlock:
    """A param leaf carrying a per-block timeline: ``values[K, ...]``, one
    value per block of a K-block dispatch.

    Chunked dispatch would otherwise apply params once per chunk; timeline
    leaves restore block-accurate control inside a chunk (the reference
    loads params every block, volume.rs:92).  Processors opt in with
    ``collect_timeline = True``; their ``collect_params(blocks=K,
    start_sample=..., frames=..., consume=...)`` returns PerBlock leaves
    whenever ``start_sample`` is given."""

    __slots__ = ("values",)

    def __init__(self, values):
        self.values = np.asarray(values)


def split_timelines(tree, prefix=()):
    """``(static, timelines)``: ``tree`` with every :class:`PerBlock` leaf
    replaced by its block-0 value, and ``{path: values[K, ...]}`` of those
    leaves, ``path`` the tuple of keys down to the leaf."""
    static, timelines = {}, {}
    for k, v in tree.items():
        if isinstance(v, dict):
            static[k], inner = split_timelines(v, prefix + (k,))
            timelines.update(inner)
        elif isinstance(v, PerBlock):
            static[k] = v.values[0]
            timelines[prefix + (k,)] = v.values
        else:
            static[k] = v
    return static, timelines


def refuse_timelines(params, who: str) -> None:
    """Raise when ``params`` holds :class:`PerBlock` leaves: ``who`` renders
    a chunk with one param value per leaf."""
    if isinstance(params, dict) and split_timelines(params)[1]:
        raise ValueError(
            f"{who} takes one value per param leaf a chunk; these params "
            "carry per-block timelines (PerBlock leaves, from collect_params("
            "start_sample=...)): render them with ScheduleProgram.render_chunk "
            "or the GraphProcessor"
        )


def refuse_stripped_masks(program, who: str) -> None:
    """Raise when ``program`` was built with ``strip_masks``: ``who`` lowers
    the silence flags into its own tables and does not run the ablation."""
    if program.strip_masks:
        raise ValueError(
            f"{who} runs the silence masks; strip_masks is an ablation of "
            "the eager path: render this program with BatchRenderer("
            "lowering='xla') or ScheduleProgram"
        )


def splice_block(params: dict, timelines: dict, b: int) -> dict:
    """``params`` with each timeline leaf (``{path: tensor[K, ...]}``)
    replaced by its block-``b`` value; untouched subtrees are shared."""
    if not timelines:
        return params
    out = dict(params)
    for path, values in timelines.items():
        d = out
        for k in path[:-1]:
            d[k] = dict(d[k])
            d = d[k]
        d[path[-1]] = values[b]
    return out


def _stack_trees(trees, dim: int):
    """Stack equally shaped dicts of tensors leaf by leaf along ``dim``."""
    return tree_map(lambda *xs: torch.stack(xs, dim=dim), *trees)


class ScheduleProgram:
    """A compiled schedule bound to node processors.

    Contract::

        out, out_mask, state' = render_block(params, state, graph_in,
                                             in_mask, info)

    with ``graph_in: f32[..., num_graph_inputs, F]`` and
    ``out: f32[..., num_graph_outputs, F]``.  ``params`` may be the numpy
    snapshot from :meth:`collect_params` or tensors; ``state`` is a dict of
    tensors on ``device`` (:meth:`init_state`; the card unless the caller
    passes ``device="cpu"``, :func:`~firewheel_tpu_torch.device.
    resolve_device`).
    """

    def __init__(
        self,
        schedule: CompiledSchedule,
        processors: dict[NodeID, NodeProcessor],
        sample_rate: int,
        device: str | torch.device = DEFAULT_DEVICE,
        group_nodes: bool = True,
        strip_masks: bool = False,
    ):
        """``group_nodes``: pool runs of identical consecutive nodes into
        one kernel call (:meth:`_build_plan`); ``False`` walks every node
        alone, to the same outputs.  K2 and K3 lower the schedule row by
        row and ignore it.

        ``strip_masks``: the JAX package's measurement ablation.  Every
        stored silence flag is the not-silent constant, so the audio is
        unchanged and the output masks carry no meaning.  Under XLA that
        folds the mask threading away; here every node still computes its
        masks, so the option keeps JAX's outputs, not its saving.  The eager
        path only: ``MegaRenderer`` and the hybrid refuse such a program."""
        self.schedule = schedule
        self.sample_rate = int(sample_rate)
        self.device = resolve_device(device)
        self.max_block_frames = schedule.max_block_frames
        scheduled = {node_key(sn.id) for sn in schedule.schedule}
        self._procs: dict[str, NodeProcessor] = {
            node_key(nid): proc
            for nid, proc in processors.items()
            if node_key(nid) in scheduled
        }
        self.num_graph_inputs = len(schedule.schedule[0].output_buffers)
        self.num_graph_outputs = len(schedule.schedule[-1].input_buffers)
        self.group_nodes = bool(group_nodes)
        self.strip_masks = bool(strip_masks)
        self._plan = self._build_plan()

    # -- state / params ------------------------------------------------------
    def init_state(self) -> dict[str, Any]:
        """Initial state of every scheduled node, on ``self.device``."""
        return {
            key: tree_map(lambda t: t.to(self.device), proc.init_state())
            for key, proc in self._procs.items()
        }

    def collect_params(
        self,
        blocks: float = 1,
        start_sample: int | None = None,
        frames: int | None = None,
        consume: bool = True,
    ) -> dict[str, Any]:
        """Host-side param snapshot (numpy scalars) for the next dispatch
        (the lock-free param channel; volume.rs:92).

        ``start_sample``: the dispatch's first absolute sample.  When given,
        timeline-capable processors (``collect_timeline``) return
        :class:`PerBlock` leaves over ``ceil(blocks)`` blocks of ``frames``
        (``max_block_frames`` by default), so scheduled param changes land
        on their exact block.  ``consume=False`` leaves scheduled changes
        queued (a throwaway render)."""
        out = {}
        f = self.max_block_frames if frames is None else int(frames)
        k = max(1, int(np.ceil(blocks)))
        for key, proc in self._procs.items():
            if getattr(proc, "collect_timeline", False):
                out[key] = proc.collect_params(
                    blocks=k, start_sample=start_sample, frames=f,
                    consume=consume,
                )
            else:
                out[key] = proc.collect_params()
        return out

    # -- node pooling ----------------------------------------------------------
    def _build_plan(self):
        """Partition the interior schedule into singles and pooled groups.

        A group is a run of consecutive entries whose processors share a
        grouping signature (:meth:`NodeProcessor.group_key`), with no data
        dependency inside the run (a member never consumes a buffer another
        member produced).  Without ``group_nodes`` every entry is a single.
        """

        def signature(proc):
            gk = proc.group_key() if self.group_nodes else None
            if gk is None:
                return None
            return (
                type(proc).__name__,
                proc.num_inputs,
                proc.num_outputs,
                proc.sample_rate,
                proc.max_block_frames,
                gk,
            )

        interior = self.schedule.schedule[1:-1]
        plan: list[tuple[str, list]] = []
        i = 0
        while i < len(interior):
            sn = interior[i]
            sig = signature(self._procs[node_key(sn.id)])
            members = [sn]
            produced = {ob.buffer_index for ob in sn.output_buffers}
            j = i + 1
            while sig is not None and j < len(interior):
                cand = interior[j]
                if signature(self._procs[node_key(cand.id)]) != sig:
                    break
                if any(
                    (not ib.should_clear) and ib.buffer_index in produced
                    for ib in cand.input_buffers
                ):
                    break  # intra-group dependency
                members.append(cand)
                produced.update(ob.buffer_index for ob in cand.output_buffers)
                j += 1
            plan.append(("group" if len(members) > 1 else "single", members))
            i = j
        return plan

    # -- one block -------------------------------------------------------------
    def _walk_segment(self, params, state, bufs, flags, info: BlockInfo,
                      plan, new_state, zeros_row, cleared):
        """Run ``plan``'s entries in schedule order against explicit buffer
        and flag environments (mutated in place), writing each node's new
        state into ``new_state``.  ``zeros_row f32[..., F]`` and ``cleared
        bool[...]``, the flag a cleared input stores (silent, or not silent
        under ``strip_masks``), give the batch shape, the frame count and
        the device.
        Factored out of :meth:`_render` so that the hybrid lowering
        (``executor_hybrid``) runs a sub-range of the schedule with its live
        buffers as inputs."""
        lead = cleared.shape
        frames = zeros_row.shape[-1]
        nb = len(lead)  # the member axis of a pooled group sits at dim nb

        def gather_inputs(sn):
            rows, masks = [], []
            for ib in sn.input_buffers:
                if ib.should_clear:
                    # Unconnected input: cleared + silent (schedule.rs:310-313).
                    rows.append(zeros_row)
                    masks.append(cleared)
                else:
                    rows.append(bufs[ib.buffer_index])
                    masks.append(flags[ib.buffer_index])
            if not rows:
                return (
                    zeros_row.new_zeros(lead + (0, frames)),
                    cleared.new_zeros(lead + (0,)),
                )
            return torch.stack(rows, dim=-2), torch.stack(masks, dim=-1)

        def scatter_outputs(sn, outputs, out_mask):
            for j, ob in enumerate(sn.output_buffers):
                bufs[ob.buffer_index] = outputs[..., j, :]
                flags[ob.buffer_index] = (cleared if self.strip_masks
                                          else out_mask[..., j])

        for kind, members in plan:
            if kind == "single":
                sn = members[0]
                key = node_key(sn.id)
                inputs, mask = gather_inputs(sn)
                outputs, st, out_mask = self._procs[key].kernel(
                    params[key], state[key], inputs, mask, info
                )
                new_state[key] = st
                scatter_outputs(sn, outputs, out_mask)
                continue

            keys = [node_key(sn.id) for sn in members]
            gathered = [gather_inputs(sn) for sn in members]
            outs_g, st_g, om_g = self._procs[keys[0]].kernel(
                _stack_trees([params[k] for k in keys], nb),
                _stack_trees([state[k] for k in keys], nb),
                torch.stack([g[0] for g in gathered], dim=nb),
                torch.stack([g[1] for g in gathered], dim=nb),
                info,
            )
            for j, (sn, key) in enumerate(zip(members, keys)):
                new_state[key] = tree_map(lambda x: x.select(nb, j), st_g)
                scatter_outputs(sn, outs_g.select(nb, j), om_g.select(nb, j))

    def _render(self, params, state, graph_in, in_mask, info: BlockInfo):
        """One block through the schedule (schedule.rs:289-343)."""
        sched = self.schedule.schedule
        lead = graph_in.shape[:-2]
        frames = graph_in.shape[-1]
        device = graph_in.device
        zeros_row = torch.zeros(lead + (frames,), dtype=torch.float32,
                                device=device)
        # with strip_masks every stored flag, a cleared buffer's too, is
        # the not-silent constant (executor.py:_flag_ops in the JAX package)
        cleared = torch.full(lead, not self.strip_masks, dtype=torch.bool,
                             device=device)
        bufs: dict[int, torch.Tensor] = {}
        flags: dict[int, torch.Tensor] = {}
        new_state: dict[str, Any] = {}

        # Graph inputs (prepare_graph_inputs, schedule.rs:213-253).
        for i, ob in enumerate(sched[0].output_buffers):
            bufs[ob.buffer_index] = graph_in[..., i, :]
            flags[ob.buffer_index] = cleared if self.strip_masks else in_mask[..., i]

        self._walk_segment(params, state, bufs, flags, info, self._plan,
                           new_state, zeros_row, cleared)

        # Graph outputs (read_graph_outputs, schedule.rs:255-287): flagged
        # channels read as zero.
        out_rows, out_flags = [], []
        for ib in sched[-1].input_buffers:
            if ib.should_clear:
                out_rows.append(zeros_row)
                out_flags.append(cleared)
            else:
                row, f = bufs[ib.buffer_index], flags[ib.buffer_index]
                out_rows.append(row.masked_fill(f[..., None], 0.0))
                out_flags.append(f)
        for sentinel in (sched[0], sched[-1]):
            key = node_key(sentinel.id)
            if key in self._procs:
                new_state[key] = state[key]
        if not out_rows:
            return (
                zeros_row.new_zeros(lead + (0, frames)),
                cleared.new_zeros(lead + (0,)),
                new_state,
            )
        return torch.stack(out_rows, dim=-2), torch.stack(out_flags, dim=-1), new_state

    @property
    def render_fn(self):
        """The pure one-block function ``(params, state, graph_in, in_mask,
        info) -> (out, out_mask, state')`` over tensors (params already on
        the device: :func:`~firewheel_tpu_torch.convert.params_from_jax`),
        any leading batch dimensions; compose it with a loop, a batch or
        autograd."""
        return self._render

    def render_block(self, params, state, graph_in, in_mask, info: BlockInfo):
        """One block: ``graph_in f32[..., Ni, F]``, ``in_mask bool[..., Ni]``
        → ``(out f32[..., No, F], out_mask bool[..., No], state')``."""
        return self.render_fn(
            params_from_jax(params, self.device), state, graph_in, in_mask, info
        )

    def render_partial_block(self, frames: int, params, state, graph_in,
                             in_mask, info: BlockInfo):
        """A block shorter than ``max_block_frames`` (a stream's tail):
        ``graph_in f32[..., Ni, frames]``; the state advances by exactly
        ``frames``."""
        if graph_in.shape[-1] != frames:
            raise ValueError(f"graph_in has {graph_in.shape[-1]} frames, expected {frames}")
        return self.render_block(params, state, graph_in, in_mask, info)

    # -- K blocks --------------------------------------------------------------
    def block_clocks(self, start_sample, k: int, frames: int, device):
        """``(samples int64[k], times f32[k])``: each block's first sample on
        the modular 32-bit clock and its stream time, for ``k`` blocks of
        ``frames`` from ``start_sample``."""
        samples = (
            wrap_stream_sample(start_sample)
            + frames * torch.arange(k, dtype=torch.int64, device=device)
        ) & 0xFFFFFFFF
        return samples, stream_time_from_sample(samples, float(self.sample_rate))

    def render_blocks(self, params, timelines, state, graph_in, in_mask, infos):
        """Render ``len(infos)`` blocks: ``graph_in f32[..., K, Ni, F]``,
        ``in_mask bool[..., K, Ni]``; block ``b`` sees ``infos[b]`` and, for
        each ``{path: tensor[K, ...]}`` of ``timelines``, its ``b``-th
        value.  Returns ``(out f32[..., K, No, F], out_mask bool[..., K, No],
        state')``."""
        outs, masks = [], []
        for b, info in enumerate(infos):
            out, om, state = self._render(
                splice_block(params, timelines, b), state,
                graph_in[..., b, :, :], in_mask[..., b, :], info,
            )
            outs.append(out)
            masks.append(om)
        return torch.stack(outs, dim=-3), torch.stack(masks, dim=-2), state

    def chunk_fn(self, num_blocks: int):
        """Build ``(params, state, graph_in[..., K, Ni, F], in_mask[..., K,
        Ni], start_sample, status, timelines=None) -> (out[..., K, No, F],
        out_mask[..., K, No], state')``: K blocks chained in a loop.  Stream
        time and sample advance per block exactly as the streaming clock
        would; ``timelines`` (``{path: tensor[K, ...]}``) give block ``b``
        its own value of those param leaves."""

        def chunk(params, state, graph_in, in_mask, start_sample, status,
                  timelines=None):
            k = graph_in.shape[-3]
            if k != num_blocks:
                raise ValueError(f"graph_in has {k} blocks, expected {num_blocks}")
            device = graph_in.device
            # per-block clocks, computed once before the loop
            samples, times = self.block_clocks(start_sample, k,
                                               graph_in.shape[-1], device)
            status_t = torch.as_tensor(int(status), dtype=torch.int64,
                                       device=device)
            infos = [BlockInfo(stream_time_secs=times[b], stream_sample=samples[b],
                               stream_status=status_t) for b in range(k)]
            return self.render_blocks(params, timelines or {}, state, graph_in,
                                      in_mask, infos)

        return chunk

    def render_chunk(self, params, state, graph_in, in_mask, start_sample=0,
                     status=0):
        """K-block render (K from ``graph_in.shape[-3]``).  ``params`` may
        hold :class:`PerBlock` leaves of K values each (``collect_params(
        blocks=K, start_sample=...)``)."""
        k = graph_in.shape[-3]
        static, timelines = split_timelines(params)
        for path, v in timelines.items():
            if v.shape[0] != k:
                raise ValueError(f"timeline {path}: {v.shape[0]} values for "
                                 f"{k} blocks")
        return self.chunk_fn(k)(
            params_from_jax(static, self.device), state, graph_in, in_mask,
            start_sample, status,
            params_from_jax(timelines, self.device),
        )
