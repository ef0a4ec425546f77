"""The hybrid lowering: megakernel islands between torch stages.

PyTorch port of ``firewheel_tpu/executor_pallas.py:HybridMegaRenderer``
(the TPU kernel K3, ``HybridMegaRenderer._mega_segment.kernel``), without
the device mesh.  Not every node has a device function in the megakernel
(the sampler's gathers, the reverb's convolutions), but a schedule is
feed-forward dataflow: every maximal run of eligible nodes can run as one
kernel launch (an *island*) with its live buffers, the values that cross
the cut, as operands, while the other nodes run as torch stages around it.
Each segment renders all K blocks of the chunk before the next begins; that
is exact, because a segment's state belongs to its own nodes.

The BASELINE effects chain (sampler → filter → echo → clip → reverb)
renders as torch(sampler) → island(filter·echo·clip) → torch(reverb).

* :func:`partition_schedule` and :func:`_live_sets` split the schedule and
  find each segment's live-in and live-out buffers (graph inputs are
  live-ins of the first segment that reads them).
* :class:`HybridMegaRenderer` renders a chunk segment by segment.  A torch
  stage walks its nodes over the batch, K blocks in a loop
  (``ScheduleProgram._walk_segment``).  An island launches
  ``csrc/megakernel.cu:island_kernel`` on a CUDA device, once a chunk, and
  runs its plain version (``executor_mega.island_chunk_reference``) on the
  CPU; on a CUDA device it never falls back to the plain version.

The state tree is :class:`~firewheel_tpu_torch.parallel.BatchRenderer`'s,
so the eager and the hybrid lowering hand state to each other mid-stream.
"""

from __future__ import annotations

from typing import Any

import torch

from .convert import params_from_jax
from .executor import ScheduleProgram, node_key, refuse_stripped_masks, refuse_timelines
from .ops.grad import refuse_gradients
from .executor_mega import (
    LIBRARY,
    KernelOperands,
    _chunk_clocks,
    _new_state_tree,
    eligible,
    island_chunk_reference,
    lower_schedule,
)
from .device import DEFAULT_DEVICE, resolve_device
from .parallel.mesh import BatchRenderer

__all__ = ["HybridMegaRenderer", "partition_schedule"]


def partition_schedule(program: ScheduleProgram, min_island: int = 2):
    """Split the interior schedule into ``('mega'|'xla', [ScheduledNode])``
    segments: maximal runs of eligible nodes become islands (``'mega'``);
    runs shorter than ``min_island`` fold into the torch stages
    (``'xla'``, the JAX package's name for them)."""
    segs: list[tuple[str, list]] = []
    for sn in program.schedule.schedule[1:-1]:
        kind = "mega" if eligible(program._procs[node_key(sn.id)]) else "xla"
        if segs and segs[-1][0] == kind:
            segs[-1][1].append(sn)
        else:
            segs.append((kind, [sn]))
    merged: list[tuple[str, list]] = []
    for kind, nodes in segs:
        if kind == "mega" and len(nodes) < min_island:
            kind = "xla"
        if merged and merged[-1][0] == kind:
            merged[-1][1].extend(nodes)
        else:
            merged.append((kind, nodes))
    return merged


def _live_sets(program: ScheduleProgram, segs):
    """Per-segment live-in / live-out buffer indices, respecting the
    allocator's buffer-index reuse (reaching definitions, in schedule
    order).  Segment -1 is graph_in; graph_out's reads extend the final
    writers' live-outs."""
    sched = program.schedule.schedule
    last_writer: dict[int, int] = {}
    live_in = [set() for _ in segs]
    live_out: dict[int, set] = {i: set() for i in range(-1, len(segs))}
    for ob in sched[0].output_buffers:
        last_writer[ob.buffer_index] = -1
    for i, (_, nodes) in enumerate(segs):
        for sn in nodes:
            for ib in sn.input_buffers:
                if ib.should_clear:
                    continue
                w = last_writer[ib.buffer_index]
                if w != i:
                    live_in[i].add(ib.buffer_index)
                    live_out[w].add(ib.buffer_index)
            for ob in sn.output_buffers:
                last_writer[ob.buffer_index] = i
    out_bufs = []
    for ib in sched[-1].input_buffers:
        if ib.should_clear:
            out_bufs.append(None)
            continue
        w = last_writer[ib.buffer_index]
        live_out[w].add(ib.buffer_index)
        out_bufs.append(ib.buffer_index)
    return (
        [sorted(s) for s in live_in],
        {i: sorted(s) for i, s in live_out.items()},
        out_bufs,
    )


def _packed(views):
    """The contiguous tensor ``[B, K, n, ...]`` whose channels ``0..n-1``
    along dim 2 are exactly ``views`` in order (a torch stage's live-outs,
    :meth:`HybridMegaRenderer._torch_stage`), or None: then the island
    stacks its live-ins."""
    base = views[0]._base
    if base is None or not base.is_contiguous() or base.dim() != views[0].dim() + 1 \
            or base.shape[2] != len(views):
        return None
    for j, v in enumerate(views):
        c = base.select(2, j)
        if (v._base is not base or v.data_ptr() != c.data_ptr()
                or v.shape != c.shape or v.stride() != c.stride()):
            return None
    return base


class HybridMegaRenderer:
    """Batched K-block renderer that chains megakernel islands and torch
    stages over one compiled schedule.

    ``render_chunk(params, state, graph_in=None, in_mask=None,
    start_sample=0)`` with batch-stacked params and state → ``(out f32[B,
    K, No, F], masks bool[B, K, No], state')``; ``graph_in f32[B, K, Ni,
    F]`` and ``in_mask bool[B, K, Ni]`` feed a graph with stream inputs.
    ``tile`` instances share one CTA of the island kernel.  ``device`` is
    the card unless the caller passes ``"cpu"``.
    """

    #: island kernel launches since the counter was last set to 0
    launches = 0

    def __init__(self, program: ScheduleProgram, batch: int, num_blocks: int,
                 tile: int = 1, min_island: int = 2,
                 device: str | torch.device = DEFAULT_DEVICE):
        if batch % tile != 0:
            raise ValueError(f"batch {batch} % tile {tile} != 0")
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        refuse_stripped_masks(program, "HybridMegaRenderer")
        self.program = program
        self.batch = int(batch)
        self.num_blocks = int(num_blocks)
        self.tile = int(tile)
        self.device = resolve_device(device)
        self.segments = partition_schedule(program, min_island)
        self._live_in, self._live_out, self._out_bufs = _live_sets(
            program, self.segments)
        self._keys = [[node_key(sn.id) for sn in nodes]
                      for _, nodes in self.segments]
        #: segment index → the island's lowered tables
        self.islands = {
            i: lower_schedule(program, nodes, self._live_in[i], self._live_out[i])
            for i, (kind, nodes) in enumerate(self.segments) if kind == "mega"
        }
        self._operands: dict[int, KernelOperands] = {}
        self._batched = BatchRenderer(program, batch, self.device)

    def stack_params(self, params_list=None):
        return self._batched.stack_params(params_list)

    def init_state(self):
        return self._batched.init_state()

    # -- segments ---------------------------------------------------------------
    def _torch_stage(self, i, params, state, rows, flags, infos):
        """Segment ``i``'s nodes over the batch, block by block: live-ins
        ``rows {buf: f32[B, K, F]}``, ``flags {buf: bool[B, K]}`` → the
        live-outs in the same form and the segment's new state."""
        prog = self.program
        plan = [("single", [sn]) for sn in self.segments[i][1]]
        in_bufs, out_bufs = self._live_in[i], self._live_out[i]
        f = prog.max_block_frames
        zeros_row = torch.zeros((self.batch, f), dtype=torch.float32,
                                device=self.device)
        silent = torch.ones((self.batch,), dtype=torch.bool, device=self.device)
        # the live-outs go straight into one f32[B, K, n_out, F] (and its
        # flags), block by block: an island that reads them all takes it as
        # its live-in operand without another copy (:func:`_packed`)
        n = len(out_bufs)
        outs = torch.empty((self.batch, len(infos), n, f), dtype=torch.float32,
                           device=self.device)
        oflags = torch.empty((self.batch, len(infos), n), dtype=torch.bool,
                             device=self.device)
        for k, info in enumerate(infos):
            bufs = {b: rows[b][:, k] for b in in_bufs}
            fl = {b: flags[b][:, k] for b in in_bufs}
            new_state: dict[str, Any] = {}
            prog._walk_segment(params, state, bufs, fl, info, plan, new_state,
                               zeros_row, silent)
            state = new_state
            if n:
                outs[:, k] = torch.stack([bufs[b] for b in out_bufs], 1)
                oflags[:, k] = torch.stack([fl[b] for b in out_bufs], 1)
        return ({b: outs[:, :, j] for j, b in enumerate(out_bufs)},
                {b: oflags[:, :, j] for j, b in enumerate(out_bufs)}, state)

    def _island(self, i, params, state, rows, flags, start_sample):
        """Island ``i`` over the batch, all K blocks: the kernel on a CUDA
        device, its plain version on the CPU."""
        lw = self.islands[i]
        in_bufs = self._live_in[i]
        b, k, f = self.batch, self.num_blocks, lw.frames
        if in_bufs:
            env = _packed([rows[j] for j in in_bufs])
            env_flags = _packed([flags[j] for j in in_bufs])
            if env is None or env_flags is None:
                env = torch.stack([rows[j] for j in in_bufs], 2)
                env_flags = torch.stack([flags[j] for j in in_bufs], 2)
        else:
            env = torch.zeros((b, k, 0, f), dtype=torch.float32, device=self.device)
            env_flags = torch.zeros((b, k, 0), dtype=torch.bool, device=self.device)
        if self.device.type == "cpu":
            out, out_flags, st = island_chunk_reference(
                self.program, lw, params, state, env, env_flags, start_sample,
                k, b)
        elif self.device.type == "cuda":
            out, out_flags, st = self._launch(i, params, state, env, env_flags)
        else:
            raise ValueError(f"HybridMegaRenderer: unsupported device {self.device}")
        live_out = self._live_out[i]
        return ({buf: out[:, :, j] for j, buf in enumerate(live_out)},
                {buf: out_flags[:, :, j] for j, buf in enumerate(live_out)}, st)

    def _launch(self, i, params, state, env, env_flags):
        """One launch of the island kernel (K3) for island ``i``."""
        lw, dev = self.islands[i], self.device
        if i not in self._operands:
            self._operands[i] = KernelOperands(
                self.program, lw, self.batch, self.num_blocks, self.tile, dev,
                "HybridMegaRenderer")
        ko = self._operands[i]
        in_bufs = ko.tables[-1]
        env, env_flags = env.contiguous(), env_flags.contiguous()
        values, ptrs, new, scratch, stride = ko.chunk(params, state)
        n_out = lw.out_row.shape[0]
        out = torch.empty((self.batch, self.num_blocks, n_out, lw.frames),
                          dtype=torch.float32, device=dev)
        out_flags = torch.empty((self.batch, self.num_blocks, n_out),
                                dtype=torch.bool, device=dev)
        lib = LIBRARY.load()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.fw_island_render(
                *ko.args(ptrs, out, out_flags, scratch, stride, stream),
                in_bufs.data_ptr(), lw.in_bufs.size, env.data_ptr(),
                env_flags.data_ptr(),
            )
        del values  # enqueued: the stream orders any reuse after the kernel
        if err != 0:
            raise RuntimeError(
                f"HybridMegaRenderer: island kernel launch failed (cudaError {err})")
        HybridMegaRenderer.launches += 1
        return out, out_flags, _new_state_tree(state, lw, new)

    # -- a chunk ----------------------------------------------------------------
    def render_chunk(self, params, state, graph_in=None, in_mask=None,
                     start_sample=0):
        prog = self.program
        b, k, f = self.batch, self.num_blocks, prog.max_block_frames
        sched = prog.schedule.schedule
        refuse_timelines(params, "HybridMegaRenderer")
        refuse_gradients("HybridMegaRenderer (K3)", params, state, graph_in)
        params = params_from_jax(params, self.device)
        if graph_in is None:
            graph_in = torch.zeros((b, k, prog.num_graph_inputs, f),
                                   dtype=torch.float32, device=self.device)
        if in_mask is None:
            in_mask = torch.ones((b, k, prog.num_graph_inputs), dtype=torch.bool,
                                 device=self.device)
        infos = _chunk_clocks(prog, start_sample, k, self.device)

        rows: dict[int, torch.Tensor] = {}   # buffer → f32[B, K, F]
        flags: dict[int, torch.Tensor] = {}  # buffer → bool[B, K]
        for j, ob in enumerate(sched[0].output_buffers):
            rows[ob.buffer_index] = graph_in[:, :, j]
            flags[ob.buffer_index] = in_mask[:, :, j]
        new_state: dict[str, Any] = {}
        for i, (kind, _) in enumerate(self.segments):
            pseg = {key: params[key] for key in self._keys[i]}
            sseg = {key: state[key] for key in self._keys[i]}
            if kind == "mega":
                out, out_flags, st = self._island(i, pseg, sseg, rows, flags,
                                                  start_sample)
            else:
                out, out_flags, st = self._torch_stage(i, pseg, sseg, rows,
                                                       flags, infos)
            rows.update(out)
            flags.update(out_flags)
            new_state.update(st)
        for sentinel in (sched[0], sched[-1]):
            key = node_key(sentinel.id)
            if key in prog._procs:
                new_state[key] = state[key]

        # graph outputs: flagged channels read as zero
        if not self._out_bufs:
            return (torch.zeros((b, k, 0, f), dtype=torch.float32, device=self.device),
                    torch.zeros((b, k, 0), dtype=torch.bool, device=self.device),
                    new_state)
        zeros = torch.zeros((b, k, f), dtype=torch.float32, device=self.device)
        silent = torch.ones((b, k), dtype=torch.bool, device=self.device)
        out_rows, out_flags = [], []
        for buf in self._out_bufs:
            if buf is None:
                out_rows.append(zeros)
                out_flags.append(silent)
            else:
                out_rows.append(rows[buf].masked_fill(flags[buf][..., None], 0.0))
                out_flags.append(flags[buf])
        return torch.stack(out_rows, 2), torch.stack(out_flags, 2), new_state
