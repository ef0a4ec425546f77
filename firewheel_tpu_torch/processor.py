"""The graph processor: the render-side executor with live schedule swaps.

PyTorch port of ``firewheel_tpu/processor.py`` (reference:
``crates/firewheel-graph/src/processor.rs``, ``FirewheelProcessor``).  It
owns the node processors and their recurrent state, receives compiled
schedules over a bounded channel, splits stream buffers into blocks, and
ships retired schedules and processors back to the context so nothing is
deallocated on the render path (processor.rs:167-206, 251-263).

The state is a dict of tensors on the processor's device, keyed by node.
It migrates across schedule swaps: surviving nodes keep their tensors, new
nodes get ``init_state()``, removed nodes' processors go back to the
context, and activated nodes that the schedule leaves out (dormancy
pruning) park their state until a later schedule brings them back.

A dispatch renders K blocks.  Its params (with their per-block timelines),
the blocks' clocks and the graph inputs are staged in one host buffer,
pinned on a CUDA device, and cross to the device in one copy; the outputs
and masks come back in two asynchronous copies into pinned memory that
:meth:`GraphProcessor.finish_interleaved` waits for.
"""

from __future__ import annotations

import dataclasses
import enum
import logging
from typing import Any, Optional

import numpy as np
import torch

from .channels import ChannelFull, MessageChannel
from .convert import state_from_jax, state_to_numpy, tree_map
from .core.interleave import deinterleave, interleave, interleave_stereo
from .core.node import BlockInfo, NodeProcessor, StreamStatus
from .core.silence_mask import mask_from_bools, mask_to_bools
from .device import DEFAULT_DEVICE, resolve_device
from .executor import ScheduleProgram, node_key, split_timelines
from .graph.compiler import NodeID
from .graph.graph import SchedulePackage

log = logging.getLogger(__name__)

__all__ = [
    "ProcessorStatus",
    "ContextToProcessorMsg",
    "ProcessorToContextMsg",
    "GraphProcessor",
]


class ProcessorStatus(enum.Enum):
    """processor.rs:11-16."""

    OK = "ok"
    DROP_PROCESSOR = "drop_processor"


@dataclasses.dataclass
class ContextToProcessorMsg:
    """processor.rs:265-268: NewSchedule(package) | Stop."""

    new_schedule: Optional[SchedulePackage] = None
    stop: bool = False


@dataclasses.dataclass
class ProcessorToContextMsg:
    """processor.rs:270-277: ReturnSchedule(package) | Dropped{...}."""

    returned_schedule: Optional[SchedulePackage] = None
    dropped_nodes: Optional[dict[NodeID, NodeProcessor]] = None
    dropped_user_cx: Any = None
    is_dropped: bool = False


@dataclasses.dataclass
class _InflightChunk:
    """One dispatched, unfetched render (:meth:`GraphProcessor.
    dispatch_interleaved`): host tensors ``outs [k, n_go, frames]`` and
    ``oms [k, n_go]`` that the device fills asynchronously, and the CUDA
    event recorded after those copies (None on the CPU).  ``n_go`` is
    captured because a schedule swap may change the port count before the
    fetch."""

    outs: torch.Tensor
    oms: torch.Tensor
    event: Any
    k: int
    n_go: int


@dataclasses.dataclass
class _PendingSchedule:
    """A staged schedule: the old one keeps rendering until
    :meth:`GraphProcessor.advance_pending` has rendered the new program
    once (which builds any kernel it launches) and swaps it in."""

    package: SchedulePackage
    program: ScheduleProgram
    #: processors added then removed while pending (deactivated via the
    #: returned package, never installed)
    extra_removed: list


_NUMPY_TO_TORCH = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.bool_): torch.bool,
}


class _Stager:
    """Moves one dispatch's host arrays to the device in one copy.

    Every numpy leaf (uint32 as int64, the port's carrier) is written into
    one host byte buffer, pinned on a CUDA device, at an 8-byte aligned
    offset; the buffer crosses with one asynchronous copy, and each leaf is
    a view of the device copy.  The buffer is fresh each dispatch, so a
    copy still in flight never sees it rewritten (PyTorch's pinned-memory
    cache reuses a block only after its copies complete).  Tensor leaves
    (a sampler's clip) are copied to the device once and reused while the
    node hands over the same tensor."""

    def __init__(self, device: torch.device):
        self.device = device
        self._tensors: dict[tuple, tuple] = {}

    def _device_tensor(self, path, t: torch.Tensor) -> torch.Tensor:
        hit = self._tensors.get(path)
        if hit is None or hit[0] is not t:
            hit = (t, t.to(self.device))
            self._tensors[path] = hit
        return hit[1]

    def stage(self, tree: dict) -> dict:
        """A nested dict of numpy arrays, numpy scalars and tensors → the
        same dict of tensors on the device."""
        leaves = []  # (path, shape, flat array) of the host leaves
        tensors = {}

        def walk(d, prefix):
            for k, v in d.items():
                path = prefix + (k,)
                if isinstance(v, dict):
                    walk(v, path)
                elif isinstance(v, tuple) and not v:
                    pass  # a stateless node's empty tree
                elif isinstance(v, torch.Tensor):
                    tensors[path] = self._device_tensor(path, v)
                else:
                    a = np.asarray(v)
                    if a.dtype == np.uint32:
                        a = a.astype(np.int64)
                    leaves.append((path, a.shape, np.ascontiguousarray(a).reshape(-1)))

        walk(tree, ())
        offsets, total = [], 0
        for _, _, a in leaves:
            offsets.append(total)
            total += (a.nbytes + 7) & ~7
        pinned = self.device.type == "cuda"
        host = torch.empty(max(total, 8), dtype=torch.uint8, pin_memory=pinned)
        view = host.numpy()
        for (_, _, a), off in zip(leaves, offsets):
            view[off:off + a.nbytes] = a.view(np.uint8)
        dev = host.to(self.device, non_blocking=True) if pinned else host
        out = {}
        for (path, shape, a), off in zip(leaves, offsets):
            t = dev[off:off + a.nbytes].view(_NUMPY_TO_TORCH[a.dtype]).reshape(shape)
            _put(out, path, t)
        for path, t in tensors.items():
            _put(out, path, t)
        _empty_trees(tree, out)
        return out


def _put(tree: dict, path: tuple, v) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = v


def _empty_trees(src: dict, dst: dict) -> None:
    """Give ``dst`` an empty dict wherever ``src`` has an empty tree."""
    for k, v in src.items():
        if isinstance(v, dict):
            _empty_trees(v, dst.setdefault(k, {}))
        elif isinstance(v, tuple) and not v:
            dst.setdefault(k, {})


class GraphProcessor:
    """Render-side half of the engine (FirewheelProcessor analog)."""

    def __init__(
        self,
        from_ctx: MessageChannel,
        to_ctx: MessageChannel,
        num_stream_in_channels: int,
        num_stream_out_channels: int,
        sample_rate: int,
        max_block_frames: int,
        user_cx: Any = None,
        chunk_blocks: int = 1,
        deferred_swap: bool = False,
        device: str | torch.device = DEFAULT_DEVICE,
    ):
        """``chunk_blocks``: up to that many blocks render in one dispatch
        (the reference polls messages and params per block,
        processor.rs:214; a chunk polls them once, and per-block timelines
        keep scheduled changes block-accurate).

        ``deferred_swap``: stage incoming schedules instead of installing
        them at the next dispatch: the old schedule keeps rendering until
        :meth:`advance_pending` has rendered the new program once, then the
        state-migrating swap happens.  The streaming backend turns this on.

        ``device``: where the state lives and the graph renders; the card
        unless the caller passes ``"cpu"``."""
        assert num_stream_in_channels <= 64
        assert num_stream_out_channels <= 64
        self.chunk_blocks = max(1, int(chunk_blocks))
        self._from_ctx = from_ctx
        self._to_ctx = to_ctx
        self.num_stream_in_channels = num_stream_in_channels
        self.num_stream_out_channels = num_stream_out_channels
        self.sample_rate = int(sample_rate)
        self.max_block_frames = int(max_block_frames)
        self.user_cx = user_cx
        self.deferred_swap = bool(deferred_swap)
        self.device = resolve_device(device)

        self._processors: dict[NodeID, NodeProcessor] = {}
        self._package: Optional[SchedulePackage] = None
        self._program: Optional[ScheduleProgram] = None
        self._pending: Optional[_PendingSchedule] = None
        #: the scheduled nodes' state, tensors on ``device``
        self._state: dict[str, Any] = {}
        #: state of activated-but-unscheduled nodes (dormancy pruning),
        #: revived when a recompile reschedules them
        self._parked_state: dict[str, Any] = {}
        #: last-seen event-counter totals, keyed ``(node_key, event_name)``:
        #: the poll_events() baseline
        self._event_totals: dict[tuple, np.ndarray] = {}
        self._stager = _Stager(self.device)
        self._running = True

    # -- message pump (processor.rs:167-206) ----------------------------------
    def poll_messages(self) -> None:
        while True:
            msg = self._from_ctx.pop()
            if msg is None:
                return
            if msg.stop:
                self._running = False
            elif msg.new_schedule is not None:
                self._install_schedule(msg.new_schedule)

    def _install_schedule(self, new_package: SchedulePackage) -> None:
        assert new_package.schedule.max_block_frames == self.max_block_frames
        if self._program is not None and self.deferred_swap:
            self._stage_schedule(new_package)
        else:
            self._swap_schedule(new_package)

    def _init_state(self, proc: NodeProcessor):
        return tree_map(lambda t: t.to(self.device), proc.init_state())

    def _swap_schedule(
        self,
        new_package: SchedulePackage,
        program: Optional[ScheduleProgram] = None,
        extra_removed: tuple = (),
    ) -> None:
        old_package = self._package
        state = self.state_dict()

        # Retire removed nodes: processors go back for deactivation
        # (processor.rs:176-193); their state is dropped.
        if old_package is not None:
            for node_id in new_package.nodes_to_remove:
                proc = self._processors.pop(node_id, None)
                if proc is not None:
                    old_package.removed_node_processors.append((node_id, proc))
                state.pop(node_key(node_id), None)
            old_package.removed_node_processors.extend(extra_removed)
            try:
                self._to_ctx.push(
                    ProcessorToContextMsg(returned_schedule=old_package)
                )
            except ChannelFull:  # pragma: no cover
                log.error("processor→context channel full; dropping schedule")

        # Install new processors and their initial state.
        for node_id, proc in new_package.new_node_processors:
            assert node_id not in self._processors
            self._processors[node_id] = proc
            state[node_key(node_id)] = self._init_state(proc)
        new_package.new_node_processors = []

        self._package = new_package
        self._program = program or ScheduleProgram(
            new_package.schedule, self._processors, self.sample_rate,
            device=self.device,
        )
        # Scheduled nodes render; activated-but-unscheduled ones park and
        # resume frozen when a recompile brings them back; removed nodes'
        # state goes.
        live = {node_key(nid) for nid in self._processors}
        sched = {node_key(sn.id) for sn in new_package.schedule.schedule}
        for k in list(state):
            if k not in live:
                state.pop(k)
                self._parked_state.pop(k, None)
            elif k not in sched:
                self._parked_state[k] = state.pop(k)
        for k in sched & set(self._parked_state):
            state.setdefault(k, self._parked_state.pop(k))
        # drop event baselines of removed nodes: a later node reusing the
        # arena id starts its counters at 0
        self._event_totals = {
            kn: v for kn, v in self._event_totals.items() if kn[0] in live
        }
        self._state = {k: v for k, v in state.items() if k in self._program._procs}

    # -- deferred install (live-edit path) -------------------------------------
    def _stage_schedule(self, new_package: SchedulePackage) -> None:
        """Stage an incoming schedule; the old one keeps rendering until
        :meth:`advance_pending` installs it.  A schedule arriving while
        another is staged merges into it: the superseded one was never
        installed, so its adds and removes fold into the new package
        relative to the live processor set."""
        extra_removed: list = []
        if self._pending is not None:
            prev = self._pending.package
            extra_removed = self._pending.extra_removed
            dead = set(new_package.nodes_to_remove)
            merged_new = []
            for nid, proc in (
                prev.new_node_processors + new_package.new_node_processors
            ):
                if nid in dead:
                    extra_removed.append((nid, proc))
                else:
                    merged_new.append((nid, proc))
            new_package.nodes_to_remove = list(dict.fromkeys(
                prev.nodes_to_remove + new_package.nodes_to_remove
            ))
            new_package.new_node_processors = merged_new
            self._pending = None

        future = dict(self._processors)
        for nid in new_package.nodes_to_remove:
            future.pop(nid, None)
        future.update(dict(new_package.new_node_processors))
        program = ScheduleProgram(
            new_package.schedule, future, self.sample_rate, device=self.device
        )
        self._pending = _PendingSchedule(new_package, program, extra_removed)

    def has_pending(self) -> bool:
        return self._pending is not None

    def advance_pending(self) -> None:
        """Render the staged schedule's program once, on throwaway state
        (which builds any kernel it launches for the first time), then
        install it with the state-migrating swap.  Called between stream
        buffers: the old schedule renders until then.  A staged program that
        fails to render is dropped, and the running one goes on."""
        pend = self._pending
        if pend is None:
            return
        try:
            self._throwaway_render(pend.program, {
                key: self._init_state(proc) for key, proc in pend.program._procs.items()
            })
        except Exception as e:  # pragma: no cover - device-dependent
            log.error("staged schedule failed to render (%s); keeping the "
                      "running schedule", e)
            self._abandon_pending()
            return
        self._pending = None
        self._swap_schedule(pend.package, program=pend.program,
                            extra_removed=tuple(pend.extra_removed))

    def _abandon_pending(self) -> None:
        """Drop the staged schedule, handing its never-installed processors
        back for deactivation."""
        pend, self._pending = self._pending, None
        try:
            self._to_ctx.push(ProcessorToContextMsg(returned_schedule=SchedulePackage(
                pend.package.schedule, [], [],
                removed_node_processors=list(pend.package.new_node_processors)
                + list(pend.extra_removed),
            )))
        except ChannelFull:  # pragma: no cover
            log.error("could not return abandoned pending schedule")

    def _throwaway_render(self, program: ScheduleProgram, state, k: int = 1) -> None:
        """Render ``k`` silent blocks and discard them: rendering is pure, so
        this advances nothing and consumes no scheduled change."""
        f = self.max_block_frames
        n_gi = program.num_graph_inputs
        self._render(program, state, np.zeros((k, n_gi, f), np.float32),
                     np.ones((k, n_gi), bool), 0, f, StreamStatus.NONE,
                     consume=False)

    # -- state -----------------------------------------------------------------
    def state_dict(self) -> dict:
        """Per-node state (tensors on the device), parked nodes included."""
        out = dict(self._parked_state)
        out.update(self._state)
        return out

    def set_state_dict(self, state: dict) -> None:
        """Install a state dict (tensors on any device, or numpy with
        uint32 leaves) for the current schedule; a processor adopts restored sequence numbers, and event
        baselines move to the restored totals."""
        assert self._program is not None
        state = {k: state_from_jax(v, self.device) for k, v in state.items()}
        for k, v in state.items():
            if k not in self._program._procs and k in self._parked_state:
                self._parked_state[k] = v
        self._state = {k: state[k] for k in self._program._procs}
        for nid, proc in self._processors.items():
            st = state.get(node_key(nid))
            if st is not None:
                proc.resync_from_state(st)
        self._sync_event_baselines()

    def node_state(self, node_id: NodeID):
        """Host copy of a node's state (numpy, uint32 leaves as uint32), or
        None for an unknown node."""
        st = self.state_dict().get(node_key(node_id))
        return None if st is None else state_to_numpy(st)

    # -- events ----------------------------------------------------------------
    def _counters(self):
        """``(node_id, event_name, totals int64[lanes], scalar)`` for every
        declared event counter: one host fetch per counter leaf."""
        state = self.state_dict()
        for nid, proc in self._processors.items():
            st = state.get(node_key(nid))
            if st is None:
                continue
            for name, leaf in proc.event_counters().items():
                if leaf in st:
                    raw = st[leaf].cpu().numpy()
                    cur = np.atleast_1d(raw).astype(np.int64) & 0xFFFFFFFF
                    yield nid, name, cur, raw.ndim == 0

    def _sync_event_baselines(self) -> None:
        for nid, name, cur, _ in self._counters():
            self._event_totals[(node_key(nid), name)] = cur

    def poll_events(self):
        """Drain pending node events (``list[NodeEvent]``): each declared
        counter (:meth:`NodeProcessor.event_counters`) diffed against its
        last-polled total, one :class:`~firewheel_tpu_torch.core.events.
        NodeEvent` per active (node, event[, lane]).  Counters migrate
        across schedule swaps, so no event is lost over a topology edit."""
        from .core.events import NodeEvent, diff_counters

        out: list = []
        for nid, name, cur, scalar in self._counters():
            bkey = (node_key(nid), name)
            prev = self._event_totals.get(bkey)
            if prev is None or prev.shape != cur.shape:
                prev = np.zeros_like(cur)
            delta = diff_counters(prev, cur)
            self._event_totals[bkey] = cur
            for lane in np.nonzero(delta)[0]:
                out.append(NodeEvent(
                    node_id=nid, name=name, count=int(delta[lane]),
                    total=int(cur[lane]), lane=None if scalar else int(lane),
                ))
        return out

    def warmup(self) -> None:
        """Install any pending schedule and render the program once at its
        chunk size, on throwaway state: every kernel it launches is built
        then (the sequential biquad's nvcc build), not in the stream."""
        self.poll_messages()
        self.advance_pending()
        if self._program is not None:
            self._throwaway_render(self._program, self._state, self.chunk_blocks)

    # -- hot path (processor.rs:61-165) ---------------------------------------
    def _render(self, program, state, gi, im, start_sample: int, frames: int,
                stream_status, consume: bool = True):
        """Render ``k = gi.shape[0]`` blocks of ``frames`` (``gi f32[k, Ni,
        frames]``, ``im bool[k, Ni]``) from ``state`` → ``(outs f32[k, No,
        frames], oms bool[k, No], state')`` on the device.  Params, their
        timelines, the clocks and the inputs cross in one staged copy."""
        k = gi.shape[0]
        blocks = k if frames == self.max_block_frames else frames / self.max_block_frames
        params, timelines = split_timelines(program.collect_params(
            blocks=blocks, start_sample=start_sample, frames=frames,
            consume=consume))
        if k == 1:
            timelines = {}  # block 0's values are the placeholders
        samples, times = program.block_clocks(start_sample, k, frames, "cpu")
        staged = self._stager.stage({
            "params": params,
            "timelines": {str(i): v for i, v in enumerate(timelines.values())},
            "gi": gi, "im": im, "samples": samples.numpy(), "times": times.numpy(),
            "status": np.int64(int(stream_status)),
        })
        tl = {path: staged["timelines"][str(i)] for i, path in enumerate(timelines)}
        infos = [BlockInfo(stream_time_secs=staged["times"][b],
                           stream_sample=staged["samples"][b],
                           stream_status=staged["status"]) for b in range(k)]
        return program.render_blocks(staged["params"], tl, state, staged["gi"],
                                     staged["im"], infos)

    def _dispatch(self, program, input_buffer, num_in_channels, offset, k,
                  frames, stream_time_secs, stream_status) -> _InflightChunk:
        """Launch ``k`` blocks of ``frames`` starting ``offset`` frames into
        the buffer, without waiting for the device.  ``self._state``
        advances to the dispatch's (in-flight) state at once: later
        dispatches chain on it on the device."""
        n_gi = program.num_graph_inputs
        gi = np.zeros((k, n_gi, frames), np.float32)
        im = np.ones((k, n_gi), bool)
        if n_gi > 0 and num_in_channels > 0:
            for b in range(k):
                off = offset + b * frames
                mask = deinterleave(
                    gi[b],
                    input_buffer[off * num_in_channels:(off + frames) * num_in_channels],
                    num_in_channels,
                    True,
                )
                im[b] = mask_to_bools(mask, n_gi)
        start_sample = offset + int(round(stream_time_secs * self.sample_rate))
        outs, oms, self._state = self._render(
            program, self._state, gi, im, start_sample, frames, stream_status)
        if self.device.type != "cuda":
            return _InflightChunk(outs, oms, None, k, program.num_graph_outputs)
        host_outs = torch.empty(outs.shape, dtype=outs.dtype, pin_memory=True)
        host_oms = torch.empty(oms.shape, dtype=oms.dtype, pin_memory=True)
        host_outs.copy_(outs, non_blocking=True)
        host_oms.copy_(oms, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return _InflightChunk(host_outs, host_oms, event, k, program.num_graph_outputs)

    def _finish(self, inflight: _InflightChunk, output_buffer, num_out_channels,
                offset: int = 0) -> None:
        """Wait for a dispatch's outputs and interleave them into
        ``output_buffer`` from frame ``offset``."""
        if inflight.event is not None:
            inflight.event.synchronize()
        outs, oms = inflight.outs.numpy(), inflight.oms.numpy()
        f = outs.shape[-1]
        for b in range(inflight.k):
            off = offset + b * f
            out_view = output_buffer[off * num_out_channels:(off + f) * num_out_channels]
            out_mask = mask_from_bools(oms[b])
            if inflight.n_go == 2 and num_out_channels == 2:
                interleave_stereo(outs[b, 0], outs[b, 1], out_view, out_mask)
            else:
                interleave(outs[b], out_view, num_out_channels, out_mask)

    def process_interleaved(
        self,
        input_buffer: np.ndarray,
        output_buffer: np.ndarray,
        num_in_channels: int,
        num_out_channels: int,
        frames: int,
        stream_time_secs: float,
        stream_status: StreamStatus = StreamStatus.NONE,
    ) -> ProcessorStatus:
        """Render ``frames`` into the interleaved ``output_buffer`` and wait
        for them: dispatches of up to ``chunk_blocks`` whole blocks, then
        one short block for a remainder, whose state advances by exactly
        its frames."""
        if not self._running:
            output_buffer[:] = 0.0
            return ProcessorStatus.DROP_PROCESSOR

        if self._program is None:
            self.poll_messages()
            if not self._running:
                output_buffer[:] = 0.0
                return ProcessorStatus.DROP_PROCESSOR

        if self._program is None or frames == 0:
            output_buffer[:] = 0.0
            return ProcessorStatus.OK

        assert input_buffer.size == frames * num_in_channels
        assert output_buffer.size == frames * num_out_channels

        f = self.max_block_frames
        frames_processed = 0
        while frames_processed < frames:
            self.poll_messages()
            if not self._running:
                output_buffer[frames_processed * num_out_channels:] = 0.0
                break
            # a swap above may have changed the program and its port counts
            program = self._program
            remaining_blocks = (frames - frames_processed) // f
            if remaining_blocks > 0:
                k, block = min(remaining_blocks, self.chunk_blocks), f
            else:
                k, block = 1, frames - frames_processed
            inflight = self._dispatch(program, input_buffer, num_in_channels,
                                      frames_processed, k, block,
                                      stream_time_secs, stream_status)
            self._finish(inflight, output_buffer, num_out_channels, frames_processed)
            frames_processed += k * block

        return ProcessorStatus.OK if self._running else ProcessorStatus.DROP_PROCESSOR

    def dispatch_interleaved(
        self,
        input_buffer: np.ndarray,
        num_in_channels: int,
        frames: int,
        stream_time_secs: float,
        stream_status: StreamStatus = StreamStatus.NONE,
    ) -> Optional[_InflightChunk]:
        """Pipelined render: launch ONE dispatch for ``frames`` and return
        its in-flight handle, or ``None`` when the span is not a whole
        number of blocks within ``chunk_blocks`` (or the processor is
        stopping): the caller then renders it with
        :meth:`process_interleaved`.  The host stages the next dispatch
        while the device renders this one; the caller must pass every
        handle to :meth:`finish_interleaved` in order, before any
        synchronous render."""
        if not self._running or self._program is None:
            return None
        self.poll_messages()
        if not self._running or self._program is None:
            return None
        f = self.max_block_frames
        k = frames // f
        if k < 1 or k * f != frames or k > self.chunk_blocks:
            return None
        return self._dispatch(self._program, input_buffer, num_in_channels, 0,
                              k, f, stream_time_secs, stream_status)

    def finish_interleaved(
        self,
        inflight: _InflightChunk,
        output_buffer: np.ndarray,
        num_out_channels: int,
    ) -> None:
        """Wait for and interleave a handle from :meth:`dispatch_interleaved`."""
        self._finish(inflight, output_buffer, num_out_channels)

    # -- shutdown (processor.rs:251-263) --------------------------------------
    def drop(self) -> None:
        """Ship all node processors back to the context for deactivation."""
        nodes = dict(self._processors)
        if self._pending is not None:
            # never-installed pending processors still need deactivation
            nodes.update(dict(self._pending.package.new_node_processors))
            nodes.update(dict(self._pending.extra_removed))
        self._pending = None
        self._processors = {}
        try:
            self._to_ctx.push(
                ProcessorToContextMsg(
                    dropped_nodes=nodes,
                    dropped_user_cx=self.user_cx,
                    is_dropped=True,
                )
            )
        except ChannelFull:  # pragma: no cover
            log.error("could not return dropped nodes: channel full")
        self.user_cx = None

    @property
    def running(self) -> bool:
        return self._running
