"""The main-thread graph context: compile/ship/retire schedules.

PyTorch port of ``firewheel_tpu/context.py``.  Mirrors
``crates/firewheel-graph/src/context.rs`` (``FirewheelGraphCtx``):
``activate`` wires a bounded channel pair and builds the processor;
``update()`` — called every game frame — drains processor messages,
recompiles the dirty graph and ships the new schedule; ``deactivate``
performs the bounded-timeout stop handshake (3 s / 2 ms poll,
context.rs:15-16).  Edits are compiled here, on the context's side, and
the schedule travels to the processor over the channel.
"""

from __future__ import annotations

import dataclasses
import enum
import logging
import time
from typing import Any, Optional

import torch

from .channels import ChannelFull, MessageChannel, channel_pair
from .graph.errors import CompileGraphError
from .graph.graph import AudioGraph, AudioGraphConfig
from .device import DEFAULT_DEVICE, resolve_device
from .processor import ContextToProcessorMsg, GraphProcessor

log = logging.getLogger(__name__)

__all__ = ["UpdateStatus", "UpdateResult", "GraphContext"]

CLOSE_STREAM_TIMEOUT = 3.0  # context.rs:15
CLOSE_STREAM_SLEEP_INTERVAL = 0.002  # context.rs:16


class UpdateStatus(enum.Enum):
    """context.rs:245-254."""

    INACTIVE = "inactive"
    ACTIVE = "active"
    DEACTIVATED = "deactivated"


@dataclasses.dataclass
class UpdateResult:
    status: UpdateStatus
    graph_error: Optional[CompileGraphError] = None
    error: Optional[BaseException] = None
    returned_user_cx: Any = None


@dataclasses.dataclass
class _ActiveState:
    to_executor: MessageChannel
    from_executor: MessageChannel
    sample_rate: int
    max_block_frames: int


class GraphContext:
    """Owns the :class:`AudioGraph` and the channel to the processor."""

    def __init__(self, graph_config: AudioGraphConfig = AudioGraphConfig()):
        self.graph = AudioGraph(graph_config)
        self._active: Optional[_ActiveState] = None

    # -- lifecycle (context.rs:46-89) -----------------------------------------
    def activate(
        self,
        sample_rate: int,
        num_stream_in_channels: int,
        num_stream_out_channels: int,
        max_block_frames: int,
        user_cx: Any = None,
        chunk_blocks: int = 1,
        deferred_swap: bool = False,
        device: str | torch.device = DEFAULT_DEVICE,
    ) -> Optional[GraphProcessor]:
        """Create the processor on ``device`` (the card unless the caller
        passes ``"cpu"``); ``None`` if already active.

        ``deferred_swap``: stage live topology edits while the old schedule
        keeps rendering, and install them at ``GraphProcessor.
        advance_pending`` (the streaming backend's live-edit mode)."""
        assert sample_rate != 0
        assert max_block_frames > 0
        if self._active is not None:
            return None
        device = resolve_device(device)  # raises before anything activates

        to_executor, from_executor = channel_pair()
        self._active = _ActiveState(
            to_executor, from_executor, sample_rate, max_block_frames
        )
        return GraphProcessor(
            from_ctx=to_executor,
            to_ctx=from_executor,
            num_stream_in_channels=num_stream_in_channels,
            num_stream_out_channels=num_stream_out_channels,
            sample_rate=sample_rate,
            max_block_frames=max_block_frames,
            user_cx=user_cx,
            chunk_blocks=chunk_blocks,
            deferred_swap=deferred_swap,
            device=device,
        )

    def is_activated(self) -> bool:
        return self._active is not None

    # -- per-frame pump (context.rs:93-148) -----------------------------------
    def update(self) -> UpdateResult:
        self.graph.update()

        if self._active is None:
            return UpdateResult(UpdateStatus.INACTIVE)

        dropped, dropped_user_cx = self._update_internal()
        if dropped:
            self.graph.deactivate()
            self._active = None
            return UpdateResult(
                UpdateStatus.DEACTIVATED, returned_user_cx=dropped_user_cx
            )

        state = self._active
        if self.graph.needs_compile():
            try:
                package = self.graph.compile(
                    state.sample_rate, state.max_block_frames
                )
            except CompileGraphError as e:
                return UpdateResult(UpdateStatus.ACTIVE, graph_error=e)
            try:
                state.to_executor.push(
                    ContextToProcessorMsg(new_schedule=package)
                )
            except ChannelFull:
                log.error(
                    "Failed to send new schedule: message channel is full"
                )
                self.graph.on_schedule_returned(package)
        return UpdateResult(UpdateStatus.ACTIVE)

    # -- shutdown handshake (context.rs:162-211) ------------------------------
    def deactivate(self, stream_is_running: bool = True, pump=None) -> Any:
        """``pump``: optional callable invoked while waiting for the drop
        handshake — used by single-threaded streaming backends to drive the
        processor (which otherwise runs on an audio thread in the
        reference)."""
        if self._active is None:
            return None
        state = self._active
        start = time.monotonic()
        dropped = False
        dropped_user_cx = None

        if stream_is_running:
            while True:
                try:
                    state.to_executor.push(ContextToProcessorMsg(stop=True))
                    break
                except ChannelFull:
                    log.error("Failed to send stop signal: channel full")
                    time.sleep(CLOSE_STREAM_SLEEP_INTERVAL)
                    if time.monotonic() - start > CLOSE_STREAM_TIMEOUT:
                        log.error("Timed out sending stop signal")
                        dropped = True
                        break

        while not dropped:
            if pump is not None:
                pump()
            d, cx = self._update_internal()
            if d:
                dropped, dropped_user_cx = True, cx
                break
            time.sleep(CLOSE_STREAM_SLEEP_INTERVAL)
            if time.monotonic() - start > CLOSE_STREAM_TIMEOUT:
                log.error("Timed out waiting for processor drop")
                break

        self.graph.deactivate()
        self._active = None
        return dropped_user_cx

    def _update_internal(self):
        """Drain processor→context messages (context.rs:213-235)."""
        if self._active is None:
            return False, None
        dropped = False
        dropped_user_cx = None
        while True:
            msg = self._active.from_executor.pop()
            if msg is None:
                break
            if msg.returned_schedule is not None:
                self.graph.on_schedule_returned(msg.returned_schedule)
            if msg.is_dropped:
                if msg.dropped_nodes:
                    self.graph.on_processor_dropped(msg.dropped_nodes)
                dropped = True
                dropped_user_cx = msg.dropped_user_cx
        return dropped, dropped_user_cx

    def __del__(self):
        try:
            if self.is_activated():
                self.deactivate(True)
        except Exception:
            pass
