"""FirewheelCtx: the top-level engine context with a streaming backend.

PyTorch port of ``firewheel_tpu/backend/context.py``.  Mirrors ``crates/firewheel-cpal/src/lib.rs`` (``FirewheelCpalCtx``):
``activate`` builds the output stream + processor and hands the processor to
the stream; ``update()`` pumps the graph context and pops the stream-error
channel, deactivating cleanly on stream failure and returning the user
context so the caller can re-activate on a new device (the fault-tolerance
headline, README.md:24).  The graph renders on ``device``, the card
unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Optional

import torch

from ..channels import MessageChannel
from ..context import GraphContext, UpdateResult, UpdateStatus
from ..device import DEFAULT_DEVICE, resolve_device
from ..graph.graph import AudioGraph, AudioGraphConfig
from .device_info import DeviceInfo, available_output_devices
from .stream import OutputStream, StreamConfig

log = logging.getLogger(__name__)

__all__ = ["FirewheelCtx"]

MSG_CHANNEL_CAPACITY = 4  # firewheel-cpal/src/lib.rs:13


@dataclasses.dataclass
class _ActiveStream:
    stream: OutputStream
    from_err: MessageChannel
    out_device_name: str
    config: StreamConfig


class FirewheelCtx:
    """The engine facade (``FirewheelCtx`` alias, src/lib.rs:8)."""

    def __init__(self, graph_config: AudioGraphConfig = AudioGraphConfig(),
                 device: str | torch.device = DEFAULT_DEVICE):
        from ..core.automation import ParamAutomator

        self.device = resolve_device(device)
        self._cx = GraphContext(graph_config)
        self._active: Optional[_ActiveStream] = None
        #: bind automation curves to node setters; ticked in update()
        self.automation = ParamAutomator()

    # -- graph access (lib.rs:37-42) ------------------------------------------
    @property
    def graph(self) -> AudioGraph:
        return self._cx.graph

    def graph_mut(self) -> AudioGraph:
        return self._cx.graph

    def available_output_devices(self) -> list[DeviceInfo]:
        return available_output_devices()

    # -- activation (lib.rs:102-259) ------------------------------------------
    def activate(
        self,
        stream_config: Optional[StreamConfig] = None,
        sink: Any = None,
        input_source=None,
        user_cx: Any = None,
        duration_secs: Optional[float] = None,
    ) -> None:
        """Start the output stream and activate the graph context.

        The graph's block is ``stream_config.block_frames`` (by default the
        stream buffer, 1024 frames, lib.rs:190-193).
        """
        if self._active is not None:
            raise RuntimeError("context is already activated")
        cfg = stream_config or StreamConfig()

        devices = self.available_output_devices()
        out_device_name = devices[0].name if devices else "offline"
        log.info(
            "Starting output audio stream with device %r (%d ch @ %d Hz, "
            "buffer %d)",
            out_device_name,
            cfg.num_out_channels,
            cfg.sample_rate,
            cfg.buffer_frames,
        )

        processor = self._cx.activate(
            cfg.sample_rate,
            cfg.num_in_channels,
            cfg.num_out_channels,
            cfg.block_frames,
            user_cx if user_cx is not None else object(),
            chunk_blocks=cfg.chunk_buffers * (cfg.buffer_frames // cfg.block_frames),
            deferred_swap=cfg.deferred_swap,
            device=self.device,
        )
        assert processor is not None
        # a fresh stream restarts its sample clock at 0: stale
        # block-accurate automation cursors from a previous stream would
        # otherwise park their lanes until the new clock caught up
        self.automation.reset_block_cursors()

        try:
            from_err = MessageChannel(MSG_CHANNEL_CAPACITY)
            stream = OutputStream(
                processor,
                cfg,
                sink=sink,
                input_source=input_source,
                err_channel=from_err,
                duration_secs=duration_secs,
            )
            # Ship the first schedule and render it once before the stream
            # starts pulling, so the first buffer never waits on a kernel
            # build.  A compile failure here (cycle, failed node
            # activation) must FAIL activation — not return a silent
            # stream (the reference's ActivateError contract, lib.rs:107).
            res = self._cx.update()
            if res.graph_error is not None:
                raise res.graph_error
            processor.warmup()
            stream.play()
        except BaseException:
            # unwind the graph-context activation, or every later
            # activate() would trip over a half-activated engine
            try:
                self._cx.deactivate(False)
            except Exception:
                pass
            raise

        self._active = _ActiveStream(stream, from_err, out_device_name, cfg)

    def is_activated(self) -> bool:
        return self._cx.is_activated()

    # -- per-frame pump (lib.rs:280-325) --------------------------------------
    def update(self, max_pump_buffers: int | None = None) -> UpdateResult:
        """One main-thread frame: drain errors, recompile a dirty graph,
        tick automation, render ahead.  ``max_pump_buffers`` caps this
        call's render-ahead (used by :meth:`render_offline` to land
        exactly on its target instead of overshooting by a pump batch —
        scheduled triggers are block-quantized against the RENDER head,
        ``stream.frames_rendered``, so an uncontrolled overshoot would
        push 'now' past freshly scheduled events)."""
        if self._active is not None:
            err = self._active.from_err.pop()
            if err is not None:
                self._active.stream.stop()
                # Unlike the reference (whose audio thread died with the
                # stream, lib.rs:288-291), our processor still runs on this
                # thread — complete the full stop handshake via drain.
                user_cx = self._cx.deactivate(
                    True, pump=self._active.stream.drain
                )
                self._active = None
                return UpdateResult(
                    UpdateStatus.DEACTIVATED,
                    error=err,
                    returned_user_cx=user_cx,
                )
        result = self._cx.update()
        if self._active is not None:
            # automation runs on the stream clock (DESIGN_DOC.md:31 scope)
            cfg = self._active.config
            self.automation.tick(
                self._active.stream.frames_rendered / cfg.sample_rate
            )
            # block-accurate lanes schedule one value per upcoming render
            # block (consumed by the nodes' param timelines)
            from .stream import PUMP_MAX_BUFFERS

            self.automation.tick_blocks(
                self._active.stream.frames_rendered,
                PUMP_MAX_BUFFERS * cfg.buffer_frames * cfg.chunk_buffers,
                cfg.sample_rate,
                cfg.buffer_frames,
            )
            # Render ahead on this thread (see backend/stream.py: all device
            # work rides the caller's thread).
            if max_pump_buffers is None:
                self._active.stream.pump()
            elif max_pump_buffers > 0:
                # Bound one update()'s render-ahead, but never below a
                # whole dispatch chunk
                self._active.stream.pump(
                    min(
                        max_pump_buffers,
                        max(PUMP_MAX_BUFFERS, cfg.chunk_buffers),
                    )
                )
            if self._active.stream.error is not None:
                # surfaced on the next update() via the error channel
                pass
        if result.status == UpdateStatus.DEACTIVATED and self._active is not None:
            self._active.stream.stop()
            self._active = None
        return result

    # -- shutdown (lib.rs:330-338) --------------------------------------------
    def deactivate(self) -> Any:
        if not self._cx.is_activated():
            return None
        stream = self._active.stream if self._active else None
        user_cx = self._cx.deactivate(
            self._active is not None,
            pump=(stream.drain if stream is not None else None),
        )
        if self._active is not None:
            self._active.stream.stop()
            self._active = None
        return user_cx

    # -- checkpoint/resume ----------------------------------------------------
    def save_checkpoint(self, path: str) -> None:
        """Persist all recurrent audio state and the stream position to
        ``path`` (``checkpoint.py``; the JAX package reads it too)."""
        from ..checkpoint import save_checkpoint

        if self._active is None:  # hard error, must survive python -O
            raise RuntimeError("save_checkpoint: activate() first")
        save_checkpoint(
            path,
            self._active.stream._processor,
            extra_meta={"frames_rendered": self._active.stream.frames_rendered},
        )

    def load_checkpoint(self, path: str) -> dict:
        """Restore state saved by :meth:`save_checkpoint` (by either
        package) into the running engine (same graph topology required);
        the stream clock resumes at the saved position."""
        from ..checkpoint import restore_into

        if self._active is None:  # hard error, must survive python -O
            raise RuntimeError("load_checkpoint: activate() first")
        meta = restore_into(path, self._active.stream._processor)
        if "frames_rendered" in meta:
            self._active.stream._frames_rendered = int(meta["frames_rendered"])
        # the stream clock just jumped: block-accurate automation cursors
        # must rewind, or they would flood the timeline catching up, or park
        # until the clock reaches them
        self.automation.reset_block_cursors()
        return meta

    # -- conveniences ---------------------------------------------------------
    def stream_config(self):
        """The active stream's configuration, or None (the reference's
        ``stream_config()`` accessor, firewheel-cpal/src/lib.rs:28-339)."""
        return self._active.config if self._active else None

    def output_latency_frames(self, sample_rate: int | None = None) -> int:
        """Algorithmic latency of the rendered mix at ``graph_out``, in
        frames (``graph/latency.py``: the longest-path sum of every node's
        ``latency_frames``).  Games add the sink's buffering latency and
        sync visuals and haptics to the total.  Activated, the active
        stream's rate is used (``sample_rate`` is ignored); inactive, pass
        the rate you plan to activate with, as some nodes' latency depends
        on it."""
        if self._active is not None:
            sr = self._active.config.sample_rate
        elif sample_rate is not None:
            sr = int(sample_rate)
        else:
            raise RuntimeError(
                "not activated and no sample_rate given — call "
                "output_latency_frames(sample_rate=...) with the rate you "
                "plan to activate with"
            )
        return self._cx.graph.output_latency_frames(sr)

    def node_state(self, node_id):
        """Host copy of a node's recurrent state (meter readback etc.)."""
        if self._active is None:
            return None
        return self._active.stream._processor.node_state(node_id)

    def poll_events(self):
        """Drain pending node events (``list[NodeEvent]`` — sampler
        ``finished``/``loop`` etc.; ``core/events.py``).  Call at the
        game's frame rate, typically right after :meth:`update`; events
        that occurred since the previous poll are aggregated per node
        (the return direction of the reference's TODO'd finish-notify,
        sampler.rs:496,513)."""
        if self._active is None:
            return []
        return self._active.stream._processor.poll_events()

    def render_offline(self, duration_secs: float) -> None:
        """Render ``duration_secs`` of audio to the sink as fast as the
        device allows (bounce-to-disk), pumping ``update()`` throughout so
        live graph edits during the render still apply."""
        if self._active is None:  # hard error, must survive python -O
            raise RuntimeError("activate() first")
        cfg = self._active.config
        target = self._active.stream.frames_rendered + int(
            duration_secs * cfg.sample_rate
        )
        # For a realtime stream, zero progress usually just means the
        # lookahead ring is full (backpressure) — wait out up to a few
        # ring-drain periods before concluding the stream is stuck.
        stall_budget = (
            cfg.lookahead_buffers * cfg.buffer_frames / cfg.sample_rate * 4.0
            if cfg.realtime
            else 0.0
        )
        stalled_since = None
        while self._active and self._active.stream.frames_rendered < target:
            before = self._active.stream.frames_rendered
            remaining = target - before
            res = self.update(
                max_pump_buffers=-(-remaining // cfg.buffer_frames)
            )
            if res.status != UpdateStatus.ACTIVE:
                break
            if self._active and self._active.stream.frames_rendered == before:
                # no progress: duration cap / drop / error — or, realtime,
                # plain ring backpressure
                if self._active.stream.error is not None or not cfg.realtime:
                    break
                now = time.monotonic()
                if stalled_since is None:
                    stalled_since = now
                elif now - stalled_since > max(stall_budget, 0.05):
                    break
                time.sleep(0.001)
            else:
                stalled_since = None
        if self._active is not None:
            # pipelined offline pumping keeps one chunk in flight — the
            # caller's contract is "audio is in the sink when we return"
            self._active.stream.flush()

    @property
    def stream(self) -> Optional[OutputStream]:
        return self._active.stream if self._active else None

    def __del__(self):
        try:
            if self._cx.is_activated():
                self.deactivate()
        except Exception:
            pass
