"""The host streaming backend: replaces the reference's CPAL/OS-audio layer.

PyTorch port of ``firewheel_tpu/backend/stream.py``.  Behavioral spec: ``crates/firewheel-cpal/src/lib.rs`` — especially the data
callback (lib.rs:378-449): per-buffer stream clock, underflow detection via
the predicted-time heuristic with a ×1.2 wiggle factor (lib.rs:404-418),
processor hand-off, and a stream-error channel feeding fault tolerance in
``update()`` (lib.rs:286-297).

Threads: the reference renders *on* the audio thread; here the graph
renders on the device, asynchronously, and every torch call rides the
caller's thread — ``OutputStream.pump()`` is invoked from the context's
``update()`` (the per-game-frame hook the engine already requires,
context.rs:93) and renders ahead into the native SPSC ring buffer.  CUDA's
current device and stream are per thread, so one thread that owns all
device work needs no cross-thread ordering.  The only worker thread is the
**paced consumer** (native C++, or a Python fallback): ring reads and sink
writes, no torch, draining frames at the stream rate and reporting
starvation → ``OUTPUT_UNDERFLOW`` (exactly the cpal callback's role):

    update()/pump() ──render──> ring buffer ──paced thread──> sink

In offline mode there is no pacing: ``pump()`` (or ``render_offline``)
pushes straight to the sink as fast as the device renders, for
bounce-to-disk use.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from typing import Any, Callable, Optional

import numpy as np

from ..channels import MessageChannel
from ..core.node import StreamStatus
from ..processor import GraphProcessor, ProcessorStatus
from .ring_buffer import NativeConsumer, RingBuffer

log = logging.getLogger(__name__)

__all__ = ["StreamConfig", "StreamError", "OutputStream", "ArraySink", "WavSink"]


#: default buffers rendered per ``OutputStream.pump`` — also the horizon
#: (in buffers) the block-accurate automation scheduler must stay ahead of
#: (FirewheelCtx.update passes it to ParamAutomator.tick_blocks)
PUMP_MAX_BUFFERS = 8


class StreamError(Exception):
    pass


class StreamConfig:
    """Output stream parameters (the cpal ``StreamConfig`` analog)."""

    def __init__(
        self,
        sample_rate: int = 48000,
        num_out_channels: int = 2,
        num_in_channels: int = 0,
        buffer_frames: int = 1024,  # cpal default (lib.rs:190-193)
        realtime: bool = False,
        lookahead_buffers: int = 4,
        chunk_buffers: int = 1,
        deferred_swap: bool = True,
        pipeline_depth: int = 1,
        block_frames: Optional[int] = None,
    ):
        """``chunk_buffers``: render up to this many stream buffers per
        device dispatch; params and messages then apply at chunk
        granularity (scheduled changes stay block-accurate).

        ``deferred_swap`` (default on): a live topology edit is staged while
        the old schedule keeps rendering and installs after the next pump
        has rendered it once (building any kernel it launches first).  Turn
        off for the reference's strict install-next-buffer semantics.

        ``pipeline_depth``: offline pumping keeps up to this many whole
        chunks in flight, fetching chunk *t* only after chunk *t+depth*
        launches, so the host stages the next dispatch while the device
        renders.  ``0`` restores strictly synchronous dispatch; realtime
        streams always run synchronously.

        ``block_frames``: the graph's block, a divisor of
        ``buffer_frames`` (by default the buffer itself, as in the JAX
        package): a buffer of 1024 frames in blocks of 128 renders as one
        dispatch of 8 blocks."""
        self.sample_rate = sample_rate
        self.num_out_channels = num_out_channels
        self.num_in_channels = num_in_channels
        self.buffer_frames = buffer_frames
        self.block_frames = int(block_frames or buffer_frames)
        if buffer_frames % self.block_frames != 0:
            raise ValueError(f"block_frames {self.block_frames} does not divide "
                             f"buffer_frames {buffer_frames}")
        self.realtime = realtime
        chunk_buffers = max(1, int(chunk_buffers))
        self.lookahead_buffers = max(lookahead_buffers, chunk_buffers + 1)
        self.chunk_buffers = chunk_buffers
        self.deferred_swap = bool(deferred_swap)
        self.pipeline_depth = max(0, int(pipeline_depth))


class ArraySink:
    """Collects rendered interleaved frames into memory."""

    def __init__(self):
        self._chunks: list[np.ndarray] = []

    def write(self, interleaved: np.ndarray, num_channels: int):
        self._chunks.append(interleaved.copy())

    def audio(self, num_channels: int) -> np.ndarray:
        """``[channels, frames]`` float32."""
        if not self._chunks:
            return np.zeros((num_channels, 0), np.float32)
        flat = np.concatenate(self._chunks)
        frames = len(flat) // num_channels
        return flat[: frames * num_channels].reshape(frames, num_channels).T.copy()


class WavSink:
    """Streams rendered audio to a 32-bit-float WAV file incrementally:
    each ``write`` appends to disk, so an hours-long bounce holds no audio
    in RAM; ``close()`` patches the RIFF/data sizes in the header."""

    def __init__(self, path: str, sample_rate: int, num_channels: int):
        import struct

        self.path = path
        self.sample_rate = sample_rate
        self.num_channels = num_channels
        self._payload_bytes = 0
        self._f = open(path, "wb")
        byte_rate = sample_rate * num_channels * 4
        self._f.write(b"RIFF" + struct.pack("<I", 36) + b"WAVEfmt ")
        self._f.write(
            struct.pack(
                "<IHHIIHH", 16, 3, num_channels, sample_rate, byte_rate,
                num_channels * 4, 32,
            )
        )
        self._f.write(b"data" + struct.pack("<I", 0))

    def write(self, interleaved: np.ndarray, num_channels: int):
        data = np.asarray(interleaved, "<f4").tobytes()
        self._f.write(data)
        self._payload_bytes += len(data)

    def close(self):
        import struct

        if self._f.closed:
            return
        self._f.seek(4)
        self._f.write(struct.pack("<I", 36 + self._payload_bytes))
        self._f.seek(40)
        self._f.write(struct.pack("<I", self._payload_bytes))
        self._f.close()


class OutputStream:
    """An active output stream driving a :class:`GraphProcessor`.

    The ``DataCallback`` analog: owns the stream clock and underflow
    heuristic (lib.rs:386-419) and forwards buffers to the processor.
    """

    def __init__(
        self,
        processor: GraphProcessor,
        config: StreamConfig,
        sink: Any = None,
        input_source: Optional[Callable[[int], np.ndarray]] = None,
        err_channel: Optional[MessageChannel] = None,
        duration_secs: Optional[float] = None,
    ):
        self.config = config
        self.sink = sink if sink is not None else ArraySink()
        self.input_source = input_source
        self._err = err_channel
        self._processor = processor
        self._duration = duration_secs

        cap = (
            config.buffer_frames
            * config.num_out_channels
            * max(2, config.lookahead_buffers + 1)
        )
        self._ring = RingBuffer(cap)
        self._stop = threading.Event()
        self._underflow_flag = threading.Event()
        self._consumer_thread: Optional[threading.Thread] = None
        self._native_consumer: Optional[NativeConsumer] = None
        self._out_ring: Optional[RingBuffer] = None
        self._frames_rendered = 0
        self._underflow_count = 0
        self._playing = False
        self._dropped = False
        self.error: Optional[BaseException] = None
        # per-buffer render wall times (seconds), last 512 buffers
        self._render_times: collections.deque = collections.deque(maxlen=512)

        n_out = config.num_out_channels
        self._out_buf = np.zeros(config.buffer_frames * n_out, np.float32)
        self._in_buf = np.zeros(
            config.buffer_frames * config.num_in_channels, np.float32
        )
        # Pipelined offline pumping: up to
        # config.pipeline_depth whole-chunk dispatches stay in flight
        # across pumps; a chunk's fetch+sink-write happens only after a
        # later chunk launches, overlapping the device→host transfer
        # with the device render.  Entries: (handle, span, n_buffers,
        # host_seconds_spent_dispatching), oldest first.  Realtime
        # streams never pipeline — their pacing already hides the sync.
        self._inflight_q: list = []
        self._pipe_buf = np.zeros(0, np.float32)

    # -- lifecycle ------------------------------------------------------------
    def play(self):
        self._playing = True
        if self.config.realtime:
            # Prefer the native pacing loop (C++ thread, absolute deadlines,
            # no GIL jitter); frames land in a host-drained output ring.
            # Fall back to the Python paced thread without a toolchain.
            try:
                cfg = self.config
                floats = cfg.buffer_frames * cfg.num_out_channels
                self._out_ring = RingBuffer(
                    floats * max(16, 4 * cfg.lookahead_buffers)
                )
                self._native_consumer = NativeConsumer(
                    self._ring,
                    self._out_ring,
                    cfg.buffer_frames / cfg.sample_rate,
                    floats,
                )
                self._drain_buf = np.zeros(floats, np.float32)
                return
            except Exception as e:
                log.info("native consumer unavailable (%s); Python pacing", e)
                self._native_consumer = None
                self._out_ring = None
            self._consumer_thread = threading.Thread(
                target=self._paced_consumer, name="fw-stream", daemon=True
            )
            self._consumer_thread.start()

    def flush(self) -> None:
        """Finish every in-flight pipelined chunk, if any: fetch them and
        write them to the sink in order.  Safe to call anytime from the
        engine thread; errors land on ``self.error`` like pump errors."""
        if not self._inflight_q:
            return
        try:
            self._flush_inflight()
        except Exception as e:
            log.error("stream flush error: %s", e)
            self.error = e
            if self._err is not None:
                try:
                    self._err.push(e)
                except Exception:
                    pass

    def _flush_inflight(self) -> None:
        while self._inflight_q:
            self._finish_one(self._inflight_q.pop(0))

    def _finish_one(self, inf) -> None:
        handle, span, n, t_dispatch = inf
        n_out = self.config.num_out_channels
        need = span * n_out
        if self._pipe_buf.size < need:
            self._pipe_buf = np.zeros(need, np.float32)
        view = self._pipe_buf[:need]
        t0 = time.perf_counter()
        self._processor.finish_interleaved(handle, view, n_out)
        self.sink.write(view, n_out)
        # per-buffer host cost: dispatch staging + fetch/interleave (the
        # overlapped device wait between the two is deliberately absent)
        self._render_times.append(
            (t_dispatch + time.perf_counter() - t0) / n
        )

    def stop(self, timeout: float = 10.0):
        self._playing = False
        self.flush()
        self._stop.set()
        nc = getattr(self, "_native_consumer", None)
        if nc is not None:
            # detach before stopping so a concurrent pump() never touches a
            # consumer whose native object is being torn down
            self._native_consumer = None
            nc.stop()
            self._drain_out_ring()
        if self._consumer_thread is not None:
            self._consumer_thread.join(timeout)
            self._consumer_thread = None
        if hasattr(self.sink, "close"):
            try:
                self.sink.close()
            except Exception:
                pass

    @property
    def frames_rendered(self) -> int:
        return self._frames_rendered

    @property
    def underflow_count(self) -> int:
        return self._underflow_count

    def stats(self) -> dict:
        """Render-path health: frames, underflows, and per-buffer render
        latency percentiles vs the realtime budget (the block-p99 metric
        from BASELINE.md)."""
        times = np.asarray(self._render_times, np.float64)
        budget = self.config.buffer_frames / self.config.sample_rate
        out = {
            "frames_rendered": self._frames_rendered,
            "underflow_count": self._underflow_count,
            "buffer_budget_ms": budget * 1e3,
            "buffers_timed": int(times.size),
        }
        if times.size:
            out.update(
                render_ms_p50=float(np.percentile(times, 50) * 1e3),
                render_ms_p99=float(np.percentile(times, 99) * 1e3),
                render_ms_max=float(times.max() * 1e3),
                realtime_headroom=float(
                    budget / max(float(np.percentile(times, 99)), 1e-12)
                ),
            )
        if self._native_consumer is not None:
            out.update(
                consumer="native",
                consumer_periods=self._native_consumer.periods,
                consumer_underflows=self._native_consumer.underflows,
                consumer_last_late_us=self._native_consumer.last_late_ns
                / 1e3,
            )
        elif self._consumer_thread is not None:
            out["consumer"] = "python"
        return out

    @property
    def finished(self) -> bool:
        """True once a fixed-duration render has produced every frame."""
        return (
            self._duration is not None
            and self._frames_rendered >= self._duration * self.config.sample_rate
        )

    # -- render side (caller's thread; the cpal callback body) ----------------
    def pump(self, max_buffers: int = PUMP_MAX_BUFFERS) -> int:
        """Render up to ``max_buffers`` stream buffers; returns frames
        rendered.  Called from the context's ``update()``.

        Realtime mode renders only as far ahead as the ring has space
        (backpressure = lookahead depth); offline mode is bounded only by
        ``max_buffers`` and the configured duration.

        Offline pipelining (``pipeline_depth > 0``) may hold up to
        ``depth`` dispatched chunks in flight between pumps; the sink
        therefore lags ``frames_rendered`` by up to
        ``depth × chunk_buffers × buffer_frames`` frames mid-stream.
        A fixed-duration render auto-flushes when it ``finished``;
        open-ended callers get the tail from ``flush()``/``drain()``/
        ``stop()``.
        """
        if self._out_ring is not None:
            # forward natively-paced frames to the sink (off the RT path)
            self._drain_out_ring()
        if not self._playing or self.error is not None or self._dropped:
            return 0
        # Reentrancy guard: all device work rides one thread (see module
        # docstring); concurrent pumps are a caller bug we surface loudly
        # rather than corrupt stream order.
        if getattr(self, "_pumping", False):
            raise RuntimeError(
                "OutputStream.pump() re-entered — drive update()/pump() from "
                "a single thread"
            )
        self._pumping = True
        try:
            rendered = self._pump_locked(max_buffers)
            if self._inflight_q and self.finished:
                # the last frames of a fixed-duration render were just
                # dispatched — deliver them so "pump until finished then
                # read the sink" holds without an explicit drain()
                self._flush_inflight()
            # Install any staged schedule AFTER filling the ring (the
            # lookahead absorbs its first render, which may build kernels)
            self._processor.advance_pending()
            return rendered
        finally:
            self._pumping = False

    def _pump_locked(self, max_buffers: int) -> int:
        cfg = self.config
        frames = cfg.buffer_frames
        n_out = cfg.num_out_channels
        n_in = cfg.num_in_channels
        sample_rate_recip = 1.0 / cfg.sample_rate
        max_frames = (
            int(self._duration * cfg.sample_rate)
            if self._duration is not None
            else None
        )

        rendered = 0
        buffers_left = max_buffers
        try:
            while buffers_left > 0:
                if max_frames is not None and self._frames_rendered >= max_frames:
                    break
                # how many buffers this dispatch
                n = min(buffers_left, cfg.chunk_buffers)
                if cfg.realtime:
                    ring_bufs = self._ring.writable() // (frames * n_out)
                    n = min(n, ring_bufs)
                    if n == 0:
                        break
                span = n * frames
                if max_frames is not None:
                    # exact duration: the final dispatch renders a partial
                    # span (the processor handles arbitrary frame counts)
                    # instead of rounding up to whole buffers
                    span = min(span, max_frames - self._frames_rendered)
                    n = (span + frames - 1) // frames
                if self._out_buf.size < span * n_out:
                    self._out_buf = np.zeros(span * n_out, np.float32)
                    self._in_buf = np.zeros(span * n_in, np.float32)
                out_view = self._out_buf[: span * n_out]
                in_view = self._in_buf[: span * n_in]

                stream_time_secs = self._frames_rendered * sample_rate_recip
                status = StreamStatus.NONE
                if self._native_consumer is not None:
                    if self._native_consumer.take_underflow():
                        status |= StreamStatus.OUTPUT_UNDERFLOW
                        self._underflow_count += 1
                elif self._underflow_flag.is_set():
                    self._underflow_flag.clear()
                    status |= StreamStatus.OUTPUT_UNDERFLOW
                    self._underflow_count += 1

                if self.input_source is not None and n_in > 0:
                    filled = 0
                    while filled < span:
                        take = min(frames, span - filled)
                        in_view[
                            filled * n_in : (filled + take) * n_in
                        ] = np.asarray(
                            self.input_source(take), np.float32
                        ).reshape(-1)
                        filled += take

                t_render = time.perf_counter()
                if not cfg.realtime and cfg.pipeline_depth > 0:
                    # Pipelined path: launch this chunk, then fetch
                    # chunks older than the pipeline depth while newer
                    # ones render.  Input staging copies host-side
                    # before dispatch, so reusing _in_buf next
                    # iteration is safe.
                    handle = self._processor.dispatch_interleaved(
                        in_view, n_in, span, stream_time_secs, status
                    )
                    if handle is not None:
                        t_dispatch = time.perf_counter() - t_render
                        self._inflight_q.append(
                            (handle, span, n, t_dispatch)
                        )
                        while len(self._inflight_q) > cfg.pipeline_depth:
                            self._finish_one(self._inflight_q.pop(0))
                        self._frames_rendered += span
                        rendered += span
                        buffers_left -= n
                        continue
                # Synchronous path (realtime, odd tails, stopping
                # processor): the sink write below must stay ordered
                # after any pipelined chunk still in flight.
                self._flush_inflight()
                st = self._processor.process_interleaved(
                    in_view,
                    out_view,
                    n_in,
                    n_out,
                    span,
                    stream_time_secs,
                    status,
                )
                self._render_times.append(
                    (time.perf_counter() - t_render) / n
                )
                self._frames_rendered += span
                rendered += span
                buffers_left -= n

                if cfg.realtime:
                    written = 0
                    while written < out_view.size:
                        w = self._ring.write(out_view[written:])
                        written += w
                        if written < out_view.size:
                            time.sleep(0.0005)
                else:
                    self.sink.write(out_view, n_out)

                if st == ProcessorStatus.DROP_PROCESSOR:
                    self._processor.drop()
                    self._dropped = True
                    self._playing = False
                    break
        except Exception as e:  # fault tolerance (lib.rs:212-214, 286-297)
            log.error("stream error: %s", e)
            self.error = e
            if self._err is not None:
                try:
                    self._err.push(e)
                except Exception:
                    pass
        return rendered

    def _drain_out_ring(self) -> None:
        """Move natively-paced frames from the output ring to the sink: the
        frames in the ring on entry, no more.  The paced consumer refills
        it at the stream rate (silence when the render falls behind), so
        against a sink that takes frames no faster, a device on its own
        clock, draining to empty would never return, nor would the pump
        that called it."""
        ring = self._out_ring
        if ring is None:
            return
        n_out = self.config.num_out_channels
        left = ring.readable()
        while left > 0:
            got = ring.read(self._drain_buf[:min(left, len(self._drain_buf))])
            if got == 0:
                return
            left -= got
            try:
                self.sink.write(self._drain_buf[:got], n_out)
            except Exception as e:
                self.error = e
                if self._err is not None:
                    try:
                        self._err.push(e)
                    except Exception:
                        pass
                return

    def drain(self) -> None:
        """Finish the processor drop handshake if a stop arrived
        (offline streams with no paced thread)."""
        self.flush()
        if not self._dropped and self._processor is not None:
            frames = self.config.buffer_frames
            st = self._processor.process_interleaved(
                self._in_buf[: frames * self.config.num_in_channels],
                self._out_buf[: frames * self.config.num_out_channels],
                self.config.num_in_channels,
                self.config.num_out_channels,
                frames,
                self._frames_rendered / self.config.sample_rate,
            )
            if st == ProcessorStatus.DROP_PROCESSOR:
                self._processor.drop()
                self._dropped = True

    # -- paced consumer (realtime mode; no torch on this thread) --------------
    def _paced_consumer(self):
        cfg = self.config
        period = cfg.buffer_frames / cfg.sample_rate
        buf = np.zeros(cfg.buffer_frames * cfg.num_out_channels, np.float32)
        # underflow heuristic mirrors lib.rs:404-418: wall clock past the
        # predicted stream time (with ×1.2 wiggle) means a break occurred.
        next_deadline = time.monotonic() + period
        predicted_wiggle = period * 1.2
        while not self._stop.is_set():
            now = time.monotonic()
            delay = next_deadline - now
            if delay > 0:
                time.sleep(delay)
            elif -delay > predicted_wiggle:
                self._underflow_flag.set()
                # re-anchor after a stall: advancing the old deadline by one
                # period would leave us permanently behind, spinning through
                # catch-up iterations that each count another underflow
                next_deadline = now
            next_deadline += period

            got = self._ring.read(buf)
            if got < buf.size:
                buf[got:] = 0.0
                self._underflow_flag.set()
            try:
                self.sink.write(buf, cfg.num_out_channels)
            except Exception as e:
                self.error = e
                if self._err is not None:
                    try:
                        self._err.push(e)
                    except Exception:
                        pass
                return
