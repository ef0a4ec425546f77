"""OS audio I/O: play rendered audio on, and capture live input from, a
real device.

Closes the reference's last behavioral gap — ``firewheel-cpal`` plays to an
OS device via cpal (``crates/firewheel-cpal/src/lib.rs:207-229``); here a
:class:`SoundDeviceSink` drains the engine's paced render stream into a
``sounddevice``/PortAudio output callback.  The engine side is unchanged:
this is just another sink for :meth:`FirewheelCtx.activate`
(``backend/context.py``), fed by the same ring-buffer pacing that feeds
:class:`~firewheel_tpu_torch.backend.stream.ArraySink` / ``WavSink``.

:class:`SoundDeviceSource` is the capture mirror (BEYOND the reference —
its cpal backend is output-only): a PortAudio input callback fills the
same SPSC ring shape from the other side, and the object is directly
usable as the engine's ``input_source`` callable
(``backend/stream.py:456-465``), feeding the graph's input node with live
microphone/line-in audio — voice-chat FX chains, live monitoring through
the mastering bus, karaoke.

Design (mirrors the cpal DataCallback split, lib.rs:378-449):

* ``write()`` is called on the engine thread with interleaved f32 frames;
  frames land in a lock-free single-producer/single-consumer ring.
* The PortAudio callback (OS audio thread) copies from the ring; an empty
  ring plays silence and increments ``underflow_count`` — the engine's
  pacing (lookahead buffers) keeps the ring ahead, exactly like the cpal
  stream clock + underflow heuristic (lib.rs:386-419).
* Capture side, same discipline mirrored: the input callback pushes, the
  engine pops; a dry ring yields silence + ``starve_count``, a full ring
  (engine stalled) drops the tail of the callback buffer (whole frames)
  + ``overflow_count`` — both RT-safe, neither blocks the audio thread.

``sounddevice`` is an optional dependency: importing this module without it
works; constructing the sink raises a clear error, and
:func:`os_audio_available` lets callers (and CI) probe cheaply.  No
``pip install`` is attempted.

A copy of ``firewheel_tpu/backend/os_audio.py`` (numpy and the standard
library only); not in ``backend.__all__``, as in the JAX package.
"""

from __future__ import annotations

import threading

import numpy as np

__all__ = ["os_audio_available", "SoundDeviceSink", "SoundDeviceSource"]


def _load_sounddevice():
    try:
        import sounddevice  # type: ignore

        return sounddevice
    except Exception:
        return None


def os_audio_available() -> bool:
    """True when the optional ``sounddevice`` backend and an output device
    are both present (CI-safe probe)."""
    sd = _load_sounddevice()
    if sd is None:
        return False
    try:
        return len(sd.query_devices()) > 0
    except Exception:
        return False


class _SPSCRing:
    """Interleaved f32 sample ring: engine thread writes, audio callback
    reads.  Lock-free via monotonic indices (Python int ops are atomic
    enough under the GIL; a mutex would be RT-hostile on the callback)."""

    def __init__(self, capacity_samples: int):
        self._buf = np.zeros(capacity_samples, np.float32)
        self._cap = capacity_samples
        self._read = 0
        self._write = 0

    def available_read(self) -> int:
        return self._write - self._read

    def available_write(self) -> int:
        return self._cap - self.available_read()

    def push(self, data: np.ndarray) -> int:
        n = min(len(data), self.available_write())
        w = self._write % self._cap
        first = min(n, self._cap - w)
        self._buf[w : w + first] = data[:first]
        self._buf[: n - first] = data[first:n]
        self._write += n
        return n

    def pop_into(self, out: np.ndarray) -> int:
        n = min(len(out), self.available_read())
        r = self._read % self._cap
        first = min(n, self._cap - r)
        out[:first] = self._buf[r : r + first]
        out[first:n] = self._buf[: n - first]
        self._read += n
        return n


class SoundDeviceSink:
    """Engine sink that plays to the default OS output device.

    Use with a *realtime* stream config so the engine paces renders to the
    device clock::

        sink = SoundDeviceSink(sample_rate=48000, num_channels=2)
        cx.activate(StreamConfig(48000, 2, realtime=True), sink=sink)
        ...
        cx.deactivate(); sink.close()

    ``buffer_secs`` sizes the jitter ring between the engine thread and the
    audio callback (default 0.5 s).
    """

    def __init__(
        self,
        sample_rate: int = 48000,
        num_channels: int = 2,
        buffer_secs: float = 0.5,
        device=None,
        _sd=None,
    ):
        sd = _sd if _sd is not None else _load_sounddevice()
        if sd is None:
            raise RuntimeError(
                "SoundDeviceSink needs the optional 'sounddevice' package "
                "(PortAudio bindings); it is not installed. Render to "
                "ArraySink/WavSink instead, or install sounddevice where "
                "OS audio output is wanted."
            )
        self.sample_rate = int(sample_rate)
        self.num_channels = int(num_channels)
        self.underflow_count = 0
        self._ring = _SPSCRing(
            max(1, int(buffer_secs * sample_rate)) * num_channels
        )
        self._closed = False
        self._started = False  # set by the first write()
        self._space = threading.Condition()

        def callback(outdata, frames, time_info, status):
            flat = outdata.reshape(-1)
            got = self._ring.pop_into(flat)
            if got < len(flat):
                flat[got:] = 0.0
                # silence before the first engine write (activation /
                # first-compile time) is expected, not an underflow —
                # count only once real audio has started flowing
                if self._started:
                    self.underflow_count += 1
            with self._space:
                self._space.notify()

        self._stream = sd.OutputStream(
            samplerate=self.sample_rate,
            channels=self.num_channels,
            dtype="float32",
            device=device,
            callback=callback,
        )
        self._stream.start()

    # -- engine-side sink protocol ---------------------------------------------
    def write(self, interleaved: np.ndarray, num_channels: int):
        data = np.asarray(interleaved, np.float32).reshape(-1)
        stalled = 0.0
        while len(data) and not self._closed:
            pushed = self._ring.push(data)
            data = data[pushed:]
            # mark started only once samples are actually in the ring — an
            # audio callback racing the first write must not count the
            # pre-audio silence as an underflow
            if pushed and not self._started:
                self._started = True
            if len(data):
                # ring full: wait for the callback to drain (backpressure —
                # the engine-side pacing normally prevents ever landing
                # here).  Bounded: if the callback stops consuming (device
                # unplugged, PortAudio killed the stream — the cpal
                # error-callback case, lib.rs:286-297), raise instead of
                # hanging the engine thread forever.
                if pushed:
                    stalled = 0.0
                stalled += 0.1
                if stalled > 2.0 or not getattr(self._stream, "active", True):
                    raise RuntimeError(
                        "OS audio output stalled (device lost or stream "
                        "stopped); deactivate and re-activate onto a new "
                        "device"
                    )
                with self._space:
                    self._space.wait(timeout=0.1)

    def close(self):
        if self._closed:
            return
        self._closed = True
        try:
            self._stream.stop()
            self._stream.close()
        except Exception:
            pass


class SoundDeviceSource:
    """Live OS input capture, usable directly as the engine's
    ``input_source`` (beyond the reference: firewheel-cpal is
    output-only).

    ::

        src = SoundDeviceSource(sample_rate=48000, num_channels=1)
        cx.activate(StreamConfig(48000, 2, num_in_channels=1,
                                 realtime=True),
                    sink=sink, input_source=src)
        ...
        cx.deactivate(); src.close()

    The engine pulls ``src(frames)`` on its render thread; the PortAudio
    callback pushes captured frames from the audio thread.  A dry ring
    (capture behind the engine clock — startup, device hiccup) returns
    the captured prefix zero-padded and bumps ``starve_count``; a full
    ring (engine stalled) keeps the frame-aligned prefix of the callback
    buffer that still fits and drops its TAIL (whole frames — capacity
    is a multiple of ``num_channels``, so channel alignment is
    preserved), bumping ``overflow_count`` once per partially-or-fully
    dropped buffer.  ``latency_frames()`` reports the ring's current
    backlog — the capture-side contribution to end-to-end latency.

    ``buffer_secs`` sizes the jitter ring (default 0.5 s).
    """

    def __init__(
        self,
        sample_rate: int = 48000,
        num_channels: int = 1,
        buffer_secs: float = 0.5,
        device=None,
        _sd=None,
    ):
        sd = _sd if _sd is not None else _load_sounddevice()
        if sd is None:
            raise RuntimeError(
                "SoundDeviceSource needs the optional 'sounddevice' "
                "package (PortAudio bindings); it is not installed. Feed "
                "the graph via a custom input_source callable instead, or "
                "install sounddevice where OS audio capture is wanted."
            )
        self.sample_rate = int(sample_rate)
        self.num_channels = int(num_channels)
        self.starve_count = 0
        self.overflow_count = 0
        self._ring = _SPSCRing(
            max(1, int(buffer_secs * sample_rate)) * num_channels
        )
        self._closed = False
        self._started = False  # set by the first callback delivery

        def callback(indata, frames, time_info, status):
            flat = np.asarray(indata, np.float32).reshape(-1)
            pushed = self._ring.push(flat)
            if pushed:
                self._started = True
            if pushed < len(flat):
                # engine stalled: drop the tail, never block the audio
                # thread (the sink's write() blocks engine-side instead —
                # capture has no engine-side thread to lean on)
                self.overflow_count += 1

        self._stream = sd.InputStream(
            samplerate=self.sample_rate,
            channels=self.num_channels,
            dtype="float32",
            device=device,
            callback=callback,
        )
        self._stream.start()

    # -- engine-side input_source protocol -------------------------------------
    def __call__(self, frames: int) -> np.ndarray:
        """Return ``frames`` interleaved f32 frames (zero-padded when the
        ring is dry).  Engine render thread only."""
        out = np.zeros(int(frames) * self.num_channels, np.float32)
        got = self._ring.pop_into(out)
        if got < len(out) and self._started and not self._closed:
            # pre-capture silence (stream warmup) is expected; starved
            # reads count only once real input has started flowing
            self.starve_count += 1
        return out

    def latency_frames(self) -> int:
        """Frames currently buffered between capture and the engine."""
        return self._ring.available_read() // self.num_channels

    def close(self):
        if self._closed:
            return
        self._closed = True
        try:
            self._stream.stop()
            self._stream.close()
        except Exception:
            pass
