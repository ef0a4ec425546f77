"""SPSC ring buffer and paced consumer: ctypes bindings to native C++.

PyTorch port of ``firewheel_tpu/backend/ring_buffer.py`` with its own copy
of the C++ (``native/ringbuf.cpp``, ``native/consumer.cpp``, and the FLAC
decoder's ``native/lpc.cpp`` and ``native/crc.cpp``, which
``core/flac.py`` loads through :func:`_load_native`).  g++ builds them at
first use into the package's gitignored ``_build/``, under a name
keyed by the hash of the sources; a pure-Python ring (a numpy buffer under
a lock) keeps the engine working without a toolchain.

This is the ``rtrb`` analog (SURVEY component #14): the jitter absorber
between the render (the caller's thread) and the paced stream thread.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..ops.cuda_build import BUILD_DIR

log = logging.getLogger(__name__)

__all__ = ["RingBuffer", "NativeConsumer"]

_NATIVE_DIR = Path(__file__).resolve().parent / "native"
_SRCS = tuple(_NATIVE_DIR / name for name in
              ("ringbuf.cpp", "consumer.cpp", "lpc.cpp", "crc.cpp"))
_GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lib = None
_lib_lock = threading.Lock()


def _so_path() -> Path:
    h = hashlib.sha1(" ".join(_GXX_FLAGS).encode())
    for src in _SRCS:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libfwring-{h.hexdigest()[:12]}.so"


def _bind(lib) -> None:
    lib.rb_create.restype = ctypes.c_void_p
    lib.rb_create.argtypes = [ctypes.c_size_t]
    lib.rb_destroy.argtypes = [ctypes.c_void_p]
    lib.rb_capacity.restype = ctypes.c_size_t
    lib.rb_capacity.argtypes = [ctypes.c_void_p]
    lib.rb_readable.restype = ctypes.c_size_t
    lib.rb_readable.argtypes = [ctypes.c_void_p]
    lib.rb_writable.restype = ctypes.c_size_t
    lib.rb_writable.argtypes = [ctypes.c_void_p]
    for fn in (lib.rb_write, lib.rb_read):
        fn.restype = ctypes.c_size_t
        fn.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_size_t]
    lib.rb_skip.restype = ctypes.c_size_t
    lib.rb_skip.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.consumer_start.restype = ctypes.c_void_p
    lib.consumer_start.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_double, ctypes.c_size_t,
    ]
    lib.consumer_stop.argtypes = [ctypes.c_void_p]
    for fn in (lib.consumer_periods, lib.consumer_underflows):
        fn.restype = ctypes.c_uint64
        fn.argtypes = [ctypes.c_void_p]
    lib.consumer_take_underflow.restype = ctypes.c_uint32
    lib.consumer_take_underflow.argtypes = [ctypes.c_void_p]
    lib.consumer_last_late_ns.restype = ctypes.c_int64
    lib.consumer_last_late_ns.argtypes = [ctypes.c_void_p]


def _load_native():
    """Build (once per content) and load the native library; False when
    there is no toolchain."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        try:
            so = _so_path()
            if not so.exists():
                # build to a temporary name, then rename: a concurrent
                # start never loads a half-written library
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so.with_suffix(f".{os.getpid()}.tmp")
                subprocess.run(
                    ["g++", *_GXX_FLAGS, *map(str, _SRCS), "-o", str(tmp),
                     "-lpthread"],
                    check=True, capture_output=True,
                )
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
            _bind(lib)
            _lib = lib
        except Exception as e:  # pragma: no cover - toolchain-dependent
            log.warning("native ring buffer unavailable (%s); using Python", e)
            _lib = False
        return _lib


class RingBuffer:
    """SPSC float32 ring buffer (native when possible)."""

    def __init__(self, capacity: int, force_python: bool = False):
        self._native = None
        lib = None if force_python else _load_native()
        if lib:
            self._lib = lib
            self._native = ctypes.c_void_p(lib.rb_create(capacity))
            if not self._native:
                raise MemoryError("rb_create failed")
            self._capacity = int(lib.rb_capacity(self._native))
        else:
            # a power-of-two numpy ring under a lock
            cap = 1
            while cap < max(capacity, 2):
                cap <<= 1
            self._capacity = cap
            self._buf = np.zeros(cap, np.float32)
            self._head = 0
            self._tail = 0
            self._lock = threading.Lock()

    @property
    def capacity(self) -> int:
        return self._capacity

    def readable(self) -> int:
        if self._native:
            return int(self._lib.rb_readable(self._native))
        with self._lock:
            return self._tail - self._head

    def writable(self) -> int:
        if self._native:
            return int(self._lib.rb_writable(self._native))
        with self._lock:
            return self._capacity - (self._tail - self._head)

    @property
    def is_native(self) -> bool:
        return self._native is not None

    def write(self, data: np.ndarray) -> int:
        """Write up to ``data.size`` floats; returns the count written."""
        data = np.ascontiguousarray(data, np.float32).reshape(-1)
        n = data.size
        if self._native:
            ptr = data.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            return int(self._lib.rb_write(self._native, ptr, n))
        with self._lock:
            n = min(n, self._capacity - (self._tail - self._head))
            if n == 0:
                return 0
            start = self._tail & (self._capacity - 1)
            first = min(n, self._capacity - start)
            self._buf[start:start + first] = data[:first]
            self._buf[:n - first] = data[first:n]
            self._tail += n
            return n

    def read(self, out: np.ndarray) -> int:
        """Read up to ``out.size`` floats into ``out``; returns the count."""
        assert out.dtype == np.float32 and out.flags["C_CONTIGUOUS"]
        n = out.size
        if self._native:
            ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            return int(self._lib.rb_read(self._native, ptr, n))
        with self._lock:
            n = min(n, self._tail - self._head)
            if n == 0:
                return 0
            start = self._head & (self._capacity - 1)
            first = min(n, self._capacity - start)
            flat = out.reshape(-1)
            flat[:first] = self._buf[start:start + first]
            flat[first:n] = self._buf[:n - first]
            self._head += n
            return n

    def skip(self, n: int) -> int:
        if self._native:
            return int(self._lib.rb_skip(self._native, n))
        with self._lock:
            n = min(n, self._tail - self._head)
            self._head += n
            return n

    def __del__(self):
        if getattr(self, "_native", None):
            try:
                self._lib.rb_destroy(self._native)
            except Exception:
                pass
            self._native = None


class NativeConsumer:
    """Hard-realtime paced consumer in native code.

    The C++ thread (``native/consumer.cpp``) sleeps to absolute deadlines,
    reads one stream buffer per period from ``in_ring`` and forwards it to
    ``out_ring``, which the host drains to the sink off the realtime path.
    It touches no Python and no device.  Needs native rings."""

    def __init__(self, in_ring: RingBuffer, out_ring: RingBuffer | None,
                 period_secs: float, floats_per_period: int):
        lib = _load_native()
        if not lib or not in_ring.is_native or (
            out_ring is not None and not out_ring.is_native
        ):
            raise RuntimeError("native consumer requires native ring buffers")
        self._lib = lib
        # the rings live as long as the consumer thread runs
        self._in_ring = in_ring
        self._out_ring = out_ring
        self._handle = ctypes.c_void_p(lib.consumer_start(
            in_ring._native,
            out_ring._native if out_ring is not None else None,
            float(period_secs),
            int(floats_per_period),
        ))
        if not self._handle:
            raise MemoryError("consumer_start failed")

    @property
    def periods(self) -> int:
        h = self._handle
        return int(self._lib.consumer_periods(h)) if h else 0

    @property
    def underflows(self) -> int:
        h = self._handle
        return int(self._lib.consumer_underflows(h)) if h else 0

    def take_underflow(self) -> bool:
        """Sticky underflow flag; reading clears it."""
        h = self._handle
        return bool(self._lib.consumer_take_underflow(h)) if h else False

    @property
    def last_late_ns(self) -> int:
        h = self._handle
        return int(self._lib.consumer_last_late_ns(h)) if h else 0

    def stop(self):
        if getattr(self, "_handle", None):
            self._lib.consumer_stop(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass
