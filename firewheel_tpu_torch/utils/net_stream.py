"""Network streaming: play WAV clips over HTTP without downloading them.

A copy of ``firewheel_tpu/utils/net_stream.py`` (host only: ``http.client``
and ``threading``).  The reference's sampler lists disk and network
streaming as goals and implements neither.  Disk streaming is
:class:`~firewheel_tpu_torch.utils.wav.WavStreamReader`; this module is the
network half.

Design: the :class:`~firewheel_tpu_torch.nodes.streaming_sampler.
StreamingSamplerNode` prefetches a sliding window on the host thread, so a
network reader only has to serve ``read(start, n)`` with bounded latency —
no device-side changes.  Three layers:

* :class:`HttpByteSource` — a byte-range source over stdlib
  ``http.client`` (``Range: bytes=a-b`` requests on a persistent
  connection, one reconnect retry).  Servers that ignore ``Range``
  (status 200) degrade to a one-shot full download.
* :class:`SegmentCache` — fetches in fixed-size segments with an LRU so
  sequential playback re-requests nothing and seeks cost one segment.
* :class:`HttpWavStreamReader` — parses the WAV header through the cache
  and exposes the stream-reader protocol (``num_channels`` /
  ``len_frames`` / ``sample_rate`` / ``read``), returning numpy.

Everything is stdlib-only and synchronous: reads ride the thread that
calls ``update()``, as every torch call of the engine does, and the
sampler's lookahead margin absorbs request latency.  A starved read
degrades to silence in the kernel, never garbage.
"""

from __future__ import annotations

import struct
import threading
from collections import OrderedDict
from http.client import HTTPConnection
from urllib.parse import urlsplit

import numpy as np

__all__ = ["HttpByteSource", "SegmentCache", "HttpWavStreamReader"]


class HttpByteSource:
    """Byte-range reads over HTTP/1.1 (stdlib only; http:// URLs).

    ``length()`` probes with ``GET bytes=0-0`` (parsing ``Content-Range``)
    so it works on servers without HEAD.  ``read_range(off, size)`` issues
    ``Range`` GETs on a persistent connection and retries once through a
    fresh connection if the server closed it (keep-alive expiry).
    """

    def __init__(self, url: str, timeout: float = 10.0):
        parts = urlsplit(url)
        if parts.scheme != "http":
            raise ValueError(
                f"HttpByteSource supports http:// URLs only, got {url!r} "
                "(wrap your own transport in a byte source — anything with "
                "length()/read_range() plugs into HttpWavStreamReader)"
            )
        self.url = url
        self._host = parts.hostname
        self._port = parts.port or 80
        self._path = parts.path or "/"
        if parts.query:
            self._path += "?" + parts.query
        self._timeout = float(timeout)
        self._conn: "HTTPConnection | None" = None
        self._length: "int | None" = None
        self._full_body: "bytes | None" = None  # range-less server fallback
        self.request_count = 0  # observability (tests assert cache hits)

    # -- connection plumbing ---------------------------------------------------
    def _connect(self) -> HTTPConnection:
        if self._conn is None:
            self._conn = HTTPConnection(
                self._host, self._port, timeout=self._timeout
            )
        return self._conn

    def close(self):
        if self._conn is not None:
            try:
                self._conn.close()
            finally:
                self._conn = None

    def _get(self, headers: dict):
        """One GET with a single reconnect retry on a dead keep-alive."""
        for attempt in (0, 1):
            conn = self._connect()
            try:
                conn.request("GET", self._path, headers=headers)
                resp = conn.getresponse()
                body = resp.read()
                self.request_count += 1
                return resp, body
            except (ConnectionError, BrokenPipeError, OSError):
                self.close()
                if attempt:
                    raise
        raise AssertionError("unreachable")

    # -- byte-source protocol --------------------------------------------------
    def length(self) -> int:
        if self._length is not None:
            return self._length
        resp, body = self._get({"Range": "bytes=0-0"})
        if resp.status == 206:
            # Content-Range: bytes 0-0/12345
            rng = resp.getheader("Content-Range", "")
            total = rng.rsplit("/", 1)[-1]
            if not total.isdigit():
                raise IOError(f"unparseable Content-Range {rng!r}")
            self._length = int(total)
        elif resp.status == 200:
            # server ignores Range: we just downloaded the whole file
            self._full_body = body
            self._length = len(body)
        else:
            raise IOError(f"HTTP {resp.status} fetching {self.url}")
        return self._length

    def read_range(self, offset: int, size: int) -> bytes:
        """``size`` bytes at ``offset``; short at EOF (never raises there)."""
        total = self.length()
        offset = int(offset)
        size = int(size)
        if offset >= total or size <= 0:
            return b""
        end = min(offset + size, total) - 1  # inclusive
        if self._full_body is not None:
            return self._full_body[offset : end + 1]
        resp, body = self._get({"Range": f"bytes={offset}-{end}"})
        if resp.status == 206:
            return body
        if resp.status == 200:
            # mid-stream loss of range support: keep the download
            self._full_body = body
            self._length = len(body)
            return body[offset : end + 1]
        raise IOError(f"HTTP {resp.status} fetching {self.url}")


class SegmentCache:
    """Fixed-size segment LRU over a byte source.

    ``read(offset, size)`` assembles the span from cached segments,
    fetching misses in one coalesced range request per contiguous run.
    Sized for streaming: the default 64 segments x 256 KiB = 16 MiB holds
    ~44 s of 48 kHz stereo f32 — far past the sampler's lookahead.
    Thread-safe (one lock) so a future prefetch thread can share it,
    though the engine itself stays single-threaded.
    """

    def __init__(self, source, segment_bytes: int = 256 * 1024,
                 max_segments: int = 64):
        self.source = source
        self.segment_bytes = int(segment_bytes)
        self.max_segments = int(max_segments)
        self._segments: "OrderedDict[int, bytes]" = OrderedDict()
        self._lock = threading.Lock()

    def _segment(self, idx: int) -> bytes:
        seg = self._segments.get(idx)
        if seg is not None:
            self._segments.move_to_end(idx)
            return seg
        seg = self.source.read_range(
            idx * self.segment_bytes, self.segment_bytes
        )
        self._segments[idx] = seg
        while len(self._segments) > self.max_segments:
            self._segments.popitem(last=False)
        return seg

    def read(self, offset: int, size: int) -> bytes:
        offset = int(offset)
        size = int(size)
        if size <= 0:
            return b""
        with self._lock:
            first = offset // self.segment_bytes
            last = (offset + size - 1) // self.segment_bytes
            parts = []
            for idx in range(first, last + 1):
                seg = self._segment(idx)
                lo = offset - idx * self.segment_bytes if idx == first else 0
                hi = (
                    offset + size - idx * self.segment_bytes
                    if idx == last
                    else self.segment_bytes
                )
                parts.append(seg[max(lo, 0) : hi])
                if len(seg) < self.segment_bytes:
                    break  # EOF segment
            return b"".join(parts)


def _parse_wav_header(cache: SegmentCache):
    """Walk RIFF chunks through the cache; returns (fmt tuple, data_off,
    data_size).  Mirrors WavStreamReader's parser (utils/wav.py:141) but
    reads byte ranges instead of a file handle, so only the chunk headers
    and the fmt payload ever transfer."""
    head = cache.read(0, 12)
    if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] != b"WAVE":
        raise ValueError("not a WAV stream")
    fmt = None
    data_off = data_size = None
    pos = 12
    while True:
        hdr = cache.read(pos, 8)
        if len(hdr) < 8:
            break
        cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
        if cid == b"fmt ":
            payload = cache.read(pos + 8, 16)
            if len(payload) < 16:
                raise ValueError("truncated fmt chunk")
            fmt = struct.unpack("<HHIIHH", payload)
        elif cid == b"data":
            data_off, data_size = pos + 8, size
        pos += 8 + size + (size & 1)
        if fmt is not None and data_off is not None:
            break
    if fmt is None or data_off is None:
        raise ValueError("malformed WAV stream (missing fmt/data chunk)")
    return fmt, data_off, data_size


class HttpWavStreamReader:
    """Stream a WAV over HTTP; satisfies the stream-reader protocol used by
    :class:`~firewheel_tpu_torch.nodes.streaming_sampler.StreamingSamplerNode`.

    ``source`` may be a URL string (wrapped in :class:`HttpByteSource`) or
    any object with ``length()`` / ``read_range(offset, size)`` — custom
    transports (sockets, cloud blobs, decoders) plug in there.  Formats
    match the disk reader: PCM16 and float32 WAV.
    """

    def __init__(self, source, segment_bytes: int = 256 * 1024,
                 max_segments: int = 64):
        if isinstance(source, str):
            source = HttpByteSource(source)
        self.source = source
        self._cache = SegmentCache(source, segment_bytes, max_segments)
        fmt, data_off, data_size = _parse_wav_header(self._cache)
        fmt_code, ch, sr, _, _, bits = fmt
        if fmt_code == 3 and bits == 32:
            self._dtype, self._scale = np.dtype("<f4"), None
        elif fmt_code == 1 and bits == 16:
            self._dtype, self._scale = (
                np.dtype("<i2"),
                np.float32(1.0 / 32767.0),
            )
        else:
            raise ValueError(f"unsupported wav format {fmt_code}/{bits}")
        self.num_channels = int(ch)
        self.sample_rate = int(sr)
        frame_bytes = self.num_channels * self._dtype.itemsize
        # clamp the declared data size by what the server actually has
        avail = max(source.length() - data_off, 0)
        self.len_frames = min(int(data_size), avail) // frame_bytes
        self._data_off = int(data_off)
        self._frame_bytes = frame_bytes

    def read(self, start_frame: int, num_frames: int) -> np.ndarray:
        """``f32[channels, n]``; out-of-bounds regions zero-pad (same
        contract as WavStreamReader.read, utils/wav.py:221)."""
        start_frame = int(start_frame)
        num_frames = int(num_frames)
        start = max(0, start_frame)
        lead = start - start_frame
        end = min(start_frame + num_frames, self.len_frames)
        out = np.zeros((self.num_channels, num_frames), np.float32)
        if end > start:
            raw = self._cache.read(
                self._data_off + start * self._frame_bytes,
                (end - start) * self._frame_bytes,
            )
            got = len(raw) // self._frame_bytes
            chunk = (
                np.frombuffer(raw[: got * self._frame_bytes], self._dtype)
                .reshape(got, self.num_channels)
                .T
            )
            if self._scale is not None:
                chunk = chunk.astype(np.float32) * self._scale
            out[:, lead : lead + got] = chunk
        return out
