"""Ogg Opus decode/encode: pure-Python Ogg framing + system libopus.

Reference scope: "Support for loading a wide variety of audio formats
(using Symphonia)" (the reference's ``DESIGN_DOC.md:32-33`` — the
Symphonia ecosystem decodes Opus).  Opus is *the* modern game/streaming
codec; this image ships ``libopus.so.0`` (the raw codec) but not
``libopusfile`` (the Ogg demux layer), so this module implements the
container itself: Ogg page parse/build (capture pattern, lacing,
continuation packets, the Ogg CRC-32) and the OpusHead/OpusTags ID
headers per RFC 7845, with only the codec math delegated to libopus
through ``ctypes`` (``opus_decode_float`` / ``opus_encode_float``).
When the library is absent the format registry simply reports ``.opus``
as unsupported.

Opus always decodes at 48 kHz; RFC 7845 pre-skip and the final page's
granule position are honored exactly, so decode → encode → decode is
frame-count exact (gapless loops survive).  ``OpusStreamReader`` keeps
one decoder open and serves the windowed stream-reader protocol with
sample-exact seeks: a seek resets the decoder and pre-rolls the 3840
samples (80 ms) the RFC prescribes before the target.
"""

from __future__ import annotations

import bisect
import ctypes
import struct
import threading

import numpy as np

__all__ = ["available", "decode_opus", "encode_opus", "OpusStreamReader",
           "OpusStreamWriter", "OpusSink"]

_lock = threading.Lock()
_opus = None
_probed = False

_OPUS_APPLICATION_AUDIO = 2049
_OPUS_SET_BITRATE = 4002
_OPUS_SET_COMPLEXITY = 4010
_OPUS_GET_LOOKAHEAD = 4027
_OPUS_RESET_STATE = 4028
# RFC 7845 §4.4 prescribes ≥80 ms (3840) of pre-roll before a seek
# target; convergence is geometric (measured on 128 kbps stereo CELT:
# max |err| 6e-2 @ 80 ms, 4e-3 @ 160 ms, 2e-5 @ 320 ms, 0 @ 640 ms) and
# decoding is ~µs/packet, so we pre-roll 640 ms for inaudible-to-exact
# backward seeks
_PREROLL = 30720
_MAX_FRAME = 5760  # 120 ms @ 48k — the largest legal packet duration


def _load():
    global _opus, _probed
    with _lock:
        if _probed:
            return _opus
        _probed = True
        try:
            o = ctypes.CDLL("libopus.so.0")
            o.opus_decoder_create.restype = ctypes.c_void_p
            o.opus_decoder_create.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
            o.opus_decoder_destroy.restype = None
            o.opus_decoder_destroy.argtypes = [ctypes.c_void_p]
            o.opus_decode_float.restype = ctypes.c_int
            o.opus_decode_float.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int]
            o.opus_encoder_create.restype = ctypes.c_void_p
            o.opus_encoder_create.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int)]
            o.opus_encoder_destroy.restype = None
            o.opus_encoder_destroy.argtypes = [ctypes.c_void_p]
            o.opus_encode_float.restype = ctypes.c_int
            o.opus_encode_float.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
            # *_ctl are variadic: declare the fixed prefix (without it
            # ctypes passes the 64-bit handle as a C int — segfault),
            # extra args convert per default varargs rules
            o.opus_encoder_ctl.restype = ctypes.c_int
            o.opus_encoder_ctl.argtypes = [ctypes.c_void_p, ctypes.c_int]
            o.opus_decoder_ctl.restype = ctypes.c_int
            o.opus_decoder_ctl.argtypes = [ctypes.c_void_p, ctypes.c_int]
            o.opus_packet_get_nb_samples.restype = ctypes.c_int
            o.opus_packet_get_nb_samples.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
            _opus = o
        except Exception:
            _opus = None
        return _opus


def available() -> dict:
    """{"decode": bool, "encode": bool} — both ride the one libopus."""
    o = _load()
    return {"decode": o is not None, "encode": o is not None}


# -- Ogg container (pure Python) ----------------------------------------------

def _crc_table() -> np.ndarray:
    # Ogg CRC-32: poly 0x04c11db7, init 0, NOT reflected, xorout 0
    tbl = np.empty(256, np.uint32)
    for i in range(256):
        c = i << 24
        for _ in range(8):
            c = ((c << 1) ^ 0x04C11DB7 if c & 0x80000000 else c << 1) \
                & 0xFFFFFFFF
        tbl[i] = c
    return tbl


_CRC_TBL = _crc_table()


def _ogg_crc(data: bytes) -> int:
    crc = 0
    tbl = _CRC_TBL
    for b in data:
        crc = ((crc << 8) & 0xFFFFFFFF) ^ int(tbl[((crc >> 24) & 0xFF) ^ b])
    return crc


def _build_page(serial: int, seq: int, granule: int, packets: list[bytes],
                header_type: int, cont_first: bool = False) -> bytes:
    """One Ogg page holding ``packets`` (each fully contained; pass
    ``cont_first`` when the first lacing continues a previous page)."""
    lacing = bytearray()
    body = bytearray()
    for p in packets:
        q, r = divmod(len(p), 255)
        lacing += b"\xff" * q + bytes([r])
        body += p
    if len(lacing) > 255:
        raise ValueError("too many segments for one page")
    hdr = struct.pack(
        "<4sBBqIIIB", b"OggS", 0,
        header_type | (0x01 if cont_first else 0),
        granule, serial & 0xFFFFFFFF, seq, 0, len(lacing),
    ) + bytes(lacing)
    page = bytearray(hdr + bytes(body))
    crc = _ogg_crc(bytes(page))
    page[22:26] = struct.pack("<I", crc)
    return bytes(page)


def _iter_pages(data: bytes):
    """Yield ``(granule, header_type, serial, [segment lacing sizes],
    body_off)`` per page; tolerant scan (resyncs on the capture
    pattern)."""
    off = 0
    n = len(data)
    while off < n:
        idx = data.find(b"OggS", off)
        if idx < 0 or idx + 27 > n:
            return
        (_, _ver, htype, granule, _serial, _seq, _crc, nsegs) = struct.unpack(
            "<4sBBqIIIB", data[idx:idx + 27])
        seg_end = idx + 27 + nsegs
        if seg_end > n:
            return
        lacing = data[idx + 27:seg_end]
        body_len = sum(lacing)
        if seg_end + body_len > n:
            return
        yield granule, htype, _serial, list(lacing), seg_end
        off = seg_end + body_len


def _parse_packets(data: bytes):
    """Assemble Ogg packets (handling page-spanning continuation) →
    ``(packets: list[bytes], last_granule: int)``.

    Follows ONE logical stream: the serial of the first page.  Pages of
    other serials (multiplexed streams) are skipped, and parsing stops
    at our stream's EOS page — a chained file (``cat a.opus b.opus``)
    decodes its first link instead of feeding the second link's
    OpusHead to the codec as audio and corrupting the end-trim."""
    packets: list[bytes] = []
    partial = b""
    last_granule = 0
    serial = None
    for granule, htype, page_serial, lacing, body_off in _iter_pages(data):
        if serial is None:
            serial = page_serial
        elif page_serial != serial:
            continue
        pos = body_off
        for i, seg in enumerate(lacing):
            partial += data[pos:pos + seg]
            pos += seg
            if seg < 255:  # packet terminates
                packets.append(partial)
                partial = b""
        if granule >= 0 and lacing and lacing[-1] < 255:
            last_granule = granule
        if htype & 0x04:  # our stream's EOS — ignore chained links
            break
    return packets, last_granule


def _parse_head(pkt: bytes):
    """OpusHead (RFC 7845 §5.1) → (channels, preskip, in_rate, gain_q8)."""
    if len(pkt) < 19 or pkt[:8] != b"OpusHead":
        raise ValueError("not an Ogg Opus stream (no OpusHead)")
    version, ch = pkt[8], pkt[9]
    if version >> 4 != 0:
        raise ValueError(f"unsupported OpusHead version {version}")
    preskip, in_rate, gain_q8 = struct.unpack("<HIh", pkt[10:18])
    family = pkt[18]
    if family != 0:
        raise ValueError(
            f"Opus channel mapping family {family} not supported "
            "(mono/stereo family-0 streams only)")
    return ch, preskip, in_rate, gain_q8


# -- decode ---------------------------------------------------------------

def _source_bytes(source) -> bytes:
    """Normalize path / bytes / byte-source → the whole Ogg byte stream.

    Opus seeking needs a full packet-duration scan up front (the same
    reason mpg123_scan exists), and the compressed stream stays resident
    (~1 MB/min), so a network byte source (``read_range``/``read`` +
    ``length()`` — e.g. :class:`~firewheel_tpu.utils.net_stream.
    HttpByteSource`) is fetched once here; PCM still decodes windowed,
    on demand."""
    if isinstance(source, (bytes, bytearray, memoryview)):
        return bytes(source)
    if isinstance(source, str) or hasattr(source, "__fspath__"):
        with open(source, "rb") as f:
            return f.read()
    read = getattr(source, "read_range", None) or getattr(
        source, "read", None)
    length = getattr(source, "length", None)
    if read is not None and length is not None:
        return bytes(read(0, int(length())))
    raise TypeError(
        f"unsupported Opus byte source {type(source).__name__} (want a "
        "path, bytes, or read_range/read + length())")


class _Decoder:
    def __init__(self, source):
        o = _load()
        if o is None:
            raise ValueError(
                "Opus decoding unavailable: libopus.so.0 not found "
                "(install libopus, or register_format an external decoder)")
        self.o = o
        data = _source_bytes(source)
        self.packets, last_granule = _parse_packets(data)
        if not self.packets:
            raise ValueError(f"no Ogg packets in {source!r}")
        self.channels, self.preskip, self.in_rate, gain_q8 = _parse_head(
            self.packets[0])
        self.gain = float(10.0 ** (gain_q8 / (20.0 * 256.0)))
        # audio packets follow OpusHead + OpusTags
        self.audio = self.packets[2:] if len(self.packets) > 2 and \
            self.packets[1][:8] == b"OpusTags" else self.packets[1:]
        # per-packet cumulative END positions in raw 48k samples
        ends = []
        total = 0
        for p in self.audio:
            ns = o.opus_packet_get_nb_samples(p, len(p), 48000)
            total += max(int(ns), 0)
            ends.append(total)
        self.ends = ends
        self.raw_total = total
        # the final granule trims encoder padding (RFC 7845 §4.3)
        trimmed = (last_granule if 0 < last_granule <= total else total)
        self.len_frames = max(trimmed - self.preskip, 0)
        err = ctypes.c_int(0)
        self.dec = o.opus_decoder_create(48000, self.channels,
                                         ctypes.byref(err))
        if not self.dec or err.value != 0:
            raise ValueError(f"opus_decoder_create failed ({err.value})")

    def decode_packet(self, pkt: bytes) -> np.ndarray:
        buf = np.empty(_MAX_FRAME * self.channels, np.float32)
        got = self.o.opus_decode_float(
            self.dec, pkt, len(pkt),
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            _MAX_FRAME, 0)
        if got < 0:
            raise ValueError(f"opus_decode_float error {got}")
        return buf[: got * self.channels].reshape(got, self.channels).T

    def reset(self):
        self.o.opus_decoder_ctl(self.dec, ctypes.c_int(_OPUS_RESET_STATE))

    def close(self):
        if getattr(self, "dec", None):
            self.o.opus_decoder_destroy(self.dec)
            self.dec = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass


def decode_opus(source) -> tuple[np.ndarray, int]:
    """Decode a whole Ogg Opus stream → ``(f32 [channels, frames],
    48000)`` (Opus always reconstructs at 48 kHz; pre-skip and end trim
    applied).  ``source``: path, bytes, or a network byte source
    (``read_range``/``read`` + ``length()``)."""
    d = _Decoder(source)
    try:
        chunks = [d.decode_packet(p) for p in d.audio]
        if chunks:
            pcm = np.concatenate(chunks, axis=1)
        else:
            pcm = np.zeros((d.channels, 0), np.float32)
        pcm = pcm[:, d.preskip:d.preskip + d.len_frames]
        if d.gain != 1.0:
            pcm = pcm * np.float32(d.gain)
        return np.ascontiguousarray(pcm), 48000
    finally:
        d.close()


# -- encode ---------------------------------------------------------------

def encode_opus(path: str, audio: np.ndarray, sample_rate: int,
                bitrate_kbps: int = 96) -> None:
    """Encode f32 ``[channels, frames]`` (or ``[frames]``) to an Ogg
    Opus file.  Opus encodes at 8/12/16/24/48 kHz; any other
    ``sample_rate`` is converted to 48 kHz first through the offline
    polyphase resampler (``utils/resample.py``, ~100 dB).  20 ms
    frames, VBR at ``bitrate_kbps``."""
    if sample_rate not in (8000, 12000, 16000, 24000, 48000):
        from .resample import resample

        audio = resample(audio, int(sample_rate), 48000)
        sample_rate = 48000
    audio = np.atleast_2d(np.ascontiguousarray(audio, np.float32))
    w = OpusStreamWriter(path, sample_rate, audio.shape[0],
                         bitrate_kbps=bitrate_kbps)
    try:
        w.append(audio)
    finally:
        w.finish()


class OpusStreamWriter:
    """Incremental Ogg Opus encoder: ``append(f32 [ch, n])`` encodes
    complete 20 ms frames as they accumulate and writes finished pages
    straight to disk (an hours-long bounce holds <20 ms of PCM in RAM);
    ``finish()`` pads the tail frame, flushes the EOS page with the
    final-granule end trim, and closes the file.  The streaming engine
    behind :func:`encode_opus` and :class:`OpusSink`."""

    def __init__(self, path: str, sample_rate: int, channels: int,
                 bitrate_kbps: int = 96):
        o = _load()
        if o is None:
            raise ValueError(
                "Opus encoding unavailable: libopus.so.0 not found")
        if sample_rate not in (8000, 12000, 16000, 24000, 48000):
            raise ValueError(
                f"OpusStreamWriter needs an Opus rate (8/12/16/24/48 kHz), "
                f"got {sample_rate} (offline: encode_opus auto-resamples)")
        if channels > 2:
            raise ValueError("family-0 Ogg Opus is mono/stereo only")
        self.o = o
        self.channels = int(channels)
        self.sample_rate = int(sample_rate)
        err = ctypes.c_int(0)
        self._enc = o.opus_encoder_create(
            self.sample_rate, self.channels, _OPUS_APPLICATION_AUDIO,
            ctypes.byref(err))
        if not self._enc or err.value != 0:
            raise ValueError(f"opus_encoder_create failed ({err.value})")
        o.opus_encoder_ctl(self._enc, ctypes.c_int(_OPUS_SET_BITRATE),
                           ctypes.c_int(int(bitrate_kbps) * 1000))
        o.opus_encoder_ctl(self._enc, ctypes.c_int(_OPUS_SET_COMPLEXITY),
                           ctypes.c_int(10))
        look = ctypes.c_int(0)
        o.opus_encoder_ctl(self._enc, ctypes.c_int(_OPUS_GET_LOOKAHEAD),
                           ctypes.byref(look))
        self._look = int(look.value)
        self._scale = 48000 // self.sample_rate
        self._preskip = self._look * self._scale  # OpusHead: 48k units
        self._frame = self.sample_rate // 50  # 20 ms
        self._serial = 0x46575055  # "FWPU" — deterministic for tests
        self._seq = 2
        self._outbuf = ctypes.create_string_buffer(4000)  # RFC 6716 max
        self._pend_pkts: list[bytes] = []
        self._pend_lacing = 0  # Ogg caps a page at 255 lacing segments
        self._pend_granule = 0
        self._granule = 0  # raw 48k samples encoded, incl. lookahead
        self._in_frames = 0  # input frames appended (input rate)
        self._buf = np.zeros((self.channels, 0), np.float32)
        self._f = open(path, "wb")
        head = (b"OpusHead" + struct.pack(
            "<BBHIhB", 1, self.channels, self._preskip, self.sample_rate,
            0, 0))
        vendor = b"firewheel_tpu"
        tags = (b"OpusTags" + struct.pack("<I", len(vendor)) + vendor +
                struct.pack("<I", 0))
        self._f.write(_build_page(self._serial, 0, 0, [head], 0x02))
        self._f.write(_build_page(self._serial, 1, 0, [tags], 0x00))

    def _flush_page(self, htype: int, granule: int) -> None:
        self._f.write(_build_page(self._serial, self._seq, granule,
                                  self._pend_pkts, htype))
        self._seq += 1
        self._pend_pkts = []
        self._pend_lacing = 0

    def _encode_frame(self, blk: np.ndarray, final_granule=None) -> None:
        o = self.o
        inter = np.ascontiguousarray(blk.T.reshape(-1), np.float32)
        nb = o.opus_encode_float(
            self._enc, inter.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._frame, self._outbuf, len(self._outbuf))
        if nb < 0:
            raise ValueError(f"opus_encode_float error {nb}")
        self._granule += self._frame * self._scale
        pkt = self._outbuf.raw[:nb]
        segs = len(pkt) // 255 + 1
        if self._pend_pkts and (len(self._pend_pkts) >= 50 or
                                self._pend_lacing + segs > 255):
            self._flush_page(0x00, self._pend_granule)
        self._pend_pkts.append(pkt)
        self._pend_lacing += segs
        # the final page's granule trims padding back to the true length
        self._pend_granule = (self._granule if final_granule is None
                              else min(self._granule, final_granule))

    def append(self, audio: np.ndarray) -> None:
        """Queue f32 ``[channels, n]`` (or ``[n]``); complete 20 ms
        frames encode immediately, the remainder waits for more."""
        audio = np.atleast_2d(np.asarray(audio, np.float32))
        self._in_frames += audio.shape[1]
        self._buf = np.concatenate([self._buf, audio], axis=1)
        n_full = self._buf.shape[1] // self._frame
        for i in range(n_full):
            self._encode_frame(
                self._buf[:, i * self._frame:(i + 1) * self._frame])
        self._buf = self._buf[:, n_full * self._frame:]

    def finish(self) -> None:
        """Pad the tail, emit the EOS page (end-trimmed to exactly the
        appended length), close the file.  Idempotent."""
        if self._f.closed:
            return
        try:
            final_granule = self._preskip + self._in_frames * self._scale
            # the decoder discards `preskip` raw samples up front: feed
            # trailing zeros until the raw total covers final_granule
            tail = self._buf.shape[1]
            need = tail + self._look
            n_frames = max(-(-need // self._frame), 1)
            blk = np.pad(self._buf,
                         ((0, 0), (0, n_frames * self._frame - tail)))
            for i in range(n_frames):
                self._encode_frame(
                    blk[:, i * self._frame:(i + 1) * self._frame],
                    final_granule=final_granule)
            self._flush_page(0x04, self._pend_granule)
            self._f.close()
        finally:
            if self._enc:
                self.o.opus_encoder_destroy(self._enc)
                self._enc = None

    close = finish

    def __del__(self):  # pragma: no cover - GC timing
        try:
            if getattr(self, "_enc", None):
                self.o.opus_encoder_destroy(self._enc)
                self._enc = None
        except Exception:
            pass


class OpusSink:
    """Engine sink (the ``write(interleaved, num_channels)`` protocol of
    ``ArraySink``/``WavSink``) that bounces the stream to an Ogg Opus
    file incrementally — compressed session exports with <20 ms of PCM
    resident.  The stream's rate must be an Opus rate (48 kHz streams
    are the norm)."""

    def __init__(self, path: str, sample_rate: int, num_channels: int,
                 bitrate_kbps: int = 96):
        self._w = OpusStreamWriter(path, sample_rate, num_channels,
                                   bitrate_kbps=bitrate_kbps)
        self.path = path
        self.num_channels = int(num_channels)

    def write(self, interleaved: np.ndarray, num_channels: int) -> None:
        flat = np.asarray(interleaved, np.float32)
        frames = len(flat) // num_channels
        self._w.append(flat[: frames * num_channels]
                       .reshape(frames, num_channels).T)

    def close(self) -> None:
        self._w.finish()


# -- streaming ------------------------------------------------------------

class OpusStreamReader:
    """Windowed Ogg Opus access for :class:`StreamingSamplerNode` /
    :class:`MusicPlayer`: compressed packets stay resident (~1 MB/min),
    PCM decodes on demand.  Sequential reads (and forward gaps within
    the preroll) continue the decoder and are **bit-exact** vs the
    whole-file decode (the deck hot path, including gapless loop-backs
    to 0: resetting at the start equals a fresh decode).  A backward
    mid-file seek — or a forward jump past 640 ms, which would otherwise
    decode every intermediate packet — resets the decoder and pre-rolls
    640 ms (8× the RFC 7845 §4.4 minimum — see _PREROLL's measured
    convergence) — sample-aligned and converged below audibility (Opus
    is stateful; only decoding from 0 is guaranteed exact).  Reads
    outside ``[0, len_frames)`` zero-pad."""

    def __init__(self, source):
        self.source = source
        self._d = _Decoder(source)
        self.num_channels = self._d.channels
        self.sample_rate = 48000
        self.len_frames = self._d.len_frames
        self._pkt = 0    # next packet index to decode
        self._pos = 0    # raw 48k position of that packet's first sample
        self._carry = np.zeros((self.num_channels, 0), np.float32)
        self._carry_pos = 0  # raw position of carry[:, 0]

    def _seek(self, raw_target: int) -> None:
        """Position the decoder so the next decode covers raw_target."""
        d = self._d
        lo = max(raw_target - _PREROLL, 0)
        # first packet whose END exceeds lo
        idx = bisect.bisect_right(d.ends, lo)
        d.reset()
        self._pkt = idx
        self._pos = d.ends[idx - 1] if idx > 0 else 0
        self._carry = np.zeros((self.num_channels, 0), np.float32)
        self._carry_pos = self._pos

    def read(self, start_frame: int, num_frames: int) -> np.ndarray:
        from ..core.formats import read_window

        return read_window(self.len_frames, self.num_channels,
                           start_frame, num_frames, self._decode_span)

    def _decode_span(self, start: int, count: int) -> np.ndarray:
        ch = self.num_channels
        d = self._d
        raw_start = start + d.preskip
        raw_end = start + count + d.preskip
        frontier = self._carry_pos + self._carry.shape[1]
        if raw_start < self._carry_pos:
            # backward: reset + RFC preroll (sample-aligned; bit-exact
            # when the preroll window reaches the file start, e.g. a
            # loop back to 0 — converged-to-inaudible otherwise)
            self._seek(raw_start)
        elif raw_start - frontier > _PREROLL:
            # far forward jump (a seek, or another deck sharing this
            # reader rewound us): reset + preroll like a backward seek
            # instead of decoding every intermediate packet — a shared
            # looping deck would otherwise re-decode the whole file from
            # ~0 to the playhead on every loop arming
            self._seek(raw_start)
        pieces = []
        pos = self._carry_pos
        if self._carry.shape[1]:
            pieces.append(self._carry)
        cur_end = pos + (pieces[0].shape[1] if pieces else 0)
        # short forward gaps (≤ _PREROLL) decode through (stateful
        # codec: continuing the decoder is what keeps sequential reads
        # bit-exact); pieces wholly before the target drop to bound memory
        while cur_end < raw_end and self._pkt < len(d.audio):
            pcm = d.decode_packet(d.audio[self._pkt])
            self._pkt += 1
            pieces.append(pcm)
            cur_end += pcm.shape[1]
            while pieces and pos + pieces[0].shape[1] <= raw_start:
                pos += pieces[0].shape[1]
                pieces.pop(0)
        pcm = np.concatenate(pieces, axis=1) if pieces else \
            np.zeros((ch, 0), np.float32)
        a = raw_start - pos
        b = min(raw_end - pos, pcm.shape[1])
        if b > a:
            seg = pcm[:, a:b]
            if d.gain != 1.0:
                seg = seg * np.float32(d.gain)
        else:
            seg = np.zeros((ch, 0), np.float32)
        # keep the tail from the requested START (windows often re-read
        # overlapping spans) and advance the carry origin
        keep_from = max(a, 0)
        self._carry = np.ascontiguousarray(pcm[:, keep_from:])
        self._carry_pos = pos + keep_from
        return seg

    def close(self):
        self._d.close()
