"""MP3 decode/encode via the system codec libraries (ctypes, no build).

Reference scope: "Support for loading a wide variety of audio formats
(using Symphonia)" (the reference's ``DESIGN_DOC.md:32-33`` — Symphonia
decodes MP3).  The in-tree decoders cover the PCM containers and FLAC/
ADPCM; MP3's format (hybrid filterbank + Huffman + bit reservoir) is
best served by the battle-tested system decoder: this module binds
**libmpg123** (decode, gapless via the LAME tag) and **libmp3lame**
(encode, for tests and asset tooling) through ``ctypes``.  Both ship in
this image and on every mainstream distro; when absent, the format
registry reports MP3 as unsupported instead of failing at import.

Decoding always requests float32 output from mpg123 (one conversion, no
quantization loss); ``Mp3StreamReader`` keeps a handle open and serves
the windowed stream-reader protocol (``num_channels``, ``len_frames``,
``sample_rate``, ``read``) with sample-exact seeks (``mpg123_scan``
builds the frame index up front).
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

__all__ = ["available", "decode_mp3", "encode_mp3", "Mp3StreamReader"]

_MPG123_OK = 0
_MPG123_DONE = -12
_MPG123_NEW_FORMAT = -11
_ENC_FLOAT_32 = 0x200
_ADD_FLAGS = 2  # enum mpg123_parms: MPG123_ADD_FLAGS
_FORCE_FLOAT = 0x400  # flag: decode to float regardless of output format
_SEEK_SET = 0

_lock = threading.Lock()
_mpg123 = _lame = None
_probed = False


def _sym(lib, name):
    """Resolve ``name``, preferring the explicit 64-bit LFS alias some
    distro builds export (``mpg123_open_64``) over the native symbol."""
    for cand in (name + "_64", name):
        try:
            return getattr(lib, cand)
        except AttributeError:
            continue
    raise AttributeError(name)


def _load():
    global _mpg123, _lame, _probed
    with _lock:
        if _probed:
            return _mpg123, _lame
        _probed = True
        try:
            m = ctypes.CDLL("libmpg123.so.0")
            m.mpg123_init()
            m.mpg123_new.restype = ctypes.c_void_p
            m.mpg123_new.argtypes = [ctypes.c_char_p,
                                     ctypes.POINTER(ctypes.c_int)]
            m.mpg123_delete.argtypes = [ctypes.c_void_p]
            for n in ("mpg123_close", "mpg123_scan", "mpg123_format_none"):
                fn = getattr(m, n)
                fn.restype = ctypes.c_int
                fn.argtypes = [ctypes.c_void_p]
            pa = getattr(m, "mpg123_param2", None) or m.mpg123_param
            pa.restype = ctypes.c_int
            pa.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_long,
                           ctypes.c_double]
            op = _sym(m, "mpg123_open")
            op.restype = ctypes.c_int
            op.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            gf = _sym(m, "mpg123_getformat")
            gf.restype = ctypes.c_int
            gf.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
                           ctypes.POINTER(ctypes.c_int),
                           ctypes.POINTER(ctypes.c_int)]
            fmt = _sym(m, "mpg123_format")
            fmt.restype = ctypes.c_int
            fmt.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_int,
                            ctypes.c_int]
            ln = _sym(m, "mpg123_length")
            ln.restype = ctypes.c_int64
            ln.argtypes = [ctypes.c_void_p]
            rd = _sym(m, "mpg123_read")
            rd.restype = ctypes.c_int
            rd.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t)]
            sk = _sym(m, "mpg123_seek")
            sk.restype = ctypes.c_int64
            sk.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int]
            m._open, m._getformat, m._format = op, gf, fmt
            m._length, m._read, m._seek, m._param = ln, rd, sk, pa
            _mpg123 = m
        except Exception:
            _mpg123 = None
        try:
            la = ctypes.CDLL("libmp3lame.so.0")
            la.lame_init.restype = ctypes.c_void_p
            for n in ("lame_set_in_samplerate", "lame_set_num_channels",
                      "lame_set_brate", "lame_set_quality"):
                fn = getattr(la, n)
                fn.restype = ctypes.c_int
                fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
            la.lame_init_params.restype = ctypes.c_int
            la.lame_init_params.argtypes = [ctypes.c_void_p]
            la.lame_encode_buffer_ieee_float.restype = ctypes.c_int
            la.lame_encode_buffer_ieee_float.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ]
            la.lame_encode_flush.restype = ctypes.c_int
            la.lame_encode_flush.argtypes = [ctypes.c_void_p,
                                             ctypes.c_void_p, ctypes.c_int]
            la.lame_get_lametag_frame.restype = ctypes.c_size_t
            la.lame_get_lametag_frame.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
            ]
            la.lame_close.argtypes = [ctypes.c_void_p]
            _lame = la
        except Exception:
            _lame = None
        return _mpg123, _lame


def available() -> dict:
    """{"decode": bool, "encode": bool} — what the system libraries allow."""
    m, la = _load()
    return {"decode": m is not None, "encode": la is not None}


class _Handle:
    """An opened, float32-forced, fully-scanned mpg123 decode handle."""

    def __init__(self, path: str):
        m, _ = _load()
        if m is None:
            raise ValueError(
                "MP3 decoding unavailable: libmpg123.so.0 not found "
                "(install mpg123, or register_format an external decoder)"
            )
        self.m = m
        err = ctypes.c_int(0)
        self.h = m.mpg123_new(None, ctypes.byref(err))
        if not self.h:
            raise ValueError(f"mpg123_new failed ({err.value})")
        try:
            # FORCE_FLOAT must be set BEFORE open: a post-open
            # mpg123_format() only applies from the next stream, so the
            # current one would keep emitting int16 we'd misread as f32.
            m._param(self.h, _ADD_FLAGS, _FORCE_FLOAT, 0.0)
            if m._open(self.h, os.fsencode(path)) != _MPG123_OK:
                raise ValueError(f"mpg123 cannot open {path!r}")
            rate = ctypes.c_long(0)
            ch = ctypes.c_int(0)
            enc = ctypes.c_int(0)
            if m._getformat(self.h, ctypes.byref(rate), ctypes.byref(ch),
                            ctypes.byref(enc)) != _MPG123_OK:
                raise ValueError(f"mpg123 cannot read format of {path!r}")
            self.rate = int(rate.value)
            self.channels = int(ch.value)
            if enc.value != _ENC_FLOAT_32:
                raise ValueError(
                    f"mpg123 negotiated encoding 0x{enc.value:x}, "
                    "not float32 (MPG123_FORCE_FLOAT unsupported?)"
                )
            # lock the format so a mid-stream rate change can't switch it
            m.mpg123_format_none(self.h)
            if m._format(self.h, self.rate, self.channels,
                         _ENC_FLOAT_32) != _MPG123_OK:
                raise ValueError("mpg123 float32 output unsupported")
            m.mpg123_scan(self.h)  # exact VBR length + sample-exact seeks
            self.len_frames = max(int(m._length(self.h)), 0)
        except Exception:
            self.close()
            raise

    def read_frames(self, n: int) -> np.ndarray:
        """Decode up to ``n`` frames from the current position →
        interleaved f32 ``[frames*channels]`` (shorter at EOF)."""
        buf = np.empty(n * self.channels, np.float32)
        done = ctypes.c_size_t(0)
        got = 0
        while got < buf.size:
            view = buf[got:]
            st = self.m._read(
                self.h,
                view.ctypes.data_as(ctypes.c_void_p),
                view.nbytes,
                ctypes.byref(done),
            )
            got += done.value // 4
            if st == _MPG123_DONE:
                break
            if st not in (_MPG123_OK, _MPG123_NEW_FORMAT):
                raise ValueError(f"mpg123 read error {st}")
        return buf[:got]

    def seek(self, frame: int) -> None:
        if self.m._seek(self.h, int(frame), _SEEK_SET) < 0:
            raise ValueError(f"mpg123 seek to {frame} failed")

    def close(self):
        if getattr(self, "h", None):
            self.m.mpg123_close(self.h)
            self.m.mpg123_delete(self.h)
            self.h = None

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass


def decode_mp3(path: str) -> tuple[np.ndarray, int]:
    """Decode a whole MP3 → ``(f32 [channels, frames], sample_rate)``.
    Gapless (LAME-tag) trimming is mpg123's default, so lame-encoded
    files round-trip to their exact original length."""
    h = _Handle(path)
    try:
        chunks = []
        while True:
            c = h.read_frames(1 << 16)
            if c.size == 0:
                break
            chunks.append(c)
        flat = (
            np.concatenate(chunks) if chunks else np.empty(0, np.float32)
        )
        frames = flat.size // h.channels
        return flat.reshape(frames, h.channels).T.copy(), h.rate
    finally:
        h.close()


def encode_mp3(path: str, audio: np.ndarray, sample_rate: int,
               bitrate_kbps: int = 192) -> None:
    """Encode f32 ``[channels, frames]`` (or ``[frames]``) to an MP3 file
    via libmp3lame (CBR, quality 2), patching the LAME info tag so
    decoders reproduce the exact frame count (gapless)."""
    _, la = _load()
    if la is None:
        raise ValueError(
            "MP3 encoding unavailable: libmp3lame.so.0 not found"
        )
    audio = np.atleast_2d(np.ascontiguousarray(audio, np.float32))
    ch, frames = audio.shape
    if ch > 2:
        raise ValueError("MP3 supports mono or stereo")
    gfp = la.lame_init()
    if not gfp:
        raise ValueError("lame_init failed")
    try:
        la.lame_set_in_samplerate(gfp, int(sample_rate))
        la.lame_set_num_channels(gfp, ch)
        la.lame_set_brate(gfp, int(bitrate_kbps))
        la.lame_set_quality(gfp, 2)
        if la.lame_init_params(gfp) < 0:
            raise ValueError("lame_init_params failed (rate/channels?)")
        left = audio[0]
        right = audio[1] if ch == 2 else audio[0]
        out = np.empty(int(1.25 * frames + 7200) + 7200, np.uint8)
        n = la.lame_encode_buffer_ieee_float(
            gfp,
            left.ctypes.data_as(ctypes.c_void_p),
            right.ctypes.data_as(ctypes.c_void_p),
            frames,
            out.ctypes.data_as(ctypes.c_void_p),
            out.size,
        )
        if n < 0:
            raise ValueError(f"lame encode error {n}")
        tail = la.lame_encode_flush(
            gfp, out[n:].ctypes.data_as(ctypes.c_void_p), out.size - n
        )
        if tail < 0:
            raise ValueError(f"lame flush error {tail}")
        with open(path, "wb") as f:
            f.write(out[: n + tail].tobytes())
            # finalize the Info/LAME tag written as a placeholder first
            # frame: it records encoder delay+padding for gapless decode
            tag = np.empty(8192, np.uint8)
            tn = la.lame_get_lametag_frame(
                gfp, tag.ctypes.data_as(ctypes.c_void_p), tag.size
            )
            if 0 < tn <= tag.size:
                f.seek(0)
                f.write(tag[:tn].tobytes())
    finally:
        la.lame_close(gfp)


class Mp3StreamReader:
    """Windowed MP3 access for :class:`StreamingSamplerNode`: one open
    mpg123 handle, sample-exact seeks from the scan-time frame index.
    Satisfies the stream-reader protocol; reads outside
    ``[0, len_frames)`` zero-pad (pre-roll yields leading zeros at the
    correct positions, matching WavStreamReader)."""

    def __init__(self, path: str):
        self.path = path
        self._h = _Handle(path)
        self.num_channels = self._h.channels
        self.sample_rate = self._h.rate
        self.len_frames = self._h.len_frames
        self._pos = 0

    def read(self, start_frame: int, num_frames: int) -> np.ndarray:
        from ..core.formats import read_window

        def decode(start: int, count: int) -> np.ndarray:
            ch = self.num_channels
            if self._pos != start:
                self._h.seek(start)
            flat = self._h.read_frames(count)
            got = flat.size // ch
            self._pos = start + got
            return flat[: got * ch].reshape(got, ch).T

        return read_window(self.len_frames, self.num_channels,
                           start_frame, num_frames, decode)

    def close(self):
        self._h.close()
