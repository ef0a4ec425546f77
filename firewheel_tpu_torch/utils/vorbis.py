"""Ogg Vorbis decode/encode via the system codec libraries (ctypes).

Reference scope: "Support for loading a wide variety of audio formats
(using Symphonia)" (the reference's ``DESIGN_DOC.md:32-33`` — Symphonia
decodes OGG/Vorbis).  Mirrors ``utils/mp3.py``: **libvorbisfile** for
decoding (float output straight from the codec's internal float
pipeline — no quantization round-trip) and **libvorbisenc + libvorbis +
libogg** for encoding (VBR, for tests and asset tooling).  All four
ship in this image and on every mainstream distro; when absent, the
format registry simply reports the extension as unsupported.

``VorbisStreamReader`` keeps one ``OggVorbis_File`` handle open and
serves the windowed stream-reader protocol with sample-exact
``ov_pcm_seek`` positioning, so :class:`StreamingSamplerNode` and
:class:`MusicPlayer` decks can play compressed music beds without a
full decode.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

__all__ = [
    "available",
    "decode_vorbis",
    "encode_vorbis",
    "VorbisStreamReader",
]

_lock = threading.Lock()
_vf = _venc = _vorbis = _ogg = None
_probed = False

# Opaque library structs are only ever passed by pointer; generous
# fixed-size buffers stand in for their storage (real sizeof on the
# x86-64 build this was probed against: OggVorbis_File ~944,
# ogg_stream_state ~408, vorbis_dsp_state ~160, vorbis_block ~192,
# vorbis_info ~48, vorbis_comment ~32).  ASSUMPTION: a distro/arch
# build whose struct exceeded the buffer would corrupt the heap
# silently rather than fail cleanly — hence a uniform ≥4× margin over
# every measured sizeof.
_OVFILE_SIZE = 4096
_OPAQUE_SIZE = 4096


class _OggPacket(ctypes.Structure):
    _fields_ = [
        ("packet", ctypes.POINTER(ctypes.c_ubyte)),
        ("bytes", ctypes.c_long),
        ("b_o_s", ctypes.c_long),
        ("e_o_s", ctypes.c_long),
        ("granulepos", ctypes.c_int64),
        ("packetno", ctypes.c_int64),
    ]


class _OggPage(ctypes.Structure):
    _fields_ = [
        ("header", ctypes.POINTER(ctypes.c_ubyte)),
        ("header_len", ctypes.c_long),
        ("body", ctypes.POINTER(ctypes.c_ubyte)),
        ("body_len", ctypes.c_long),
    ]


class _VorbisInfo(ctypes.Structure):
    # prefix of struct vorbis_info (codec.h) — the fields we read, plus
    # tail padding so the library can use its full struct
    _fields_ = [
        ("version", ctypes.c_int),
        ("channels", ctypes.c_int),
        ("rate", ctypes.c_long),
        ("_tail", ctypes.c_ubyte * _OPAQUE_SIZE),
    ]


def _load():
    global _vf, _venc, _vorbis, _ogg, _probed
    with _lock:
        if _probed:
            return _vf, _venc
        _probed = True
        try:
            v = ctypes.CDLL("libvorbisfile.so.3", mode=ctypes.RTLD_GLOBAL)
            v.ov_fopen.restype = ctypes.c_int
            v.ov_fopen.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
            v.ov_clear.restype = ctypes.c_int
            v.ov_clear.argtypes = [ctypes.c_void_p]
            v.ov_info.restype = ctypes.POINTER(_VorbisInfo)
            v.ov_info.argtypes = [ctypes.c_void_p, ctypes.c_int]
            v.ov_pcm_total.restype = ctypes.c_int64
            v.ov_pcm_total.argtypes = [ctypes.c_void_p, ctypes.c_int]
            v.ov_pcm_seek.restype = ctypes.c_int
            v.ov_pcm_seek.argtypes = [ctypes.c_void_p, ctypes.c_int64]
            v.ov_read_float.restype = ctypes.c_long
            v.ov_read_float.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(
                    ctypes.POINTER(ctypes.POINTER(ctypes.c_float))
                ),
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_int),
            ]
            _vf = v
        except Exception:
            _vf = None
        try:
            og = ctypes.CDLL("libogg.so.0", mode=ctypes.RTLD_GLOBAL)
            vo = ctypes.CDLL("libvorbis.so.0", mode=ctypes.RTLD_GLOBAL)
            ve = ctypes.CDLL("libvorbisenc.so.2", mode=ctypes.RTLD_GLOBAL)
            for lib, names in (
                (og, ("ogg_stream_init", "ogg_stream_packetin",
                      "ogg_stream_pageout", "ogg_stream_flush",
                      "ogg_stream_clear")),
                (vo, ("vorbis_analysis_headerout", "vorbis_analysis_init",
                      "vorbis_block_init", "vorbis_analysis_wrote",
                      "vorbis_analysis_blockout", "vorbis_analysis",
                      "vorbis_bitrate_addblock", "vorbis_bitrate_flushpacket",
                      "vorbis_block_clear", "vorbis_dsp_clear",
                      "vorbis_comment_clear", "vorbis_info_clear")),
                (ve, ("vorbis_encode_init_vbr",)),
            ):
                for n in names:
                    getattr(lib, n).restype = ctypes.c_int
            vo.vorbis_info_init.restype = None
            vo.vorbis_comment_init.restype = None
            vo.vorbis_analysis_buffer.restype = ctypes.POINTER(
                ctypes.POINTER(ctypes.c_float)
            )
            vo.vorbis_analysis_buffer.argtypes = [
                ctypes.c_void_p, ctypes.c_int,
            ]
            ve.vorbis_encode_init_vbr.argtypes = [
                ctypes.c_void_p, ctypes.c_long, ctypes.c_long,
                ctypes.c_float,
            ]
            _ogg, _vorbis, _venc = og, vo, ve
        except Exception:
            _venc = _vorbis = _ogg = None
        return _vf, _venc


def available() -> dict:
    """{"decode": bool, "encode": bool} — what the system libraries allow."""
    vf, venc = _load()
    return {"decode": vf is not None, "encode": venc is not None}


class _Handle:
    """An opened libvorbisfile handle (seekable, scanned length)."""

    def __init__(self, path: str):
        vf, _ = _load()
        if vf is None:
            raise ValueError(
                "Vorbis decoding unavailable: libvorbisfile.so.3 not "
                "found (install libvorbis, or register_format an "
                "external decoder)"
            )
        self.vf = vf
        self.buf = ctypes.create_string_buffer(_OVFILE_SIZE)
        self.open = False
        rc = vf.ov_fopen(os.fsencode(path), self.buf)
        if rc != 0:
            raise ValueError(f"libvorbisfile cannot open {path!r} ({rc})")
        self.open = True
        info = vf.ov_info(self.buf, -1)
        if not info:
            self.close()
            raise ValueError(f"no Vorbis stream in {path!r}")
        self.channels = int(info.contents.channels)
        self.rate = int(info.contents.rate)
        self.len_frames = max(int(vf.ov_pcm_total(self.buf, -1)), 0)

    def read_frames(self, n: int) -> np.ndarray:
        """Decode up to ``n`` frames → f32 ``[channels, got]`` (shorter
        at EOF)."""
        out = np.empty((self.channels, n), np.float32)
        pcm = ctypes.POINTER(ctypes.POINTER(ctypes.c_float))()
        bs = ctypes.c_int(0)
        got = 0
        while got < n:
            r = self.vf.ov_read_float(
                self.buf, ctypes.byref(pcm), n - got, ctypes.byref(bs)
            )
            if r == 0:
                break
            if r == -3:  # OV_HOLE: transient gap — resync and continue
                continue
            if r < 0:  # OV_EBADLINK/OV_EINVAL etc. repeat forever —
                raise ValueError(f"ov_read_float error {r}")  # don't spin
            for c in range(self.channels):
                out[c, got:got + r] = np.ctypeslib.as_array(pcm[c], (r,))
            got += r
        return out[:, :got]

    def seek(self, frame: int) -> None:
        if self.vf.ov_pcm_seek(self.buf, int(frame)) != 0:
            raise ValueError(f"vorbis seek to {frame} failed")

    def close(self):
        if self.open:
            self.vf.ov_clear(self.buf)
            self.open = False

    def __del__(self):  # pragma: no cover - GC timing
        try:
            self.close()
        except Exception:
            pass


def decode_vorbis(path: str) -> tuple[np.ndarray, int]:
    """Decode a whole Ogg Vorbis file → ``(f32 [channels, frames],
    sample_rate)``."""
    h = _Handle(path)
    try:
        chunks = []
        while True:
            c = h.read_frames(1 << 16)
            if c.shape[1] == 0:
                break
            chunks.append(c)
        if not chunks:
            return np.zeros((h.channels, 0), np.float32), h.rate
        return np.concatenate(chunks, axis=1), h.rate
    finally:
        h.close()


def encode_vorbis(path: str, audio: np.ndarray, sample_rate: int,
                  quality: float = 0.5) -> None:
    """Encode f32 ``[channels, frames]`` (or ``[frames]``) to an Ogg
    Vorbis file (VBR; ``quality`` in [-0.1, 1.0], 0.5 ≈ 160 kbps
    stereo)."""
    _, ve = _load()
    if ve is None:
        raise ValueError(
            "Vorbis encoding unavailable: libvorbisenc/libvorbis/libogg "
            "not found"
        )
    vo, og = _vorbis, _ogg
    audio = np.atleast_2d(np.ascontiguousarray(audio, np.float32))
    ch, frames = audio.shape

    vi = ctypes.create_string_buffer(_OPAQUE_SIZE)
    vc = ctypes.create_string_buffer(_OPAQUE_SIZE)
    vd = ctypes.create_string_buffer(_OPAQUE_SIZE)
    vb = ctypes.create_string_buffer(_OPAQUE_SIZE)
    osb = ctypes.create_string_buffer(_OPAQUE_SIZE)
    vo.vorbis_info_init(vi)
    inited = {"vi": True, "vc": False, "vd": False, "vb": False,
              "os": False}
    try:
        if ve.vorbis_encode_init_vbr(vi, ch, int(sample_rate),
                                     float(quality)) != 0:
            raise ValueError(
                f"vorbis_encode_init_vbr failed (channels={ch}, "
                f"rate={sample_rate}, quality={quality})"
            )
        vo.vorbis_comment_init(vc)
        inited["vc"] = True
        if vo.vorbis_analysis_init(vd, vi) != 0:
            raise ValueError("vorbis_analysis_init failed")
        inited["vd"] = True
        vo.vorbis_block_init(vd, vb)
        inited["vb"] = True
        # fixed serial keeps output deterministic for tests
        og.ogg_stream_init(osb, 0x46573A54)  # "FW:T"
        inited["os"] = True

        pages = []

        def _pump(flush: bool) -> None:
            pg = _OggPage()
            fn = og.ogg_stream_flush if flush else og.ogg_stream_pageout
            while fn(osb, ctypes.byref(pg)) != 0:
                pages.append(
                    ctypes.string_at(pg.header, pg.header_len)
                    + ctypes.string_at(pg.body, pg.body_len)
                )

        h1, h2, h3 = _OggPacket(), _OggPacket(), _OggPacket()
        vo.vorbis_analysis_headerout(
            vd, vc, ctypes.byref(h1), ctypes.byref(h2), ctypes.byref(h3)
        )
        for hp in (h1, h2, h3):
            og.ogg_stream_packetin(osb, ctypes.byref(hp))
        _pump(flush=True)  # audio data must start on a fresh page

        def _blocks_out() -> None:
            op = _OggPacket()
            while vo.vorbis_analysis_blockout(vd, vb) == 1:
                vo.vorbis_analysis(vb, None)
                vo.vorbis_bitrate_addblock(vb)
                while vo.vorbis_bitrate_flushpacket(
                    vd, ctypes.byref(op)
                ) == 1:
                    og.ogg_stream_packetin(osb, ctypes.byref(op))
                    _pump(flush=False)

        step = 4096
        for start in range(0, frames, step):
            n = min(step, frames - start)
            bufp = vo.vorbis_analysis_buffer(vd, n)
            for c in range(ch):
                ctypes.memmove(
                    bufp[c],
                    audio[c, start:start + n].ctypes.data,
                    n * 4,
                )
            vo.vorbis_analysis_wrote(vd, n)
            _blocks_out()
        vo.vorbis_analysis_wrote(vd, 0)  # end-of-stream marker
        _blocks_out()
        _pump(flush=True)

        with open(path, "wb") as f:
            f.write(b"".join(pages))
    finally:
        if inited["os"]:
            og.ogg_stream_clear(osb)
        if inited["vb"]:
            vo.vorbis_block_clear(vb)
        if inited["vd"]:
            vo.vorbis_dsp_clear(vd)
        if inited["vc"]:
            vo.vorbis_comment_clear(vc)
        if inited["vi"]:
            vo.vorbis_info_clear(vi)


class VorbisStreamReader:
    """Windowed Ogg Vorbis access for :class:`StreamingSamplerNode`:
    one open handle, sample-exact ``ov_pcm_seek``.  Satisfies the
    stream-reader protocol; reads outside ``[0, len_frames)`` zero-pad
    (matching ``WavStreamReader``)."""

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
            if self._pos != start:
                self._h.seek(start)
            got = self._h.read_frames(count)
            self._pos = start + got.shape[1]
            return got

        return read_window(self.len_frames, self.num_channels,
                           start_frame, num_frames, decode)

    def close(self):
        self._h.close()
