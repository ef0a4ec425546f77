"""FLAC decoding, pure NumPy — the compressed-format half of the
reference's "loading a wide variety of audio formats (using Symphonia)"
goal (the reference's ``DESIGN_DOC.md:33``; the reference never wired a
decoder — Symphonia would have supplied FLAC/MP3/OGG).

Scope: the full FLAC bitstream as shipped by every mainstream encoder —
CONSTANT / VERBATIM / FIXED(0-4) / LPC(1-32) subframes, Rice and Rice2
residual partitions (escape codes included), wasted bits, all four
channel assignments (independent, left/side, right/side, mid/side),
8/12/16/20/24/32-bit samples, fixed and variable blocking.  Frame
header CRC-8 and frame CRC-16 are verified; the STREAMINFO MD5 can be
verified on a full decode.

Two consumers:

* :func:`decode_flac` — whole-file decode → ``(f32[ch, n], rate)``,
  registered with :mod:`~firewheel_tpu.core.formats` for ``.flac`` so
  ``load_audio("x.flac")`` just works.
* :class:`FlacStreamReader` — the stream-reader protocol
  (``num_channels`` / ``len_frames`` / ``sample_rate`` /
  ``read(start, n)``) over any byte source with ``read(off, size)``
  (a file, or a :class:`~firewheel_tpu.utils.net_stream.SegmentCache`
  over HTTP), so :class:`~firewheel_tpu.nodes.streaming_sampler.
  StreamingSamplerNode` streams FLAC music beds from disk or network.
  FLAC frames have no length field, so random access decodes forward
  from the nearest indexed frame; the reader keeps a byte-offset index
  of every frame it has visited plus an LRU of decoded frames, making
  sequential playback O(new frames) and backward seeks O(replay from
  index).

Everything is stdlib + NumPy; bit-level work runs on unpacked bit
arrays with vectorized extraction wherever the format allows (warm-up
samples, verbatim blocks, Rice remainders) and tight integer loops for
the two inherently sequential parts (Rice terminator scan, LPC
recurrence).
"""

from __future__ import annotations

import bisect
import hashlib
import mmap
import os
from collections import OrderedDict
from typing import Callable, Optional

import numpy as np

__all__ = ["decode_flac", "FlacStreamReader", "StreamInfo", "FlacError"]


class FlacError(ValueError):
    pass


# ---------------------------------------------------------------------------
# CRCs (FLAC uses CRC-8 poly 0x07 for frame headers, CRC-16 poly 0x8005
# init 0 for whole frames)
def _crc_table(poly: int, width: int) -> np.ndarray:
    top = 1 << (width - 1)
    mask = (1 << width) - 1
    tbl = np.zeros(256, np.uint32)
    for i in range(256):
        c = i << (width - 8)
        for _ in range(8):
            c = ((c << 1) ^ poly) if (c & top) else (c << 1)
        tbl[i] = c & mask
    return tbl


_CRC8_TBL = _crc_table(0x07, 8)
_CRC16_TBL = _crc_table(0x8005, 16)


def _native_crc():
    """The shared C++ CRC kernels (backend/native/crc.cpp), or None
    without a toolchain — lazy + cached like :func:`_native_lpc`.  The
    Python table loops below cost ~5 ms per 8 kB frame, a quarter of the
    whole encode budget (docs/FORMATS.md)."""
    global _NATIVE_CRC
    if _NATIVE_CRC is _CRC_UNSET:
        try:
            from ..backend.ring_buffer import _load_native

            lib = _load_native()
            if lib is not None:
                import ctypes

                for fn in (lib.flac_crc8, lib.flac_crc16):
                    fn.restype = ctypes.c_uint32
                    fn.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                   ctypes.c_uint32]
            _NATIVE_CRC = lib or None
        except Exception:  # pragma: no cover - toolchain-dependent
            _NATIVE_CRC = None
    return _NATIVE_CRC


_CRC_UNSET = object()
_NATIVE_CRC: "object" = _CRC_UNSET


def crc8(data: bytes, init: int = 0) -> int:
    lib = _native_crc()
    if lib is not None:
        return int(lib.flac_crc8(bytes(data), len(data), init))
    c = init
    for b in data:
        c = int(_CRC8_TBL[(c ^ b) & 0xFF])
    return c


def crc16(data: bytes, init: int = 0) -> int:
    lib = _native_crc()
    if lib is not None:
        return int(lib.flac_crc16(bytes(data), len(data), init))
    c = init
    tbl = _CRC16_TBL
    for b in data:
        c = (int(tbl[((c >> 8) ^ b) & 0xFF]) ^ ((c << 8) & 0xFFFF)) & 0xFFFF
    return c


# ---------------------------------------------------------------------------
class StreamInfo:
    """Parsed STREAMINFO block."""

    def __init__(self, min_block, max_block, min_frame, max_frame,
                 sample_rate, channels, bits, total_samples, md5):
        self.min_block = min_block
        self.max_block = max_block
        self.min_frame = min_frame
        self.max_frame = max_frame
        self.sample_rate = sample_rate
        self.channels = channels
        self.bits = bits
        self.total_samples = total_samples
        self.md5 = md5


def _parse_stream_header(read: Callable[[int, int], bytes]):
    """Magic + metadata blocks → (StreamInfo, first_frame_byte_offset)."""
    if read(0, 4) != b"fLaC":
        raise FlacError("not a FLAC stream (missing fLaC magic)")
    pos = 4
    info = None
    while True:
        hdr = read(pos, 4)
        if len(hdr) < 4:
            raise FlacError("truncated metadata")
        last = bool(hdr[0] & 0x80)
        btype = hdr[0] & 0x7F
        size = int.from_bytes(hdr[1:4], "big")
        if btype == 0:  # STREAMINFO
            p = read(pos + 4, size)
            if len(p) < 34:
                raise FlacError("truncated STREAMINFO")
            v = int.from_bytes(p[10:18], "big")
            info = StreamInfo(
                min_block=int.from_bytes(p[0:2], "big"),
                max_block=int.from_bytes(p[2:4], "big"),
                min_frame=int.from_bytes(p[4:7], "big"),
                max_frame=int.from_bytes(p[7:10], "big"),
                sample_rate=(v >> 44) & 0xFFFFF,
                channels=((v >> 41) & 0x7) + 1,
                bits=((v >> 36) & 0x1F) + 1,
                total_samples=v & 0xFFFFFFFFF,
                md5=p[18:34],
            )
        pos += 4 + size
        if last:
            break
    if info is None:
        raise FlacError("no STREAMINFO block")
    return info, pos


# ---------------------------------------------------------------------------
_POW2 = [np.zeros(0, np.uint64)] + [
    (np.uint64(1) << np.arange(n - 1, -1, -1, dtype=np.uint64))
    for n in range(1, 57)
]

_BLOCK_SIZES = {
    1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
    8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096, 13: 8192,
    14: 16384, 15: 32768,
}
_RATES = {1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000, 6: 22050,
          7: 24000, 8: 32000, 9: 44100, 10: 48000, 11: 96000}
_BITS = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}


class _Bits:
    """Big-endian bit reader over a lazily-extended byte window.

    ``fetch(abs_off, size) -> bytes`` supplies data; the reader unpacks
    into a growing bit array.  ``pos`` is the absolute bit position
    relative to ``base`` (the window's first byte)."""

    CHUNK = 1 << 16

    def __init__(self, fetch: Callable[[int, int], bytes], base: int):
        self._fetch = fetch
        self.base = base
        self._bits = np.zeros(0, np.uint8)
        self._nbytes = 0
        self._eof = False
        self.pos = 0

    def _extend(self) -> bool:
        if self._eof:
            return False
        chunk = self._fetch(self.base + self._nbytes, self.CHUNK)
        if not chunk:
            self._eof = True
            return False
        arr = np.unpackbits(np.frombuffer(chunk, np.uint8))
        self._bits = np.concatenate([self._bits, arr])
        self._nbytes += len(chunk)
        if len(chunk) < self.CHUNK:
            self._eof = True
        return True

    def _ensure(self, nbits: int):
        while self.pos + nbits > self._bits.size:
            if not self._extend():
                raise FlacError("unexpected end of FLAC stream")

    def take(self, n: int) -> int:
        """n unsigned bits, big-endian."""
        if n == 0:
            return 0
        self._ensure(n)
        v = int(self._bits[self.pos:self.pos + n].astype(np.uint64)
                @ _POW2[n])
        self.pos += n
        return v

    def take_signed(self, n: int) -> int:
        v = self.take(n)
        return v - (1 << n) if v >= (1 << (n - 1)) else v

    def take_unary(self) -> int:
        """Count 0-bits up to the terminating 1-bit."""
        start = self.pos
        while True:
            rest = self._bits[self.pos:]
            nz = np.flatnonzero(rest)
            if nz.size:
                self.pos += int(nz[0]) + 1
                return self.pos - 1 - start
            self.pos = self._bits.size
            if not self._extend():
                raise FlacError("unexpected end of stream in unary code")

    def take_signed_block(self, bits: int, n: int) -> np.ndarray:
        """n signed samples of `bits` bits each (vectorized)."""
        if n == 0 or bits == 0:
            return np.zeros(n, np.int64)
        self._ensure(bits * n)
        blk = self._bits[self.pos:self.pos + bits * n]
        self.pos += bits * n
        vals = (blk.reshape(n, bits).astype(np.uint64) @ _POW2[bits]
                ).astype(np.int64)
        sign = np.int64(1) << np.int64(bits - 1)
        return np.where(vals >= sign, vals - (sign << np.int64(1)), vals)

    def take_rice_block(self, k: int, n: int) -> np.ndarray:
        """n Rice codes with parameter k → zigzag-decoded residuals.

        Pass 1 is a tight integer loop over terminator positions (the
        quotients are inherently sequential: each code's start depends
        on the previous code's length); pass 2 extracts all k-bit
        remainders in one vectorized gather."""
        if n == 0:
            return np.zeros(0, np.int64)
        ts = np.empty(n, np.int64)
        p = self.pos
        bits = self._bits
        ones = np.flatnonzero(bits[p:]) + p
        j = 0
        m = ones.size
        for i in range(n):
            while True:
                while j < m and ones[j] < p:
                    j += 1
                if j >= m:
                    # ran off the buffered window: extend and rescan the
                    # tail (rare — one rescan per 64 KiB chunk)
                    if not self._extend():
                        raise FlacError("unexpected end of Rice partition")
                    bits = self._bits
                    ones = np.flatnonzero(bits[p:]) + p
                    j, m = 0, ones.size
                    continue
                break
            t = int(ones[j])
            ts[i] = t
            p = t + 1 + k
        self._ensure(p - self.pos)  # the final remainder must be in-buffer
        bits = self._bits
        starts = np.concatenate([[self.pos], ts[:-1] + 1 + k])
        q = (ts - starts).astype(np.int64)
        if k:
            idx = ts[:, None] + 1 + np.arange(k, dtype=np.int64)[None, :]
            rem = (bits[idx].astype(np.uint64) @ _POW2[k]).astype(np.int64)
        else:
            rem = np.zeros(n, np.int64)
        self.pos = p
        u = (q << np.int64(k)) | rem
        return (u >> np.int64(1)) ^ -(u & np.int64(1))  # zigzag

    def align(self):
        self.pos = (self.pos + 7) & ~7

    def byte_off(self) -> int:
        """Current byte offset within the window (must be byte-aligned)."""
        assert self.pos % 8 == 0
        return self.pos // 8

    def bytes_between(self, bit_a: int, bit_b: int) -> bytes:
        assert bit_a % 8 == 0 and bit_b % 8 == 0
        return np.packbits(self._bits[bit_a:bit_b]).tobytes()


def _read_coded_number(br: _Bits) -> int:
    """The frame header's UTF-8-style coded frame/sample number
    (extended to 7 bytes for 36-bit values)."""
    b0 = br.take(8)
    if b0 < 0x80:
        return b0
    n = 0
    while b0 & (0x80 >> n):
        n += 1
    if n < 2 or n > 7:
        raise FlacError(f"invalid coded number lead byte {b0:#x}")
    v = b0 & (0x7F >> n)
    for _ in range(n - 1):
        b = br.take(8)
        if (b & 0xC0) != 0x80:
            raise FlacError("invalid coded number continuation")
        v = (v << 6) | (b & 0x3F)
    return v


_FIXED_COEFFS = {
    0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1],
}


def _undo_fixed(order: int, warm: np.ndarray, resid: np.ndarray) -> np.ndarray:
    """Invert the order-o fixed predictor: o-fold cumulative sum seeded
    by the warm-up samples' finite-difference pyramid."""
    if order == 0:
        return resid
    # boundary finite differences d^j of the warm-up tail
    d = warm.astype(np.int64)
    seeds = [d[-1]]
    for _ in range(order - 1):
        d = np.diff(d)
        seeds.append(d[-1])
    x = resid.astype(np.int64)
    for j in range(order - 1, -1, -1):
        x = np.cumsum(np.concatenate([[seeds[j]], x]))[1:]
    return x


def _native_lpc():
    """The shared C++ kernel (backend/native/lpc.cpp), or None without a
    toolchain.  Lazy + cached: the import reaches into the backend layer
    only for its .so loader, no engine objects."""
    global _NATIVE_LPC
    if _NATIVE_LPC is _UNSET:
        try:
            from ..backend.ring_buffer import _load_native

            _NATIVE_LPC = _load_native() or None
        except Exception:  # pragma: no cover - toolchain-dependent
            _NATIVE_LPC = None
    return _NATIVE_LPC


_UNSET = object()
_NATIVE_LPC: "object" = _UNSET


def _undo_lpc(warm: np.ndarray, coeffs: list[int], shift: int,
              resid: np.ndarray) -> np.ndarray:
    """x[i] = r[i] + (Σ c_j · x[i-1-j]) >> shift — exact int64 math
    (spec bounds: |c| ≤ 2^14, order ≤ 32, |x| ≤ 2^32 ⇒ |Σ| ≤ 2^51).
    The recurrence is sequential; the native kernel runs it at C speed,
    the Python loop below is the no-toolchain fallback."""
    o = len(coeffs)
    lib = _native_lpc()
    if lib is not None and o > 0:
        import ctypes

        warm64 = np.ascontiguousarray(warm, np.int64)
        c32 = np.ascontiguousarray(coeffs, np.int32)
        r64 = np.ascontiguousarray(resid, np.int64)
        out = np.empty(r64.size, np.int64)
        lib.flac_lpc(
            warm64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            o,
            c32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            int(shift),
            r64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            r64.size,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        return out
    hist = [int(v) for v in warm]
    out = np.empty(resid.size, np.int64)
    rl = resid.tolist()
    for i, r in enumerate(rl):
        acc = 0
        for j in range(o):
            acc += coeffs[j] * hist[-1 - j]
        v = r + (acc >> shift)
        out[i] = v
        hist.append(v)
        if len(hist) > o:
            del hist[0]
    return out


def _decode_subframe(br: _Bits, bits: int, n: int) -> np.ndarray:
    if br.take(1):
        raise FlacError("subframe padding bit set")
    stype = br.take(6)
    wasted = 0
    if br.take(1):
        wasted = br.take_unary() + 1
        bits -= wasted
    if stype == 0b000000:
        x = np.full(n, br.take_signed(bits), np.int64)
    elif stype == 0b000001:
        x = br.take_signed_block(bits, n)
    elif 0b001000 <= stype <= 0b001100:
        order = stype & 0x7
        warm = br.take_signed_block(bits, order)
        resid = _decode_residual(br, n, order)
        x = np.concatenate([warm, _undo_fixed(order, warm, resid)])
    elif stype >= 0b100000:
        order = (stype & 0x1F) + 1
        warm = br.take_signed_block(bits, order)
        prec = br.take(4) + 1
        if prec == 16:
            raise FlacError("invalid LPC precision escape")
        shift = br.take_signed(5)
        if shift < 0:
            raise FlacError("negative LPC shift")
        coeffs = [br.take_signed(prec) for _ in range(order)]
        resid = _decode_residual(br, n, order)
        x = np.concatenate([warm, _undo_lpc(warm, coeffs, shift, resid)])
    else:
        raise FlacError(f"reserved subframe type {stype:#08b}")
    if wasted:
        x = x << np.int64(wasted)
    return x


def _decode_residual(br: _Bits, n: int, order: int) -> np.ndarray:
    method = br.take(2)
    if method > 1:
        raise FlacError(f"reserved residual method {method}")
    pbits, escape = (4, 0xF) if method == 0 else (5, 0x1F)
    porder = br.take(4)
    parts = 1 << porder
    if n % parts:
        raise FlacError("partition order does not divide block size")
    out = []
    for p in range(parts):
        cnt = n // parts - (order if p == 0 else 0)
        if cnt < 0:
            raise FlacError("predictor order exceeds first partition")
        k = br.take(pbits)
        if k == escape:
            raw = br.take(5)
            out.append(br.take_signed_block(raw, cnt))
        else:
            out.append(br.take_rice_block(k, cnt))
    return np.concatenate(out) if out else np.zeros(0, np.int64)


class _Frame:
    __slots__ = ("first_sample", "block_size", "samples", "byte_size")

    def __init__(self, first_sample, block_size, samples, byte_size):
        self.first_sample = first_sample
        self.block_size = block_size
        self.samples = samples  # int32 [ch, block]
        self.byte_size = byte_size


def _decode_frame(read: Callable[[int, int], bytes], off: int,
                  info: StreamInfo, verify_crc: bool = True) -> _Frame:
    """Decode one frame at byte offset ``off``."""
    br = _Bits(read, off)
    sync = br.take(14)
    if sync != 0b11111111111110:
        raise FlacError(f"bad frame sync {sync:#x} at byte {off}")
    if br.take(1):
        raise FlacError("reserved frame-header bit set")
    variable = br.take(1)
    bs_code = br.take(4)
    sr_code = br.take(4)
    ch_code = br.take(4)
    ss_code = br.take(3)
    if br.take(1):
        raise FlacError("reserved frame-header bit set")
    coded = _read_coded_number(br)
    if bs_code == 0:
        raise FlacError("reserved block-size code 0")
    elif bs_code == 6:
        block = br.take(8) + 1
    elif bs_code == 7:
        block = br.take(16) + 1
    else:
        block = _BLOCK_SIZES[bs_code]
    if sr_code == 12:
        br.take(8)
    elif sr_code in (13, 14):
        br.take(16)
    elif sr_code == 15:
        raise FlacError("invalid sample-rate code")
    hdr_end = br.pos
    crc = br.take(8)
    if verify_crc:
        if crc8(br.bytes_between(0, hdr_end)) != crc:
            raise FlacError(f"frame header CRC-8 mismatch at byte {off}")

    if ss_code == 3:
        raise FlacError("reserved sample-size code")
    bits = _BITS.get(ss_code, info.bits) if ss_code else info.bits
    # variable blocking codes the first SAMPLE number; fixed blocking
    # codes the FRAME number (x stream block size, which fixed blocking
    # pins to min_block == max_block)
    first_sample = coded if variable else coded * info.max_block

    if ch_code <= 7:
        nch = ch_code + 1
        chans = [_decode_subframe(br, bits, block) for _ in range(nch)]
    elif ch_code in (8, 9, 10):
        nch = 2
        # the SIDE channel carries one extra bit
        if ch_code == 8:    # left/side
            left = _decode_subframe(br, bits, block)
            side = _decode_subframe(br, bits + 1, block)
            chans = [left, left - side]
        elif ch_code == 9:  # side/right
            side = _decode_subframe(br, bits + 1, block)
            right = _decode_subframe(br, bits, block)
            chans = [right + side, right]
        else:               # mid/side
            mid = _decode_subframe(br, bits, block)
            side = _decode_subframe(br, bits + 1, block)
            m2 = (mid << np.int64(1)) | (side & np.int64(1))
            chans = [(m2 + side) >> np.int64(1), (m2 - side) >> np.int64(1)]
    else:
        raise FlacError(f"reserved channel assignment {ch_code}")
    if nch != info.channels:
        raise FlacError("frame channel count differs from STREAMINFO")

    br.align()
    body_end = br.pos
    fcrc = br.take(16)
    if verify_crc:
        if crc16(br.bytes_between(0, body_end)) != fcrc:
            raise FlacError(f"frame CRC-16 mismatch at byte {off}")
    samples = np.stack(chans).astype(np.int64)
    return _Frame(first_sample, block, samples, br.byte_off())


def _int_to_f32(x: np.ndarray, bits: int) -> np.ndarray:
    """Signed int samples → f32 in [-1, 1) — ``x / 2^(bits-1)``, matching
    the i16 load formula (sample_resource.rs:338-340) generalized."""
    return (x.astype(np.float64) / float(1 << (bits - 1))).astype(np.float32)


# ---------------------------------------------------------------------------
def _source_reader(source) -> tuple[Callable[[int, int], bytes], Optional[int]]:
    """Normalize a byte source → (read(off, size), total_or_None)."""
    if isinstance(source, (bytes, bytearray, memoryview)):
        data = bytes(source)
        return (lambda off, size: data[off:off + size]), len(data)
    if isinstance(source, (str, os.PathLike)):
        f = open(source, "rb")
        try:
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        except (ValueError, OSError):
            mm = f.read()
        return (lambda off, size: bytes(mm[off:off + size])), len(mm)
    if hasattr(source, "read") and not hasattr(source, "read_range"):
        # SegmentCache-style: read(offset, size) -> bytes
        return source.read, None
    if hasattr(source, "read_range"):
        return source.read_range, None
    raise TypeError(f"unsupported FLAC byte source {type(source).__name__}")


def decode_flac(source, verify_md5: bool = False):
    """Decode a whole FLAC stream → ``(f32[channels, frames], rate)``.

    ``source``: path, bytes, or any object with ``read(off, size)``.
    ``verify_md5=True`` additionally checks the decoded PCM against the
    STREAMINFO MD5 signature."""
    read, _ = _source_reader(source)
    info, off = _parse_stream_header(read)
    frames = []
    total = 0
    while info.total_samples == 0 or total < info.total_samples:
        probe = read(off, 2)
        if len(probe) < 2:
            break
        fr = _decode_frame(read, off, info)
        frames.append(fr.samples)
        total += fr.block_size
        off += fr.byte_size
    if not frames:
        raise FlacError("no audio frames")
    pcm = np.concatenate(frames, axis=1)
    if info.total_samples:
        pcm = pcm[:, : info.total_samples]
    if verify_md5 and info.md5 != b"\x00" * 16:
        if _pcm_md5(pcm, info.bits) != info.md5:
            raise FlacError("decoded audio fails the STREAMINFO MD5 check")
    return _int_to_f32(pcm, info.bits), info.sample_rate


def _pcm_md5(pcm: np.ndarray, bits: int) -> bytes:
    """STREAMINFO MD5: interleaved little-endian signed PCM."""
    nbytes = (bits + 7) // 8
    inter = pcm.T.reshape(-1)  # frame-major interleave
    if nbytes in (1, 2, 4):
        dt = {1: "<i1", 2: "<i2", 4: "<i4"}[nbytes]
        raw = inter.astype(dt).tobytes()
    else:  # 24-bit: pack 3 LE bytes per sample
        as32 = inter.astype("<i4").view(np.uint8).reshape(-1, 4)
        raw = as32[:, :3].tobytes()
    return hashlib.md5(raw).digest()


class FlacStreamReader:
    """Windowed FLAC access satisfying the stream-reader protocol
    (``num_channels`` / ``len_frames`` / ``sample_rate`` /
    ``read(start, n)``) used by :class:`~firewheel_tpu.nodes.
    streaming_sampler.StreamingSamplerNode`.

    ``source``: a path (mmap-backed), bytes, or any ``read(off, size)``
    byte source — pass a :class:`~firewheel_tpu.utils.net_stream.
    SegmentCache` over an :class:`~firewheel_tpu.utils.net_stream.
    HttpByteSource` for network streaming (the cache coalesces the
    decoder's small reads into range requests).

    ``cache_frames``: decoded-frame LRU depth.  32 frames of 4096
    samples ≈ 1.4 M samples — far past the sampler's lookahead window.
    """

    def __init__(self, source, cache_frames: int = 32):
        self._read, _ = _source_reader(source)
        self.info, self._first_off = _parse_stream_header(self._read)
        if self.info.total_samples == 0:
            raise FlacError(
                "FLAC stream does not declare total_samples; the stream-"
                "reader protocol needs a length (re-encode with a length, "
                "or decode fully with decode_flac)"
            )
        self.num_channels = self.info.channels
        self.len_frames = self.info.total_samples
        self.sample_rate = float(self.info.sample_rate)
        #: frame index: sample position → byte offset for every frame
        #: boundary we have visited (parallel arrays, ascending)
        self._idx_samples = [0]
        self._idx_offsets = [self._first_off]
        self._frontier = (0, self._first_off)  # (next_sample, next_byte)
        self._lru: "OrderedDict[int, _Frame]" = OrderedDict()
        self._cache_frames = int(cache_frames)

    def _frame_at(self, off: int) -> _Frame:
        fr = self._lru.get(off)
        if fr is None:
            fr = _decode_frame(self._read, off, self.info)
            self._lru[off] = fr
            while len(self._lru) > self._cache_frames:
                self._lru.popitem(last=False)
        else:
            self._lru.move_to_end(off)
        return fr

    def read(self, start_frame: int, num_frames: int) -> np.ndarray:
        """f32 ``[channels, num_frames]`` at ``start_frame``, zero-padded
        past EOF (the protocol's contract)."""
        start = int(start_frame)
        n = int(num_frames)
        out = np.zeros((self.num_channels, n), np.float32)
        if n <= 0 or start >= self.len_frames:
            return out
        if start < 0:
            # pre-roll: positions before frame 0 are zeros at the correct
            # offsets (matches WavStreamReader), not a time-shifted read
            if start + n > 0:
                out[:, -start:] = self.read(0, start + n)
            return out
        # find the nearest indexed frame at or before `start`
        i = bisect.bisect_right(self._idx_samples, start) - 1
        sample, off = self._idx_samples[i], self._idx_offsets[i]
        end = min(start + n, self.len_frames)
        while sample < end:
            probe = self._read(off, 2)
            if len(probe) < 2:
                break
            fr = self._frame_at(off)
            nxt_sample, nxt_off = sample + fr.block_size, off + fr.byte_size
            if nxt_sample > self._frontier[0]:
                self._idx_samples.append(nxt_sample)
                self._idx_offsets.append(nxt_off)
                self._frontier = (nxt_sample, nxt_off)
            lo = max(start, sample)
            hi = min(end, nxt_sample)
            if hi > lo:
                out[:, lo - start:hi - start] = _int_to_f32(
                    fr.samples[:, lo - sample:hi - sample], self.info.bits
                )
            sample, off = nxt_sample, nxt_off
        return out

    def close(self):
        """Drop the decoded-frame cache and the byte-source reference
        (an underlying SegmentCache/HttpByteSource should be closed by
        its owner; a path-backed mmap is released here)."""
        self._lru.clear()
        self._read = None
