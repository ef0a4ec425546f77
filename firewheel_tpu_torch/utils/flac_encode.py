"""FLAC encoding (subset), pure NumPy — the export/archival side of the
format story (the reference's ``DESIGN_DOC.md:33`` plans Symphonia-based
*loading*; an encoder lets game tooling ship compressed assets and gives
the decoder an in-environment golden-vector generator).

Subset: fixed predictors (orders 0–4, exhaustive choice by exact coded
cost), CONSTANT/VERBATIM fallbacks, Rice residuals with per-partition
parameter search (escape codes when raw is cheaper), all four stereo
assignments (chosen by cost or forced), 8/16/24-bit, fixed blocking.
No LPC analysis (decode-side LPC is fully supported; fixed predictors
compress pink-ish game audio within ~10 % of LPC at a fraction of the
complexity).

The output is spec-conformant: header CRC-8, frame CRC-16, STREAMINFO
MD5, UTF-8 frame numbers — `decode_flac(encode_flac(x)) == x` bit-exact
on the integer samples, and any third-party FLAC decoder accepts the
stream.
"""

from __future__ import annotations

import hashlib

import numpy as np

from ..core.flac import _pcm_md5, crc8, crc16

__all__ = ["encode_flac"]


class _BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self._acc = 0
        self._n = 0

    def write(self, val: int, nbits: int):
        if nbits == 0:
            return
        self._acc = (self._acc << nbits) | (int(val) & ((1 << nbits) - 1))
        self._n += nbits
        while self._n >= 8:
            self._n -= 8
            self.buf.append((self._acc >> self._n) & 0xFF)
        self._acc &= (1 << self._n) - 1

    def write_unary(self, q: int):
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)  # q zeros then a one

    def write_bits(self, bits: np.ndarray):
        """Append a bool bit array (MSB-first stream order) in one
        vectorized `packbits` — the per-sample Rice/verbatim loops were
        the whole encoder cost (measured: 2.8× realtime;
        vectorized: see docs/FORMATS.md)."""
        if self._n:
            pre = np.array(
                [(self._acc >> (self._n - 1 - i)) & 1
                 for i in range(self._n)], bool
            )
            bits = np.concatenate([pre, np.asarray(bits, bool)])
            self._acc = 0
            self._n = 0
        else:
            bits = np.asarray(bits, bool)
        nbytes = bits.size // 8
        if nbytes:
            self.buf.extend(np.packbits(bits[: 8 * nbytes]).tobytes())
        rem = bits[8 * nbytes:]
        self._n = int(rem.size)
        acc = 0
        for b in rem.tolist():
            acc = (acc << 1) | int(b)
        self._acc = acc

    def align(self):
        if self._n:
            self.write(0, 8 - self._n)

    def bytes(self) -> bytes:
        assert self._n == 0
        return bytes(self.buf)


def _pack_rice_bits(u: np.ndarray, k: int) -> np.ndarray:
    """Rice-code zigzag values ``u`` with parameter ``k`` → bool bit
    array (unary ``q`` zeros + 1, then the k low bits), fully
    vectorized: the terminating-1 positions land by fancy index, each
    of the k low-bit planes by one more."""
    q = (u >> np.int64(k)).astype(np.int64)
    nbits = q + 1 + k
    ends = np.cumsum(nbits)
    starts = ends - nbits
    total = int(ends[-1]) if u.size else 0
    bits = np.zeros(total, bool)
    one_pos = starts + q
    bits[one_pos] = True
    for j in range(k):
        bits[one_pos + 1 + j] = ((u >> np.int64(k - 1 - j)) & 1).astype(bool)
    return bits


def _pack_fixed_width_bits(vals: np.ndarray, width: int) -> np.ndarray:
    """Two's-complement fixed-width codes → bool bit array, one plane
    per bit (verbatim subframes, escaped residual partitions, warmup
    samples)."""
    n = vals.size
    bits = np.zeros(n * width, bool)
    for j in range(width):
        bits[j::width] = ((vals >> np.int64(width - 1 - j)) & 1).astype(bool)
    return bits


def _utf8_number(n: int) -> bytes:
    """FLAC's UTF-8-style coded number (up to 36 bits / 7 bytes)."""
    if n < 0x80:
        return bytes([n])
    for nbytes, bits in ((2, 11), (3, 16), (4, 21), (5, 26), (6, 31), (7, 36)):
        if n < (1 << bits):
            lead_mask = (0xFF << (8 - nbytes)) & 0xFF
            shift = 6 * (nbytes - 1)
            out = [lead_mask | ((n >> shift) & (0x3F >> (nbytes - 2)))]
            for i in range(nbytes - 2, -1, -1):
                out.append(0x80 | ((n >> (6 * i)) & 0x3F))
            return bytes(out)
    raise ValueError("coded number exceeds 36 bits")


_FIXED = {
    0: np.array([], np.int64),
    1: np.array([1], np.int64),
    2: np.array([2, -1], np.int64),
    3: np.array([3, -3, 1], np.int64),
    4: np.array([4, -6, 4, -1], np.int64),
}


def _fixed_residual(x: np.ndarray, order: int) -> np.ndarray:
    r = x.astype(np.int64)
    for _ in range(order):
        r = np.diff(r)
    return r


def _zigzag(r: np.ndarray) -> np.ndarray:
    return (r << np.int64(1)) ^ (r >> np.int64(63))


def _best_rice_k(u: np.ndarray) -> tuple[int, int]:
    """Exact minimum-cost Rice parameter for zigzag values ``u`` →
    (k, coded_bits).  One ``unpackbits`` pass yields the per-bit-plane
    population counts ``c_k``; every shifted sum then follows from the
    exact recurrence ``s_{k+1} = (s_k - c_k) / 2`` in scalar arithmetic
    (``u>>k = 2*(u>>(k+1)) + bit_k``), so all 31 candidate costs are
    evaluated with ONE array pass instead of 31 (this function was the
    encoder's final hotspot after the bit-writer vectorization —
    the profile in docs/FORMATS.md)."""
    n = u.size
    if n == 0:
        return 0, 0
    top = int(u.max()).bit_length()
    s = int(u.sum())
    best_k, best_c = 0, s + n
    if top:
        # per-byte-column value histograms → exact bit-plane counts as
        # a (256,8) table product; all-zero high bytes are skipped
        b = u.astype("<u8").view(np.uint8).reshape(n, 8)
        nb = (top + 7) >> 3
        planes = (
            np.stack([np.bincount(np.ascontiguousarray(b[:, j]),
                                  minlength=256) for j in range(nb)])
            @ _BYTE_BIT_TBL
        ).ravel()
        for k in range(min(30, top)):
            s = (s - int(planes[k])) >> 1  # s = sum(u >> (k+1)), exact
            cost = s + n * (k + 2)
            if cost < best_c:
                best_k, best_c = k + 1, cost
            elif s == 0:
                break  # cost only grows by +n per step from here
    return best_k, best_c


# bit b of byte value v, laid out so hist(256) @ tbl → counts of bit
# planes 0..7 across the column
_BYTE_BIT_TBL = ((np.arange(256)[:, None] >> np.arange(8)[None, :]) & 1
                 ).astype(np.int64)


def _write_residual(w: _BitWriter, resid: np.ndarray, block: int,
                    order: int, partition_order: int):
    parts = 1 << partition_order
    assert block % parts == 0, "partition order must divide block size"
    use_rice2 = False
    chunks, ks, costs = [], [], []
    pos = 0
    for p in range(parts):
        cnt = block // parts - (order if p == 0 else 0)
        r = resid[pos:pos + cnt]
        pos += cnt
        u = _zigzag(r)
        k, c = _best_rice_k(u)
        if k > 14:
            use_rice2 = True
        chunks.append(u)
        ks.append(k)
        costs.append(c)
    pbits, escape = (5, 0x1F) if use_rice2 else (4, 0xF)
    w.write(1 if use_rice2 else 0, 2)
    w.write(partition_order, 4)
    for u, k, rice_cost in zip(chunks, ks, costs):
        raw_bits = (int(np.max(np.abs(
            (u >> np.int64(1)) ^ -(u & np.int64(1))))).bit_length() + 1
            if u.size else 1)
        if u.size and raw_bits * u.size + 5 < rice_cost:
            # escape: raw two's-complement residuals
            w.write(escape, pbits)
            w.write(raw_bits, 5)
            w.write_bits(_pack_fixed_width_bits(
                (u >> np.int64(1)) ^ -(u & np.int64(1)), raw_bits
            ))
        else:
            w.write(k, pbits)
            w.write_bits(_pack_rice_bits(u, k))


def _subframe_cost_fixed(x: np.ndarray, order: int, bits: int) -> int:
    if order > 4 or order >= x.size:
        return 1 << 60
    resid = _fixed_residual(x, order)
    u = _zigzag(resid)
    _, c = _best_rice_k(u)
    return order * bits + 6 + c


def _write_subframe(w: _BitWriter, x: np.ndarray, bits: int,
                    max_fixed_order: int, partition_order: int,
                    force: str | None):
    """One subframe: CONSTANT / best FIXED / VERBATIM by exact cost."""
    n = x.size
    if force == "verbatim":
        choice = ("verbatim", None)
    elif force == "constant":
        assert np.all(x == x[0])
        choice = ("constant", None)
    elif np.all(x == x[0]):
        choice = ("constant", None)
    else:
        costs = {
            o: _subframe_cost_fixed(x, o, bits)
            for o in range(min(max_fixed_order, 4) + 1)
        }
        o = min(costs, key=costs.get)
        choice = ("fixed", o) if costs[o] < bits * n else ("verbatim", None)
    kind, order = choice
    w.write(0, 1)  # pad
    if kind == "constant":
        w.write(0b000000, 6)
        w.write(0, 1)  # no wasted bits
        w.write(int(x[0]) & ((1 << bits) - 1), bits)
    elif kind == "verbatim":
        w.write(0b000001, 6)
        w.write(0, 1)
        w.write_bits(_pack_fixed_width_bits(x, bits))
    else:
        w.write(0b001000 | order, 6)
        w.write(0, 1)
        if order:
            w.write_bits(_pack_fixed_width_bits(x[:order], bits))
        po = partition_order
        while (1 << po) > 1 and (n % (1 << po) or n // (1 << po) <= order):
            po -= 1
        _write_residual(w, _fixed_residual(x, order), n, order, po)


_BS_FOR_BITS = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}


def encode_flac(audio, sample_rate: int, *, bits: int = 16,
                block_size: int = 4096, stereo_mode: str = "auto",
                max_fixed_order: int = 4, partition_order: int = 0,
                path: str | None = None) -> bytes:
    """Encode ``audio`` (f32 ``[ch, n]`` in [-1, 1), or integer samples
    already at ``bits`` depth) → FLAC bytes (also written to ``path``
    when given).

    ``stereo_mode``: ``auto`` | ``independent`` | ``left_side`` |
    ``right_side`` | ``mid_side`` (2-channel input only).
    """
    audio = np.asarray(audio)
    if audio.ndim == 1:
        audio = audio[None]
    ch, n = audio.shape
    assert 1 <= ch <= 8, ch
    assert bits in (8, 16, 24), f"encoder subset: 8/16/24-bit, got {bits}"
    if np.issubdtype(audio.dtype, np.floating):
        scale = float(1 << (bits - 1))
        pcm = np.clip(np.rint(audio.astype(np.float64) * scale),
                      -scale, scale - 1).astype(np.int64)
    else:
        pcm = audio.astype(np.int64)

    frames = []
    for f0 in range(0, n, block_size):
        blk = pcm[:, f0:f0 + block_size]
        frames.append(_encode_frame(
            blk, f0 // block_size, sample_rate, bits, stereo_mode,
            max_fixed_order, partition_order,
        ))
    body = b"".join(frames)

    # STREAMINFO
    si = _BitWriter()
    si.write(block_size, 16)
    si.write(block_size, 16)
    sizes = [len(f) for f in frames] or [0]
    si.write(min(sizes), 24)
    si.write(max(sizes), 24)
    si.write(int(sample_rate), 20)
    si.write(ch - 1, 3)
    si.write(bits - 1, 5)
    si.write(n, 36)
    stream_info = si.bytes() + _pcm_md5(pcm, bits)
    header = (b"fLaC" + bytes([0x80]) + len(stream_info).to_bytes(3, "big")
              + stream_info)
    out = header + body
    if path is not None:
        with open(path, "wb") as f:
            f.write(out)
    return out


def _encode_frame(blk: np.ndarray, frame_no: int, sample_rate: int,
                  bits: int, stereo_mode: str, max_fixed_order: int,
                  partition_order: int) -> bytes:
    ch, bs = blk.shape

    def chan_cost(x, extra_bit=0):
        b = bits + extra_bit
        if np.all(x == x[0]):
            return 8 + b
        return min(
            min(_subframe_cost_fixed(x, o, b)
                for o in range(min(max_fixed_order, 4) + 1)),
            b * x.size,
        )

    mode = stereo_mode
    if ch != 2:
        mode = "independent"
    elif mode == "auto":
        L, R = blk[0], blk[1]
        side = L - R
        mid = (L + R) >> np.int64(1)
        costs = {
            "independent": chan_cost(L) + chan_cost(R),
            "left_side": chan_cost(L) + chan_cost(side, 1),
            "right_side": chan_cost(side, 1) + chan_cost(R),
            "mid_side": chan_cost(mid) + chan_cost(side, 1),
        }
        mode = min(costs, key=costs.get)

    w = _BitWriter()
    w.write(0b11111111111110, 14)
    w.write(0, 1)
    w.write(0, 1)  # fixed blocking
    w.write(7, 4)  # block size: 16-bit value follows
    w.write(0, 4)  # sample rate: from STREAMINFO
    ch_code = {"independent": ch - 1, "left_side": 8, "right_side": 9,
               "mid_side": 10}[mode]
    w.write(ch_code, 4)
    w.write(_BS_FOR_BITS[bits], 3)
    w.write(0, 1)
    for b in _utf8_number(frame_no):
        w.write(b, 8)
    w.write(bs - 1, 16)
    w.align()
    hdr = bytes(w.buf)
    w.write(crc8(hdr), 8)

    force = None
    if mode == "independent":
        chans = [(blk[c], bits) for c in range(ch)]
    elif mode == "left_side":
        chans = [(blk[0], bits), (blk[0] - blk[1], bits + 1)]
    elif mode == "right_side":
        chans = [(blk[0] - blk[1], bits + 1), (blk[1], bits)]
    else:  # mid_side
        chans = [((blk[0] + blk[1]) >> np.int64(1), bits),
                 (blk[0] - blk[1], bits + 1)]
    for x, b in chans:
        _write_subframe(w, x, b, max_fixed_order, partition_order, force)
    w.align()
    w.write(crc16(bytes(w.buf)), 16)
    return w.bytes()
