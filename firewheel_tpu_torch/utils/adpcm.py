"""IMA (DVI) and Microsoft ADPCM codecs, vectorized across blocks.

Reference scope: "Support for loading a wide variety of audio formats"
(the reference's ``DESIGN_DOC.md:32-33`` — Symphonia decodes the ADPCM WAV
flavors game assets actually ship).  Both codecs are block-based: every
block restarts the predictor from its header, so blocks decode
independently — the NumPy implementation loops over the ~500 samples
*within* a block while decoding **all blocks of the file in parallel**
(and it is exact: ADPCM is integer arithmetic, reproduced with int32
intermediates and int16 clamps, not floats).

Layouts (Microsoft "Multimedia Programming Interface and Data
Specifications 1.0" / RIFF registry):

- **IMA ADPCM** (``wFormatTag 0x0011``): per block and channel a 4-byte
  header ``{int16 predictor, uint8 step_index, uint8 reserved}`` — the
  predictor IS the block's first output sample — then the payload in
  4-byte per-channel groups (8 nibbles, LOW nibble first), channels
  round-robin per group.
- **MS ADPCM** (``wFormatTag 0x0002``): per block and channel
  ``{uint8 coeff_idx}``, then ``{int16 idelta}``, ``{int16 sample1}``,
  ``{int16 sample2}`` (7 bytes/channel total); ``sample2`` then
  ``sample1`` are the block's first two output samples.  Payload nibbles
  come HIGH nibble first, channels round-robin per nibble.

Encoders are included so tests can round-trip and tools can write
game-sized assets (4:1 over 16-bit PCM).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "decode_ima_blocks",
    "decode_ms_blocks",
    "encode_ima",
    "encode_ms",
    "ima_samples_per_block",
    "ms_samples_per_block",
]

# -- IMA tables (IMA ADPCM Reference Algorithm, 1992) -------------------------

IMA_STEP_TABLE = np.array([
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34, 37,
    41, 45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143, 157, 173,
    190, 209, 230, 253, 279, 307, 337, 371, 408, 449, 494, 544, 598, 658,
    724, 796, 876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066,
    2272, 2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358, 5894,
    6484, 7132, 7845, 8630, 9493, 10442, 11487, 12635, 13899, 15289,
    16818, 18500, 20350, 22385, 24623, 27086, 29794, 32767,
], np.int32)

IMA_INDEX_TABLE = np.array([-1, -1, -1, -1, 2, 4, 6, 8], np.int32)

# -- MS ADPCM tables -----------------------------------------------------------

MS_COEFFS = np.array([
    [256, 0], [512, -256], [0, 0], [192, 64],
    [240, 0], [460, -208], [392, -232],
], np.int32)

MS_ADAPT = np.array([
    230, 230, 230, 230, 307, 409, 512, 614,
    768, 614, 512, 409, 307, 230, 230, 230,
], np.int32)


def ima_samples_per_block(block_align: int, channels: int) -> int:
    return 1 + (block_align - 4 * channels) // (4 * channels) * 8


def ms_samples_per_block(block_align: int, channels: int) -> int:
    return 2 + (block_align - 7 * channels) * 2 // channels


# -- vectorized cores ----------------------------------------------------------

def _ima_core(nibbles: np.ndarray, pred0: np.ndarray, idx0: np.ndarray):
    """Decode IMA nibbles ``[B, S]`` given per-block initial predictor /
    step index ``[B]`` → int16 samples ``[B, S]`` (all int math)."""
    B, S = nibbles.shape
    out = np.empty((B, S), np.int16)
    pred = pred0.astype(np.int32)
    idx = np.clip(idx0.astype(np.int32), 0, 88)
    for s in range(S):
        n = nibbles[:, s].astype(np.int32)
        step = IMA_STEP_TABLE[idx]
        diff = step >> 3
        diff += np.where(n & 1, step >> 2, 0)
        diff += np.where(n & 2, step >> 1, 0)
        diff += np.where(n & 4, step, 0)
        pred = np.clip(
            np.where(n & 8, pred - diff, pred + diff), -32768, 32767
        )
        idx = np.clip(idx + IMA_INDEX_TABLE[n & 7], 0, 88)
        out[:, s] = pred
    return out


def _div256(q: np.ndarray) -> np.ndarray:
    """``q / 256`` truncating toward zero — the MS spec's C integer
    division.  ``>> 8`` would floor, yielding a predictor 1 low whenever
    the weighted history is negative and not a multiple of 256."""
    return np.where(q >= 0, q >> 8, -((-q) >> 8))


def _ms_core(nibbles, coef1, coef2, delta0, s1_0, s2_0):
    """Decode MS nibbles ``[B, S]`` given per-block coeffs / initial
    delta / history ``[B]`` → int16 samples ``[B, S]``."""
    B, S = nibbles.shape
    out = np.empty((B, S), np.int16)
    delta = delta0.astype(np.int64)
    s1 = s1_0.astype(np.int64)
    s2 = s2_0.astype(np.int64)
    c1 = coef1.astype(np.int64)
    c2 = coef2.astype(np.int64)
    for s in range(S):
        n = nibbles[:, s].astype(np.int64)
        signed = np.where(n >= 8, n - 16, n)
        pred = _div256(s1 * c1 + s2 * c2)
        sample = np.clip(pred + signed * delta, -32768, 32767)
        out[:, s] = sample
        s2, s1 = s1, sample
        delta = np.maximum((MS_ADAPT[n] * delta) >> 8, 16)
    return out


# -- WAV block-layout decoders ---------------------------------------------------

def _pad_tail(raw, block_align, header_bytes, frames_of_data_bytes):
    """Zero-pad a truncated final block to ``block_align`` and return
    ``(raw, tail_frames)`` — how many frames that partial block really
    holds (0 when the payload is whole blocks, or the tail is shorter
    than its header and is dropped)."""
    rem = raw.size % block_align
    if not rem:
        return raw, 0
    if rem < header_bytes:
        return raw[: raw.size - rem], 0
    tail_frames = frames_of_data_bytes(rem - header_bytes)
    pad = np.zeros(block_align - rem, np.uint8)
    return np.concatenate([raw, pad]), tail_frames

def decode_ima_blocks(
    payload: bytes | np.ndarray, channels: int, block_align: int
) -> np.ndarray:
    """Decode IMA-ADPCM blocks → int16 ``[channels, frames]``.

    A short final block (RIFF allows a truncated tail; the ``fact`` chunk
    gives the true frame count) decodes to exactly the frames its bytes
    hold — ``1 + whole-4·ch-byte-groups × 8``."""
    raw = np.frombuffer(bytes(payload), np.uint8)
    raw, tail_frames = _pad_tail(raw, block_align, 4 * channels,
                                 lambda b: 1 + b // (4 * channels) * 8)
    n_blocks = raw.size // block_align
    if n_blocks == 0:
        return np.zeros((channels, 0), np.int16)
    spb = ima_samples_per_block(block_align, channels)
    blocks = raw.reshape(n_blocks, block_align)

    head = blocks[:, : 4 * channels].reshape(n_blocks, channels, 4)
    pred0 = (
        head[:, :, 0].astype(np.int16).astype(np.int32)
        | (head[:, :, 1].astype(np.int8).astype(np.int32) << 8)
    )
    idx0 = head[:, :, 2].astype(np.int32)

    # payload: [groups, channels, 4 bytes] → per-channel nibble streams
    data = blocks[:, 4 * channels :].reshape(n_blocks, -1, channels, 4)
    lo = data & 0x0F
    hi = data >> 4
    # each 4-byte group is 8 samples, LOW nibble first
    nib = np.stack([lo, hi], axis=-1).reshape(
        n_blocks, data.shape[1], channels, 8
    )
    # [B, channels, samples-1]
    nib = nib.transpose(0, 2, 1, 3).reshape(n_blocks, channels, -1)

    out = np.empty((n_blocks, channels, spb), np.int16)
    out[:, :, 0] = pred0.astype(np.int16)
    dec = _ima_core(
        nib.reshape(n_blocks * channels, -1),
        pred0.reshape(-1),
        idx0.reshape(-1),
    )
    out[:, :, 1:] = dec.reshape(n_blocks, channels, -1)
    # [channels, total_frames]
    full = out.transpose(1, 0, 2).reshape(channels, n_blocks * spb)
    if tail_frames:
        full = full[:, : (n_blocks - 1) * spb + tail_frames]
    return full


def decode_ms_blocks(
    payload: bytes | np.ndarray, channels: int, block_align: int
) -> np.ndarray:
    """Decode MS-ADPCM blocks → int16 ``[channels, frames]``; a short
    final block decodes to ``2 + data-bytes × 2 / ch`` frames."""
    raw = np.frombuffer(bytes(payload), np.uint8)
    raw, tail_frames = _pad_tail(raw, block_align, 7 * channels,
                                 lambda b: 2 + b * 2 // channels)
    n_blocks = raw.size // block_align
    if n_blocks == 0:
        return np.zeros((channels, 0), np.int16)
    spb = ms_samples_per_block(block_align, channels)
    blocks = raw.reshape(n_blocks, block_align)
    ch = channels

    bpred = blocks[:, :ch].astype(np.int32)  # [B, ch]
    if (bpred >= len(MS_COEFFS)).any():
        raise ValueError("MS ADPCM block has coefficient index > 6")

    def i16(field):  # [B, ch] little-endian int16 at byte offset
        lo = blocks[:, field : field + 2 * ch : 2].astype(np.int32)
        hi = blocks[:, field + 1 : field + 2 * ch : 2].astype(np.int8)
        return lo | (hi.astype(np.int32) << 8)

    delta0 = i16(ch)
    s1_0 = i16(3 * ch)
    s2_0 = i16(5 * ch)

    data = blocks[:, 7 * ch :]
    hi = data >> 4
    lo = data & 0x0F
    # HIGH nibble first, channels round-robin per nibble
    nib = np.stack([hi, lo], axis=-1).reshape(n_blocks, -1)
    per_ch = (spb - 2) * ch
    nib = nib[:, :per_ch].reshape(n_blocks, -1, ch)  # [B, samples-2, ch]
    nib = nib.transpose(0, 2, 1)  # [B, ch, samples-2]

    coef1 = MS_COEFFS[bpred, 0]
    coef2 = MS_COEFFS[bpred, 1]
    dec = _ms_core(
        nib.reshape(n_blocks * ch, -1),
        coef1.reshape(-1),
        coef2.reshape(-1),
        delta0.reshape(-1),
        s1_0.reshape(-1),
        s2_0.reshape(-1),
    ).reshape(n_blocks, ch, -1)

    out = np.empty((n_blocks, ch, spb), np.int16)
    out[:, :, 0] = s2_0.astype(np.int16)
    out[:, :, 1] = s1_0.astype(np.int16)
    out[:, :, 2:] = dec
    full = out.transpose(1, 0, 2).reshape(ch, n_blocks * spb)
    if tail_frames:
        full = full[:, : (n_blocks - 1) * spb + tail_frames]
    return full


# -- encoders -------------------------------------------------------------------

def encode_ima(
    audio_i16: np.ndarray, block_align: int = 1024
) -> tuple[bytes, int]:
    """Encode int16 ``[channels, frames]`` → (IMA payload, frames_encoded).
    Frames pad with the last sample to whole blocks."""
    audio_i16 = np.atleast_2d(np.asarray(audio_i16, np.int16))
    ch, frames = audio_i16.shape
    spb = ima_samples_per_block(block_align, ch)
    n_blocks = -(-frames // spb)
    total = n_blocks * spb
    if total > frames:
        pad = np.repeat(audio_i16[:, -1:], total - frames, axis=1)
        audio_i16 = np.concatenate([audio_i16, pad], axis=1)

    x = audio_i16.reshape(ch, n_blocks, spb).transpose(1, 0, 2)  # [B,ch,spb]
    pred = x[:, :, 0].astype(np.int32)
    idx = np.zeros((n_blocks, ch), np.int32)
    nibbles = np.empty((n_blocks, ch, spb - 1), np.uint8)
    for s in range(1, spb):
        step = IMA_STEP_TABLE[idx]
        diff = x[:, :, s].astype(np.int32) - pred
        n = np.where(diff < 0, 8, 0)
        ad = np.abs(diff)
        b4 = (ad >= step).astype(np.int32)
        ad -= b4 * step
        b2 = (ad >= step >> 1).astype(np.int32)
        ad -= b2 * (step >> 1)
        b1 = (ad >= step >> 2).astype(np.int32)
        n = n | (b4 << 2) | (b2 << 1) | b1
        # decoder-mirrored reconstruction
        dq = step >> 3
        dq += np.where(n & 1, step >> 2, 0)
        dq += np.where(n & 2, step >> 1, 0)
        dq += np.where(n & 4, step, 0)
        pred = np.clip(
            np.where(n & 8, pred - dq, pred + dq), -32768, 32767
        )
        idx = np.clip(idx + IMA_INDEX_TABLE[n & 7], 0, 88)
        nibbles[:, :, s - 1] = n.astype(np.uint8)

    # pack: header then 4-byte groups (8 nibbles, low first) per channel
    x0 = x[:, :, 0].astype(np.int16)
    head = np.zeros((n_blocks, ch, 4), np.uint8)
    head[:, :, 0] = (x0.view(np.uint16) & 0xFF).astype(np.uint8)
    head[:, :, 1] = (x0.view(np.uint16) >> 8).astype(np.uint8)
    # header index = the STARTING index of the data section (0 here:
    # encoding restarts each block from index 0)
    groups = (spb - 1) // 8
    nib = nibbles.reshape(n_blocks, ch, groups, 8)
    lo = nib[..., 0::2]
    hi = nib[..., 1::2]
    packed = (lo | (hi << 4)).reshape(n_blocks, ch, groups, 4)
    packed = packed.transpose(0, 2, 1, 3).reshape(n_blocks, -1)
    blocks = np.concatenate([head.reshape(n_blocks, -1), packed], axis=1)
    assert blocks.shape[1] == block_align, (blocks.shape, block_align)
    return blocks.tobytes(), frames


def encode_ms(
    audio_i16: np.ndarray, block_align: int = 1024
) -> tuple[bytes, int]:
    """Encode int16 ``[channels, frames]`` → (MS-ADPCM payload, frames).
    Uses coefficient pair 0 (pure first-order predictor) with the
    standard delta bootstrap — a valid, decently-predicting stream any
    spec decoder reproduces exactly."""
    audio_i16 = np.atleast_2d(np.asarray(audio_i16, np.int16))
    ch, frames = audio_i16.shape
    spb = ms_samples_per_block(block_align, ch)
    n_blocks = -(-frames // spb)
    total = n_blocks * spb
    if total > frames:
        pad = np.repeat(audio_i16[:, -1:], total - frames, axis=1)
        audio_i16 = np.concatenate([audio_i16, pad], axis=1)

    x = audio_i16.reshape(ch, n_blocks, spb).transpose(1, 0, 2)
    c1 = np.full((n_blocks, ch), MS_COEFFS[0, 0], np.int64)
    c2 = np.full((n_blocks, ch), MS_COEFFS[0, 1], np.int64)
    s2 = x[:, :, 0].astype(np.int64)
    s1 = x[:, :, 1].astype(np.int64)
    delta = np.maximum(
        np.abs(x[:, :, 1].astype(np.int64) - x[:, :, 0]) // 4, 16
    )
    delta0 = delta.copy()
    nibbles = np.empty((n_blocks, ch, spb - 2), np.uint8)
    for s in range(2, spb):
        predv = _div256(s1 * c1 + s2 * c2)
        err = x[:, :, s].astype(np.int64) - predv
        n = np.clip((err + (np.where(err < 0, -delta, delta) >> 1))
                    // np.maximum(delta, 1), -8, 7)
        sample = np.clip(predv + n * delta, -32768, 32767)
        nib = (n & 0x0F).astype(np.uint8)
        nibbles[:, :, s - 2] = nib
        s2, s1 = s1, sample
        delta = np.maximum((MS_ADAPT[nib] * delta) >> 8, 16)

    blocks = np.zeros((n_blocks, block_align), np.uint8)
    blocks[:, :ch] = 0  # coeff pair 0

    def put16(off, vals):
        u = vals.astype(np.int16).view(np.uint16)
        blocks[:, off : off + 2 * ch : 2] = (u & 0xFF).astype(np.uint8)
        blocks[:, off + 1 : off + 2 * ch : 2] = (u >> 8).astype(np.uint8)

    put16(ch, delta0.astype(np.int16))
    put16(3 * ch, x[:, :, 1].astype(np.int16))
    put16(5 * ch, x[:, :, 0].astype(np.int16))
    # interleave channels per nibble, HIGH first
    nib = nibbles.transpose(0, 2, 1).reshape(n_blocks, -1)
    hi = nib[:, 0::2]
    lo = nib[:, 1::2]
    blocks[:, 7 * ch :] = (lo | (hi << 4)).astype(np.uint8)
    return blocks.tobytes(), frames
