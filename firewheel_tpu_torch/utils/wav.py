"""Minimal WAV read/write supporting 16-bit PCM and 32-bit IEEE float,
plus a seekable windowed reader for disk streaming."""

from __future__ import annotations

import os
import struct

import numpy as np

__all__ = ["write_wav", "read_wav", "WavStreamReader"]


def write_wav(path: str, audio: np.ndarray, sample_rate: int, dtype: str = "f32"):
    """Write ``audio`` (``[channels, frames]`` or ``[frames]``) to a WAV file.

    ``dtype``: ``"f32"`` (IEEE float, format 3), ``"i16"`` (PCM),
    ``"ima"`` (IMA/DVI ADPCM, format 0x11) or ``"ms"`` (MS ADPCM, format
    2) — the 4:1 compressed flavors shipped with game assets.
    """
    audio = np.atleast_2d(np.asarray(audio, np.float32))
    ch, frames = audio.shape
    interleaved = audio.T.reshape(-1)

    extra = b""
    fact_frames = None
    if dtype == "f32":
        fmt_code, bits = 3, 32
        payload = interleaved.astype("<f4").tobytes()
        byte_rate = sample_rate * ch * bits // 8
        block_align = ch * bits // 8
    elif dtype == "i16":
        fmt_code, bits = 1, 16
        clipped = np.clip(interleaved, -1.0, 1.0)
        payload = (clipped * 32767.0).astype("<i2").tobytes()
        byte_rate = sample_rate * ch * bits // 8
        block_align = ch * bits // 8
    elif dtype in ("ima", "ms"):
        from . import adpcm as _adpcm

        i16 = (np.clip(audio, -1.0, 1.0) * 32767.0).astype(np.int16)
        block_align = 1024 * ch
        if dtype == "ima":
            fmt_code, bits = 0x11, 4
            payload, fact_frames = _adpcm.encode_ima(i16, block_align)
            spb = _adpcm.ima_samples_per_block(block_align, ch)
        else:
            fmt_code, bits = 0x02, 4
            payload, fact_frames = _adpcm.encode_ms(i16, block_align)
            spb = _adpcm.ms_samples_per_block(block_align, ch)
        byte_rate = int(
            round(sample_rate / spb * block_align)
        )  # nominal, per spec
        if dtype == "ms":
            # cbSize=32: wSamplesPerBlock + wNumCoef + 7 coefficient pairs
            coefs = b"".join(
                struct.pack("<hh", int(a), int(b))
                for a, b in _adpcm.MS_COEFFS
            )
            extra = struct.pack("<HHH", 32, spb, 7) + coefs
        else:
            extra = struct.pack("<HH", 2, spb)  # cbSize=2
    else:
        raise ValueError(f"unsupported dtype {dtype}")

    fmt_body = struct.pack(
        "<HHIIHH", fmt_code, ch, sample_rate, byte_rate, block_align, bits
    ) + extra
    fact = (
        b"fact" + struct.pack("<II", 4, fact_frames)
        if fact_frames is not None
        else b""
    )
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack(
            "<I", 4 + 8 + len(fmt_body) + len(fact) + 8 + len(payload)
        ))
        f.write(b"WAVEfmt ")
        f.write(struct.pack("<I", len(fmt_body)))
        f.write(fmt_body)
        f.write(fact)
        f.write(b"data")
        f.write(struct.pack("<I", len(payload)))
        f.write(payload)


def read_wav(path: str):
    """Read a WAV file → ``(audio [channels, frames] f32, sample_rate)``.

    Formats: 16-bit PCM (1), IEEE float32 (3), MS ADPCM (2) and IMA/DVI
    ADPCM (0x11) — the compressed flavors game WAV assets actually ship
    (reference DESIGN_DOC.md:32-33 planned Symphonia for these)."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:4] == b"RIFF" and data[8:12] == b"WAVE", "not a WAV file"
    pos = 12
    fmt = None
    payload = None
    fact_frames = None
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        size = struct.unpack("<I", data[pos + 4 : pos + 8])[0]
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            payload = body
        elif cid == b"fact" and size >= 4:
            fact_frames = struct.unpack("<I", body[:4])[0]
        pos += 8 + size + (size & 1)
    assert fmt is not None and payload is not None
    fmt_code, ch, sample_rate, _, block_align, bits = fmt
    if fmt_code == 3 and bits == 32:
        x = np.frombuffer(payload, "<f4").astype(np.float32)
    elif fmt_code == 1 and bits == 16:
        x = np.frombuffer(payload, "<i2").astype(np.float32) / 32767.0
    elif fmt_code in (0x11, 0x02):
        from .adpcm import decode_ima_blocks, decode_ms_blocks

        dec = (decode_ima_blocks if fmt_code == 0x11 else decode_ms_blocks)(
            payload, ch, block_align
        )
        audio = dec.astype(np.float32) / 32767.0
        if fact_frames is not None:
            audio = audio[:, :fact_frames]
        return audio, sample_rate
    else:
        raise ValueError(f"unsupported wav format {fmt_code}/{bits}")
    frames = len(x) // ch
    return x[: frames * ch].reshape(frames, ch).T.copy(), sample_rate


class WavStreamReader:
    """Windowed WAV access without loading the file: parses the header once
    and memory-maps the data chunk, so ``read(start, n)`` touches only the
    pages it needs.  Satisfies the stream-reader protocol used by
    :class:`~firewheel_tpu.nodes.streaming_sampler.StreamingSamplerNode`
    (``num_channels``, ``len_frames``, ``sample_rate``, ``read``)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            head = f.read(12)
            assert head[:4] == b"RIFF" and head[8:12] == b"WAVE", "not a WAV"
            fmt = None
            data_off = data_size = None
            fact_frames = None
            pos = 12
            while True:
                hdr = f.read(8)
                if len(hdr) < 8:
                    break
                cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
                if cid == b"fmt ":
                    fmt = struct.unpack("<HHIIHH", f.read(16))
                    f.seek(size - 16, 1)
                elif cid == b"data":
                    data_off, data_size = f.tell(), size
                    f.seek(size + (size & 1), 1)
                elif cid == b"fact" and size >= 4:
                    fact_frames = struct.unpack("<I", f.read(4))[0]
                    f.seek(size - 4 + (size & 1), 1)
                else:
                    f.seek(size + (size & 1), 1)
        assert fmt is not None and data_off is not None, "malformed WAV"
        fmt_code, ch, sr, _, block_align, bits = fmt
        self._adpcm = None
        self.num_channels = ch
        self.sample_rate = sr
        if fmt_code == 3 and bits == 32:
            dtype, self._scale = "<f4", None
        elif fmt_code == 1 and bits == 16:
            dtype, self._scale = "<i2", np.float32(1.0 / 32767.0)
        elif fmt_code in (0x11, 0x02):
            # compressed path: memory-map the raw blocks; read() decodes
            # only the blocks covering the requested window (each block
            # restarts its predictor, so random access is exact)
            from . import adpcm as _adpcm

            data_size = min(data_size, os.path.getsize(path) - data_off)
            n_blocks = data_size // block_align
            rem = data_size % block_align
            if fmt_code == 0x11:
                spb = _adpcm.ima_samples_per_block(block_align, ch)
                self._decode = _adpcm.decode_ima_blocks
                hdr = 4 * ch
                tail = (
                    1 + (rem - hdr) // (4 * ch) * 8 if rem >= hdr else 0
                )
            else:
                spb = _adpcm.ms_samples_per_block(block_align, ch)
                self._decode = _adpcm.decode_ms_blocks
                hdr = 7 * ch
                tail = 2 + (rem - hdr) * 2 // ch if rem >= hdr else 0
            self._adpcm = (block_align, spb)
            # a truncated final block (RIFF allows it) still counts the
            # frames its bytes hold; the decoders pad + trim it exactly
            self.len_frames = n_blocks * spb + tail
            if fact_frames is not None:
                self.len_frames = min(self.len_frames, fact_frames)
            self._mm = np.memmap(
                path,
                dtype=np.uint8,
                mode="r",
                offset=data_off,
                shape=(n_blocks * block_align + (rem if tail else 0),),
            )
            return
        else:
            raise ValueError(f"unsupported wav format {fmt_code}/{bits}")
        self.len_frames = data_size // (ch * bits // 8)
        self._mm = np.memmap(
            path,
            dtype=dtype,
            mode="r",
            offset=data_off,
            shape=(self.len_frames, ch),
        )

    def read(self, start_frame: int, num_frames: int) -> np.ndarray:
        """``f32[channels, n]``; reads outside [0, len_frames) zero-pad —
        pre-roll (negative start) yields leading zeros at the correct
        positions, not time-shifted audio."""
        start_frame = int(start_frame)
        start = max(0, start_frame)
        lead = start - start_frame  # zeros before frame 0
        end = min(start_frame + num_frames, self.len_frames)
        out = np.zeros((self.num_channels, num_frames), np.float32)
        if end > start:
            if self._adpcm is not None:
                block_align, spb = self._adpcm
                b0 = start // spb
                b1 = -(-end // spb)
                raw = self._mm[b0 * block_align : b1 * block_align]
                dec = self._decode(raw, self.num_channels, block_align)
                chunk = (
                    dec[:, start - b0 * spb : end - b0 * spb].astype(
                        np.float32
                    )
                    / 32767.0
                )
            else:
                chunk = np.asarray(self._mm[start:end]).T
                if self._scale is not None:
                    chunk = chunk.astype(np.float32) * self._scale
            out[:, lead : lead + (end - start)] = chunk
        return out

    def close(self):
        """Release the memory-map (reads after close raise)."""
        mm = getattr(self, "_mm", None)
        if mm is not None:
            # np.memmap frees the map when the last reference dies
            self._mm = None
