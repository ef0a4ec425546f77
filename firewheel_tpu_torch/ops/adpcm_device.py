"""On-device IMA ADPCM (4-bit) encoding for serving egress.

PyTorch port of ``firewheel_tpu/ops/adpcm_device.py``.  IMA ADPCM at 4
bits a sample ships a quarter of pcm16's bytes, in the WAV ``wFormatTag
0x0011`` block layout every game engine decodes.

Wire format (one independently decodable IMA block per instance a chunk):
for ``No`` channels and ``S = K·F`` frames, an instance's row is
``block_align = (4 + S/2)·No`` bytes: a 4-byte header per channel (int16
LE predictor, which is sample 0, then step index 0 and a zero), then
4-byte per-channel groups of 8 nibbles, low nibble first, channels round
robin a group.  The block holds ``S + 1`` frames, the last a pad (a repeat
of the final frame, as the host encoder pads).  Decode with
:func:`decode_ima_chunk` and drop the pad.

* :func:`encode_ima_chunk_reference` — the plain version: a torch loop over
  the S samples in the order of the JAX package's scan body, on int64 (the
  port has no uint32 arithmetic on the CPU), nibbles packed after it.
* :func:`encode_ima_chunk` — the wrapper.  CPU tensors run the plain
  version; CUDA tensors launch ``csrc/adpcm.cu`` (K4, one thread per
  instance and channel, the input staged through shared memory, the
  quantizer as :func:`quantize_by_count`) or raise.  Both equal
  :func:`~firewheel_tpu_torch.utils.adpcm.encode_ima` bit for bit.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils.adpcm import IMA_STEP_TABLE
from .cuda_build import CudaLibrary

__all__ = [
    "MAX_CHANNELS",
    "chunk_block_align",
    "decode_ima_chunk",
    "encode_ima_chunk",
    "encode_ima_chunk_reference",
    "quantize_by_count",
    "LIBRARY",
]


def _bind(lib):
    fn = lib.fw_adpcm_encode
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int


#: ``csrc/adpcm.cu``, built with nvcc at first use
LIBRARY = CudaLibrary("fw_adpcm", "adpcm.cu", (), _bind)

#: channels K4 takes (``csrc/adpcm.cu:kMaxChannels``): a graph's outputs
MAX_CHANNELS = 64


def chunk_block_align(num_channels: int, frames: int) -> int:
    """Bytes per instance for a ``frames``-frame chunk (``frames`` must
    divide by 8): one IMA block of ``frames + 1`` samples a channel."""
    if frames % 8:
        raise ValueError(f"chunk frames must divide by 8, got {frames}")
    return (4 + frames // 2) * num_channels


def _check(pcm_i16: torch.Tensor):
    if not isinstance(pcm_i16, torch.Tensor) or pcm_i16.dtype != torch.int16:
        raise TypeError("encode_ima_chunk: pcm must be an int16 tensor")
    if pcm_i16.ndim != 3:
        raise ValueError(f"encode_ima_chunk: pcm must be [B, S, No], got "
                         f"{tuple(pcm_i16.shape)}")
    frames = pcm_i16.shape[1]
    if frames % 8 or frames == 0:
        raise ValueError(f"chunk frames must divide by 8, got {frames}")


def encode_ima_chunk_reference(pcm_i16: torch.Tensor) -> torch.Tensor:
    """Plain version: int16 ``[B, S, No]`` → uint8 ``[B, block_align]`` on
    the tensor's device, a loop over the S samples."""
    _check(pcm_i16)
    b, s, no = pcm_i16.shape
    x = pcm_i16.to(torch.int64)
    table = torch.as_tensor(IMA_STEP_TABLE, dtype=torch.int64, device=x.device)
    steps4 = torch.stack([table, table >> 1, table >> 2, table >> 3], dim=1)
    x0 = x[:, 0, :]
    # samples 1..S-1, then the pad frame (the last frame again)
    xs = torch.cat([x[:, 1:, :], x[:, -1:, :]], dim=1)
    pred, idx = x0, torch.zeros_like(x0)
    nibs = torch.empty((b, no, s), dtype=torch.int64, device=x.device)
    for i in range(s):
        s4 = steps4[idx]
        step, half, quarter, eighth = s4.unbind(-1)
        diff = xs[:, i, :] - pred
        neg = diff < 0
        ad = diff.abs()
        b4 = (ad >= step).to(torch.int64)
        ad = ad - b4 * step
        b2 = (ad >= half).to(torch.int64)
        ad = ad - b2 * half
        b1 = (ad >= quarter).to(torch.int64)
        mag = b4 * 4 + b2 * 2 + b1
        dq = eighth + b1 * quarter + b2 * half + b4 * step
        pred = torch.where(neg, pred - dq, pred + dq).clamp(-32768, 32767)
        idx = (idx + torch.where(mag >= 4, 2 * mag - 6, -1)).clamp(0, 88)
        nibs[:, :, i] = mag + neg.to(torch.int64) * 8
    # per channel, 4-byte groups of 8 nibbles, low nibble first; groups
    # round robin over the channels
    groups = s // 8
    nib = nibs.reshape(b, no, groups, 8)
    payload = (nib[..., 0::2] + nib[..., 1::2] * 16).movedim(1, 2).reshape(b, -1)
    x0u = x0 & 0xFFFF
    zero = torch.zeros_like(x0u)
    head = torch.stack([x0u & 0xFF, x0u >> 8, zero, zero], dim=-1).reshape(b, 4 * no)
    return torch.cat([head, payload], dim=1).to(torch.uint8)


def quantize_by_count(ad: torch.Tensor, step: torch.Tensor):
    """IMA's quantizer as K4 computes it: ``(mag, dq)`` for ``|diff| = ad``
    against ``step``.  The successive approximation's first bit is ``ad >=
    s``; its other two are the count of the thresholds ``q, h, h + q`` (``h
    = s >> 1``, ``q = s >> 2``) that the remainder ``r = ad - b4·s``
    reaches, and ``dq = (s >> 3) + b4·s`` plus the largest of them it
    reaches.  That is :func:`encode_ima_chunk_reference`'s successive
    approximation for every step of the table (the thresholds increase for
    ``s >= 7``), with the three comparisons side by side."""
    b4 = ad >= step
    r = torch.where(b4, ad - step, ad)
    q, h = step >> 2, step >> 1
    thresholds = torch.stack([q, h, h + q])
    reached = r >= thresholds
    top = torch.where(reached, thresholds, torch.zeros_like(thresholds)).amax(0)
    mag = 4 * b4.to(ad.dtype) + reached.sum(0)
    return mag, (step >> 3) + torch.where(b4, step, 0) + top


def encode_ima_chunk(pcm_i16: torch.Tensor) -> torch.Tensor:
    """Encode int16 ``[B, S, No]`` (interleaved frames, S divisible by 8) →
    uint8 ``[B, block_align]`` IMA blocks on the tensor's device.

    Bit-exact against ``utils.adpcm.encode_ima(x[b].T, block_align)`` for
    every instance ``b``.  CPU tensors run
    :func:`encode_ima_chunk_reference`; CUDA tensors launch K4 and add one
    to ``encode_ima_chunk.launches``."""
    _check(pcm_i16)
    if pcm_i16.device.type == "cpu":
        return encode_ima_chunk_reference(pcm_i16)
    if pcm_i16.device.type != "cuda":
        raise ValueError(f"encode_ima_chunk: unsupported device {pcm_i16.device}")
    b, s, no = pcm_i16.shape
    if no > MAX_CHANNELS:
        raise ValueError(f"encode_ima_chunk: K4 takes up to {MAX_CHANNELS} channels, "
                         f"got {no}")
    x = pcm_i16.contiguous()
    if x.data_ptr() % 16:  # the kernel's 16-byte copies
        x = x.clone()
    out = torch.empty((b, chunk_block_align(no, s)), dtype=torch.uint8, device=x.device)
    if b == 0 or no == 0:
        return out
    lib = LIBRARY.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fw_adpcm_encode(x.data_ptr(), out.data_ptr(), b, s, no, stream)
    if err != 0:
        raise RuntimeError(f"encode_ima_chunk: kernel launch failed (cudaError {err})")
    encode_ima_chunk.launches += 1
    return out


#: kernel launches since the counter was last set to 0
encode_ima_chunk.launches = 0


def decode_ima_chunk(rows: np.ndarray, num_channels: int, frames: int) -> np.ndarray:
    """Host-side decode of :func:`encode_ima_chunk`'s rows: uint8
    ``[B, block_align]`` → int16 ``[B, num_channels, frames]`` (the pad
    frame dropped), by the host reference decoder."""
    from ..utils.adpcm import decode_ima_blocks

    rows = np.asarray(rows, np.uint8)
    ba = chunk_block_align(num_channels, frames)
    if rows.ndim == 1:
        rows = rows[None]
    if rows.shape[1] != ba:
        raise ValueError(f"rows of {rows.shape[1]} bytes, expected {ba}")
    out = np.empty((rows.shape[0], num_channels, frames), np.int16)
    for b in range(rows.shape[0]):
        out[b] = decode_ima_blocks(rows[b].tobytes(), num_channels, ba)[:, :frames]
    return out
