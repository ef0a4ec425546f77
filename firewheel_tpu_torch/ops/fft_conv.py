"""Partitioned FFT convolution: long FIR filters (reverb IRs).

PyTorch port of ``firewheel_tpu/ops/fft_conv.py``, on ``torch.fft``.  Two
engines:

* the fixed-hop frequency-domain delay line (``partition_ir``,
  ``fdl_init``, ``fdl_step``): uniformly partitioned overlap-save, the
  hop fixed at the partition size;
* the zero-latency any-hop engine (``conv_partition_ir``,
  ``conv_state_init``, ``conv_step``) that the reverb runs.  The IR's head
  partition ``h[:F]`` is convolved directly every call (overlap-save with
  hop n), so the output has no block latency; partitions ≥ 1 ride a
  frequency-domain delay line (FDL) that is updated exactly at partition
  boundaries; each update's F-sample tail contribution joins a small FIFO
  from which every call emits its n samples.

The spectra (``H``, ``H_tail``) and the delay lines (``fdl``) keep the JAX
package's layout in the param and state trees, float32 real/imag pairs
``[..., 2]``, so state and params convert between the packages as plain
copies; the complex math views them with ``torch.view_as_complex``.

Every tensor may carry leading batch dimensions.  The partition fill
(``fill``, ``tfill``) is per instance, so the JAX package's ``lax.cond``
on a completed partition becomes both branches and a per-instance select;
a full hop (n == F, what ``BatchRenderer`` renders) always completes one
and takes the boundary branch alone, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "partition_ir", "fdl_init", "fdl_step",
    "conv_partition_ir", "conv_state_init", "conv_step",
]


def _partitions(ir, block_frames: int) -> np.ndarray:
    """An IR ``f32[ch, L]`` (or ``[L]``) cut into block-sized partitions,
    the last zero-padded: ``f32[P, ch, F]``."""
    ir = np.atleast_2d(np.asarray(ir, np.float32))
    ch, length = ir.shape
    p = max(1, -(-length // block_frames))
    padded = np.zeros((ch, p * block_frames), np.float32)
    padded[:, :length] = ir
    return padded.reshape(ch, p, block_frames).transpose(1, 0, 2)


def _spectra(parts: np.ndarray, n: int) -> np.ndarray:
    """The n-point spectra of ``parts`` as float32 real/imag pairs."""
    H = np.fft.rfft(parts, n=n, axis=-1).astype(np.complex64)
    return np.stack([H.real, H.imag], axis=-1).astype(np.float32)


def partition_ir(ir, block_frames: int) -> np.ndarray:
    """Transform an impulse response for :func:`fdl_step` (host-side
    numpy, once per IR).

    ``ir``: ``f32[ch, L]`` (or ``[L]``).  Returns ``H f32[P, ch, F+1, 2]``:
    each partition zero-padded to 2F (a linear, not circular, convolution)
    and transformed."""
    return _spectra(_partitions(ir, block_frames), 2 * block_frames)


def fdl_init(num_partitions: int, channels: int, block_frames: int):
    """Fresh state for :func:`fdl_step`: the delay line ``f32[P, ch, F+1,
    2]`` (real/imag pairs) and the overlap-save input tail ``f32[ch, F]``."""
    return (
        torch.zeros((num_partitions, channels, block_frames + 1, 2),
                    dtype=torch.float32),
        torch.zeros((channels, block_frames), dtype=torch.float32),
    )


def fdl_step(x: torch.Tensor, state, H):
    """Convolve one block; the hop equals the partition size F (use
    :func:`conv_step` for any hop).

    ``x``: ``f32[..., ch, F]``; ``state``: ``(fdl f32[..., P, ch, F+1, 2],
    x_prev f32[..., ch, F])`` from :func:`fdl_init`; ``H``: from
    :func:`partition_ir`, ``f32[..., P, irch, F+1, 2]`` with irch 1 (one IR
    for every channel) or ch, a tensor or a numpy array.  Returns ``(y
    f32[..., ch, F], new_state)``."""
    fdl_ri, x_prev = state
    f = x.shape[-1]
    X = torch.fft.rfft(torch.cat([x_prev, x], dim=-1), dim=-1)  # [..., ch, F+1]
    # the newest spectrum at partition 0, aligned with the IR's first
    fdl = torch.view_as_complex(fdl_ri.contiguous())
    fdl = torch.cat([X.unsqueeze(-3), fdl[..., :-1, :, :]], dim=-3)
    H = torch.view_as_complex(torch.as_tensor(H, device=x.device).contiguous())
    y = torch.fft.irfft((H * fdl).sum(dim=-3), n=2 * f, dim=-1)[..., f:]
    return y, (torch.view_as_real(fdl), x)


def _next_pow2(v: int) -> int:
    p = 1
    while p < v:
        p <<= 1
    return p


def conv_partition_ir(ir, block_frames: int):
    """Split an IR for the zero-latency engine (host-side numpy, once per
    IR).

    ``ir``: ``f32[ch, L]`` (or ``[L]``).  Returns ``(h_head f32[ch, F],
    H_tail f32[P-1, ch, LP//2+1, 2])`` with ``LP = next_pow2(2F)``: the head
    partition in the time domain, later partitions as LP-point spectra in
    real/imag pairs.
    """
    parts = _partitions(ir, block_frames)
    return parts[0], _spectra(parts[1:], _next_pow2(2 * block_frames))


def conv_state_init(num_partitions: int, channels: int, block_frames: int):
    """Fresh state for :func:`conv_step`."""
    f = block_frames
    lp = _next_pow2(2 * f)
    return {
        "hist": torch.zeros((channels, lp), dtype=torch.float32),
        "fill": torch.zeros((), dtype=torch.int32),
        "fdl": torch.zeros(
            (max(num_partitions - 1, 0), channels, lp // 2 + 1, 2),
            dtype=torch.float32,
        ),
        "tailbuf": torch.zeros((channels, 2 * f), dtype=torch.float32),
        "tfill": torch.full((), f, dtype=torch.int32),
    }


def _window(t: torch.Tensor, start: torch.Tensor, width: int) -> torch.Tensor:
    """``t[..., start:start+width]`` with a per-instance ``start [...]``."""
    idx = start.to(torch.int64)[..., None, None] + torch.arange(
        width, device=t.device)
    return torch.gather(t, -1, idx.expand(*t.shape[:-1], width))


def conv_step(x, state, h_head, H_tail):
    """Convolve ``n`` samples (any ``n <= F``) with zero latency.

    ``x``: ``f32[..., ch, n]``; ``state``: from :func:`conv_state_init`;
    ``h_head``: ``f32[..., irch, F]``; ``H_tail``: ``f32[..., P-1, irch,
    LP//2+1, 2]`` (irch 1 or ch).  Returns ``(y f32[..., ch, n],
    new_state)``.
    """
    *lead, ch, n = x.shape
    f = h_head.shape[-1]
    lp = state["hist"].shape[-1]  # partition FFT size, >= 2F, power of two
    assert n <= f, f"hop {n} exceeds partition size {f}"
    rfft, irfft = torch.fft.rfft, torch.fft.irfft

    concat = torch.cat([state["hist"], x], dim=-1)  # [..., ch, LP+n]

    # head partition: overlap-save with hop n, filter length F
    L = _next_pow2(f + n)
    y_dir = rfft(concat[..., -L:], dim=-1) * rfft(h_head, n=L, dim=-1)
    y = irfft(y_dir, n=L, dim=-1)[..., -n:]

    fill = state["fill"]
    tailbuf, tfill = state["tailbuf"], state["tfill"]
    fdl_ri = state["fdl"]
    if fdl_ri.shape[-4] > 0:
        fdl = torch.view_as_complex(fdl_ri.contiguous())  # [..., P-1, ch, bins]
        completed = fill + n >= f
        rem = torch.where(completed, fill + n - f, torch.zeros_like(fill))
        # the completed partition ends `rem` samples before the end of x:
        # the LP-sample overlap-save window ending there
        X = rfft(_window(concat, (n - rem).clamp(0, n), lp), dim=-1)
        fdl_b = torch.cat([X.unsqueeze(-3), fdl[..., :-1, :, :]], dim=-3)
        H = torch.view_as_complex(H_tail.contiguous())
        contrib = irfft((H * fdl_b).sum(dim=-3), n=lp, dim=-1)[..., -f:]
        at = tfill.clamp(0, f).to(torch.int64)[..., None, None] + torch.arange(
            f, device=x.device)
        tail_b = tailbuf.scatter(-1, at.expand(*lead, ch, f), contrib)
        if n == f:
            # a full hop always completes a partition
            fdl, tailbuf, tfill = fdl_b, tail_b, tfill + f
        else:
            c = completed[..., None, None]
            fdl = torch.where(c[..., None], fdl_b, fdl)
            tailbuf = torch.where(c, tail_b, tailbuf)
            tfill = torch.where(completed, tfill + f, tfill)
        fdl_ri = torch.view_as_real(fdl)

    y = y + tailbuf[..., :n]
    tailbuf = torch.cat([tailbuf[..., n:], torch.zeros_like(tailbuf[..., :n])],
                        dim=-1)
    new_state = {
        "hist": concat[..., n:],
        "fill": torch.where(fill + n >= f, fill + n - f, fill + n).to(torch.int32),
        "fdl": fdl_ri,
        "tailbuf": tailbuf,
        "tfill": (tfill - n).to(torch.int32),
    }
    return y, new_state
