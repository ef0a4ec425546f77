"""Zero-latency partitioned FFT convolution: long FIR filters (reverb IRs).

PyTorch port of the any-hop engine of ``firewheel_tpu/ops/fft_conv.py``
(``conv_partition_ir``, ``conv_state_init``, ``conv_step``), on
``torch.fft``:

* the IR's head partition ``h[:F]`` is convolved directly every call
  (overlap-save with hop n), so the output has no block latency;
* partitions ≥ 1 ride a frequency-domain delay line (FDL) that is updated
  exactly at partition boundaries; each update's F-sample tail contribution
  joins a small FIFO from which every call emits its n samples.

The spectra (``H_tail``) and the delay line (``fdl``) keep the JAX
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

__all__ = ["conv_partition_ir", "conv_state_init", "conv_step"]


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
    ir = np.atleast_2d(np.asarray(ir, np.float32))
    ch, length = ir.shape
    f = block_frames
    lp = _next_pow2(2 * f)
    p = max(1, -(-length // f))
    padded = np.zeros((ch, p * f), np.float32)
    padded[:, :length] = ir
    h_head = padded[:, :f]
    tail = padded[:, f:].reshape(ch, p - 1, f).transpose(1, 0, 2)
    H_tail = np.fft.rfft(tail, n=lp, axis=-1).astype(np.complex64)
    return h_head, np.stack([H_tail.real, H_tail.imag], axis=-1).astype(
        np.float32
    )


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
