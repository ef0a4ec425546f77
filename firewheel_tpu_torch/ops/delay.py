"""Delay-line primitives: pure delays and block-feedback combs.

PyTorch port of ``firewheel_tpu/ops/delay.py``.  A delay line is a state
tensor shifted by one block every block (concatenate and slice), oldest
sample first, in the JAX package's layout.
"""

from __future__ import annotations

import torch

__all__ = ["delay_init", "delay_step", "comb_init", "comb_step"]


def delay_init(channels: int, delay_frames: int) -> torch.Tensor:
    """Zero history for a pure delay of ``delay_frames``."""
    return torch.zeros((channels, max(delay_frames, 0)), dtype=torch.float32)


def delay_step(x: torch.Tensor, buf: torch.Tensor):
    """Delay by ``buf.shape[-1]`` frames: ``y[n] = x[n-D]``, for any D ≥ 0
    and any block size.  Returns ``(y, new_buf)``."""
    if buf.shape[-1] == 0:
        return x, buf
    combined = torch.cat([buf, x], dim=-1)  # [..., D+F]
    f = x.shape[-1]
    return combined[..., :f], combined[..., f:]


def comb_init(channels: int, delay_frames: int) -> torch.Tensor:
    """Zero history for a feedback comb of ``delay_frames`` (must be ≥ the
    block size — in-block feedback would need a sequential recurrence)."""
    return torch.zeros((channels, delay_frames), dtype=torch.float32)


def comb_step(x: torch.Tensor, buf: torch.Tensor, feedback):
    """Feedback comb ``y[n] = x[n] + g·y[n-D]`` with D ≥ block size.

    ``buf`` holds the last D output samples; ``feedback`` is a number or a
    tensor that broadcasts against ``x``, rounded to float32 as the JAX
    package rounds it.  Returns ``(y, new_buf)``."""
    f = x.shape[-1]
    assert buf.shape[-1] >= f, "comb delay must be >= block size"
    g = torch.as_tensor(feedback, dtype=torch.float32, device=x.device)
    y = x + g * buf[..., :f]
    return y, torch.cat([buf[..., f:], y], dim=-1)
