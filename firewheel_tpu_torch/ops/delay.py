"""Delay-line primitives.  PyTorch port of ``firewheel_tpu/ops/delay.py``
(``comb_init``; the pure delay waits for the latency slice)."""

from __future__ import annotations

import torch

__all__ = ["comb_init"]


def comb_init(channels: int, delay_frames: int) -> torch.Tensor:
    """Zero history for a feedback comb of ``delay_frames`` (must be ≥ the
    block size — in-block feedback would need a sequential recurrence)."""
    return torch.zeros((channels, delay_frames), dtype=torch.float32)
