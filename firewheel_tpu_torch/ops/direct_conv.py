"""Direct (time-domain) streaming convolution.

PyTorch port of ``firewheel_tpu/ops/direct_conv.py``: one hop of a
streaming FIR, ``y[c, t] = Σ_k taps[c, k] · concat(hist, x)[c, N-1+t-k]``,
with the input tail ``f32[ch, N-1]`` as state.  Every tensor may carry
leading batch dimensions, and the taps are per instance, so a batch of
reverbs with different IRs is one depthwise ``conv1d`` (one group per
instance and channel).

cuDNN runs a float32 convolution in TF32 by default, which keeps about
three decimal digits: the precision bug that the JAX package guards against
with ``Precision.HIGHEST``.  The call here turns TF32 off for itself only.

``DIRECT_CONV_MAX_TAPS`` is the JAX package's crossover, measured on a TPU;
``ConvolutionReverbNode(method="auto")`` keeps it so that both packages pick
the same engine.  Re-deriving it on the H100 is open (ROADMAP.md).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["DIRECT_CONV_MAX_TAPS", "direct_hist_init", "direct_conv_step"]

DIRECT_CONV_MAX_TAPS = 512


def direct_hist_init(channels: int, num_taps: int) -> torch.Tensor:
    """Fresh input tail ``f32[ch, N-1]``."""
    return torch.zeros((channels, max(num_taps - 1, 0)), dtype=torch.float32)


def direct_conv_step(x, hist, taps):
    """Convolve one hop against an N-tap FIR.

    ``x``: ``f32[..., ch, n]``; ``hist``: ``f32[..., ch, N-1]``; ``taps``:
    ``f32[..., irch, N]`` with ``irch`` 1 (shared by the channels) or
    ``ch``.  Returns ``(y f32[..., ch, n], hist' f32[..., ch, N-1])``.
    """
    *lead, ch, n = x.shape
    num_taps = taps.shape[-1]
    if num_taps == 1:
        # degenerate single tap: a plain scale
        return x * taps[..., :1], hist
    buf = torch.cat([hist, x], dim=-1)  # [..., ch, N-1+n]
    # conv1d is a cross-correlation: convolve with the reversed taps
    rev = taps.flip(-1).expand(*lead, ch, num_taps)
    groups = buf[..., 0].numel()
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        y = F.conv1d(buf.reshape(1, groups, -1),
                     rev.reshape(groups, 1, num_taps), groups=groups)
    return y.reshape(x.shape), buf[..., n:]
