"""Interleave/de-interleave between stream frames and channel-major buffers.

Behavioral spec: ``crates/firewheel-core/src/util.rs:44-175``.  These run on
the *host* at the streaming-backend boundary (the device always works in
channel-major ``[channels, frames]`` layout), so they are vectorized NumPy.
"""

from __future__ import annotations

import numpy as np

from .silence_mask import SilenceMask

__all__ = [
    "deinterleave",
    "interleave",
    "deinterleave_stereo",
    "interleave_stereo",
    "clear_all_outputs",
]


def deinterleave(
    channels: np.ndarray,
    interleaved: np.ndarray,
    num_interleaved_channels: int,
    calculate_silence_mask: bool,
) -> SilenceMask:
    """Fill ``channels[ch, frames]`` from an interleaved stream buffer.

    Mirrors util.rs:44-87: channels beyond ``num_interleaved_channels`` are
    zero-filled and marked silent; the silence mask is computed from the
    de-interleaved data when requested.
    """
    num_ch = channels.shape[0]
    frames = channels.shape[1]
    mask = SilenceMask.NONE_SILENT

    n = min(num_ch, num_interleaved_channels)
    if n > 0:
        src = np.asarray(interleaved[: frames * num_interleaved_channels]).reshape(
            frames, num_interleaved_channels
        )
        channels[:n, :] = src[:, :n].T
        if calculate_silence_mask:
            for i in range(min(n, 64)):
                if not np.any(channels[i, :]):
                    mask = mask.set_channel(i, True)

    for i in range(num_interleaved_channels, num_ch):
        channels[i, :] = 0.0
        if calculate_silence_mask and i < 64:
            mask = mask.set_channel(i, True)

    return mask


def interleave(
    channels: np.ndarray,
    interleaved: np.ndarray,
    num_interleaved_channels: int,
    silence_mask: SilenceMask | None = None,
) -> None:
    """Write ``channels[ch, frames]`` into an interleaved stream buffer.

    Mirrors util.rs:90-120: the output is zero-filled first and channels
    marked silent in the mask are skipped (left at zero).
    """
    interleaved[:] = 0.0
    frames = channels.shape[1]
    dst = interleaved[: frames * num_interleaved_channels].reshape(
        frames, num_interleaved_channels
    )
    n = min(channels.shape[0], num_interleaved_channels)
    for ch_i in range(n):
        if silence_mask is not None and ch_i < 64 and silence_mask.is_channel_silent(ch_i):
            continue
        dst[:, ch_i] = channels[ch_i, :]


def interleave_stereo(
    in_l: np.ndarray,
    in_r: np.ndarray,
    interleaved: np.ndarray,
    silence_mask: SilenceMask | None = None,
) -> None:
    """Stereo fast path (util.rs:123-147)."""
    if silence_mask is not None and silence_mask.all_channels_silent(2):
        interleaved[:] = 0.0
        return
    frames = len(interleaved) // 2
    dst = interleaved[: frames * 2].reshape(frames, 2)
    dst[:, 0] = in_l[:frames]
    dst[:, 1] = in_r[:frames]


def deinterleave_stereo(
    out_l: np.ndarray, out_r: np.ndarray, interleaved: np.ndarray
) -> None:
    """Stereo fast path (util.rs:150-162)."""
    frames = len(interleaved) // 2
    src = interleaved[: frames * 2].reshape(frames, 2)
    out_l[:frames] = src[:, 0]
    out_r[:frames] = src[:, 1]


def clear_all_outputs(frames: int, outputs: np.ndarray) -> SilenceMask:
    """Zero all output channels and return an all-silent mask (util.rs:165-175)."""
    outputs[:, :frames] = 0.0
    return SilenceMask.new_all_silent(outputs.shape[0])
