"""PCM sample resources: audio clips for sampler playback.

PyTorch port of ``firewheel_tpu/core/sample_resource.py`` (reference: the
``SampleResource`` trait, ``sample_resource.rs:4-456``).  Every container
layout converts once, at load time, to a channel-major float32 clip
``[channels, frames]``; playback is then a gather inside the sampler's
kernel, and one clip serves any number of voices.

Conversion formulas match sample_resource.rs:338-345:
``i16 → f32``: ``s / 32767``;  ``u16 → f32``: ``s * (2/65535) - 1``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "SampleResource",
    "pcm_i16_to_f32",
    "pcm_u16_to_f32",
    "pcm_f32_to_i16",
]


def pcm_i16_to_f32(data: np.ndarray) -> np.ndarray:
    """``f32(s) * (1/32767)`` (sample_resource.rs:338-340)."""
    return (
        np.asarray(data, np.int16).astype(np.float32) * np.float32(1.0 / 32767.0)
    ).astype(np.float32)


def pcm_f32_to_i16(x) -> torch.Tensor:
    """f32 → int16 PCM: ``round(clip(x, ±1) * 32767)``, the inverse of
    :func:`pcm_i16_to_f32` on every value that converter produces.  Takes a
    tensor (on any device) or anything numpy reads; rounds half to even, as
    the JAX package does."""
    x = torch.as_tensor(x, dtype=torch.float32)
    return torch.round(x.clamp(-1.0, 1.0) * 32767.0).to(torch.int16)


def pcm_u16_to_f32(data: np.ndarray) -> np.ndarray:
    """``f32(s) * (2/65535) - 1`` (sample_resource.rs:343-345)."""
    return (
        np.asarray(data, np.uint16).astype(np.float32) * np.float32(2.0 / 65535.0)
        - np.float32(1.0)
    ).astype(np.float32)


class SampleResource:
    """A float32, channel-major audio clip.

    Constructors cover every layout the reference supports
    (sample_resource.rs:28-335); all normalize into one canonical form.
    """

    def __init__(
        self,
        channels: np.ndarray,
        *,
        sample_rate: "float | None" = None,
        device: bool = True,
    ):
        """``sample_rate``: the clip's native rate in Hz, if known.  A
        sampler playing a rated clip into a stream of another rate scales
        its playback rate, and seconds-based seeks and loops address clip
        time.  ``None`` (the reference's behavior) means the stream rate.

        ``device``: keep a tensor copy for the sampler's params (on the
        CPU; a renderer moves params to its device); ``False`` keeps the
        host array only."""
        channels = np.atleast_2d(np.asarray(channels, np.float32))
        assert channels.ndim == 2, "expected [channels, frames]"
        self.sample_rate = float(sample_rate) if sample_rate else None
        self._host = channels
        self._device = torch.from_numpy(channels.copy()) if device else None

    # -- constructors mirroring the reference's impl matrix ------------------
    @classmethod
    def from_interleaved_i16(cls, data, num_channels: int, **kw) -> "SampleResource":
        d = np.asarray(data, np.int16).reshape(-1, num_channels)
        return cls(pcm_i16_to_f32(d).T, **kw)

    @classmethod
    def from_interleaved_u16(cls, data, num_channels: int, **kw) -> "SampleResource":
        d = np.asarray(data, np.uint16).reshape(-1, num_channels)
        return cls(pcm_u16_to_f32(d).T, **kw)

    @classmethod
    def from_interleaved_f32(cls, data, num_channels: int, **kw) -> "SampleResource":
        d = np.asarray(data, np.float32).reshape(-1, num_channels)
        return cls(d.T, **kw)

    @classmethod
    def from_channels_i16(cls, channels, **kw) -> "SampleResource":
        return cls(np.stack([pcm_i16_to_f32(c) for c in channels]), **kw)

    @classmethod
    def from_channels_u16(cls, channels, **kw) -> "SampleResource":
        return cls(np.stack([pcm_u16_to_f32(c) for c in channels]), **kw)

    @classmethod
    def from_channels_f32(cls, channels, **kw) -> "SampleResource":
        return cls(np.stack([np.asarray(c, np.float32) for c in channels]), **kw)

    # -- queries (sample_resource.rs:5-11) ------------------------------------
    @property
    def num_channels(self) -> int:
        return self._host.shape[0]

    @property
    def len_frames(self) -> int:
        return self._host.shape[1]

    @property
    def data(self):
        """The clip ``f32[channels, frames]``: a tensor, or the host array
        if the resource was created with ``device=False``."""
        return self._device if self._device is not None else self._host

    @property
    def host_data(self) -> np.ndarray:
        return self._host

    # -- host-side fill (the reference's fill_buffers, rs:13-26) -------------
    def fill_buffers(
        self, buffers: np.ndarray, buffer_range: range, start_frame: int
    ) -> None:
        """Copy ``len(buffer_range)`` frames starting at ``start_frame`` into
        ``buffers[ch, buffer_range]``; extra buffers are ignored; reads past
        the clip end are zero-filled."""
        lo, hi = buffer_range.start, buffer_range.stop
        n = hi - lo
        ch = min(buffers.shape[0], self.num_channels)
        avail = max(0, min(n, self.len_frames - start_frame))
        if avail > 0:
            buffers[:ch, lo : lo + avail] = self._host[
                :ch, start_frame : start_frame + avail
            ]
        if avail < n:
            buffers[:ch, lo + avail : hi] = 0.0
