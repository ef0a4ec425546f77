"""Silence masks: optimization *hints* on which channels are all zeros.

Mirrors the semantics of the reference engine's ``SilenceMask``
(``crates/firewheel-core/src/silence_mask.rs:7-74``): a 64-bit bitmask where
bit ``i`` set means channel ``i`` is silent.

Two representations live side by side:

* :class:`SilenceMask` — a host-side integer bitmask with the exact reference
  API (``new_all_silent``, ``is_channel_silent``, ``any_channel_silent``,
  ``all_channels_silent``, ``set_channel``).  Used by the graph layer, tests,
  and the streaming backend.
* Boolean tensors (``bool[channels]``) — the on-device form the executor
  carries beside every buffer.  The kernels do not skip work for silent
  buffers; masks are *semantics* there: they decide state-reset behavior
  and which graph outputs are forced to zero, exactly like the reference's
  ``read_graph_outputs`` does (``schedule.rs:255-287``).

Conversion helpers bridge the two.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np

_ALL64 = (1 << 64) - 1

__all__ = ["SilenceMask", "mask_from_bools", "mask_to_bools"]


@dataclasses.dataclass(frozen=True)
class SilenceMask:
    """A 64-channel silence bitmask. Bit ``0b1`` is channel 0."""

    bits: int = 0

    # -- constants (assigned after the class body) ---------------------------
    NONE_SILENT: typing.ClassVar["SilenceMask"]
    MONO_SILENT: typing.ClassVar["SilenceMask"]
    STEREO_SILENT: typing.ClassVar["SilenceMask"]

    @staticmethod
    def new_all_silent(num_channels: int) -> "SilenceMask":
        if num_channels >= 64:
            return SilenceMask(_ALL64)
        return SilenceMask((1 << num_channels) - 1)

    # -- queries -------------------------------------------------------------
    def is_channel_silent(self, i: int) -> bool:
        return (self.bits >> i) & 1 != 0

    def any_channel_silent(self, num_channels: int) -> bool:
        if num_channels >= 64:
            return self.bits != 0
        return self.bits & ((1 << num_channels) - 1) != 0

    def all_channels_silent(self, num_channels: int) -> bool:
        if num_channels >= 64:
            return self.bits == _ALL64
        m = (1 << num_channels) - 1
        return self.bits & m == m

    # -- mutation (returns a new mask; the reference mutates in place) -------
    def set_channel(self, i: int, silent: bool) -> "SilenceMask":
        if silent:
            return SilenceMask(self.bits | (1 << i))
        return SilenceMask(self.bits & ~(1 << i) & _ALL64)

    def __int__(self) -> int:
        return self.bits


# Constants (mirror silence_mask.rs:11-17).
SilenceMask.NONE_SILENT = SilenceMask(0)
SilenceMask.MONO_SILENT = SilenceMask(0b1)
SilenceMask.STEREO_SILENT = SilenceMask(0b11)


def mask_from_bools(flags) -> SilenceMask:
    """Build a host mask from a boolean vector (numpy)."""
    flags = np.asarray(flags)
    bits = 0
    for i, f in enumerate(flags.reshape(-1)[:64]):
        if bool(f):
            bits |= 1 << i
    return SilenceMask(bits)


def mask_to_bools(mask: SilenceMask, num_channels: int) -> np.ndarray:
    """Expand a host mask into a ``bool[num_channels]`` vector."""
    return np.array(
        [mask.is_channel_silent(i) for i in range(num_channels)], dtype=bool
    )
