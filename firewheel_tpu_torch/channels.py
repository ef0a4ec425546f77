"""Bounded message channels between the context and the processor.

The reference uses ``rtrb`` SPSC ring buffers of boxed messages with capacity
16 (``context.rs:14,61-64``) and handles channel-full without blocking.  In
one Python process a deque (GIL-atomic append/popleft) gives the same SPSC
discipline; capacity is enforced to preserve the reference's backpressure
behavior (``MessageChannelFull``, context.rs:124-137).
"""

from __future__ import annotations

import collections
from typing import Any

__all__ = ["ChannelFull", "MessageChannel", "channel_pair", "CHANNEL_CAPACITY"]

# context.rs:14
CHANNEL_CAPACITY = 16


class ChannelFull(Exception):
    pass


class MessageChannel:
    """Bounded SPSC FIFO of messages."""

    def __init__(self, capacity: int = CHANNEL_CAPACITY):
        self._q: collections.deque = collections.deque()
        self._capacity = capacity

    def push(self, msg: Any) -> None:
        if len(self._q) >= self._capacity:
            raise ChannelFull()
        self._q.append(msg)

    def pop(self):
        """Pop the oldest message, or None when empty."""
        try:
            return self._q.popleft()
        except IndexError:
            return None

    def __len__(self) -> int:
        return len(self._q)


def channel_pair(capacity: int = CHANNEL_CAPACITY):
    """(ctx→proc, proc→ctx) channel pair (context.rs:61-64)."""
    return MessageChannel(capacity), MessageChannel(capacity)
