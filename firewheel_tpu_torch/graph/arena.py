"""A generational arena: stable integer slots with ABA-safe generations.

The reference uses ``thunderdome::Arena`` for node and edge storage
(``graph.rs:110-111``) so that IDs stay valid across removals and slot reuse
is detectable.  This is the same structure in plain Python.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Any, Iterator

__all__ = ["Index", "Arena"]


@dataclasses.dataclass(frozen=True, order=True)
class Index:
    """A (slot, generation) handle, like ``thunderdome::Index``."""

    slot: int
    generation: int

    DANGLING: typing.ClassVar["Index"]

    def __repr__(self):
        return f"{self.slot}v{self.generation}"


Index.DANGLING = Index(-1, 0)


class Arena:
    """Slot map with generation counters and a free list."""

    def __init__(self):
        self._items: list[Any] = []
        self._generations: list[int] = []
        self._free: list[int] = []
        self._len = 0

    def insert(self, value) -> Index:
        if value is None:
            # None is the vacancy sentinel; storing it would desync _len
            # from the occupied slots and strand the slot forever
            raise ValueError("Arena cannot store None")
        if self._free:
            slot = self._free.pop()
            self._items[slot] = value
        else:
            slot = len(self._items)
            self._items.append(value)
            self._generations.append(0)
        self._len += 1
        return Index(slot, self._generations[slot])

    def get(self, index: Index):
        if self.contains(index):
            return self._items[index.slot]
        return None

    def get_by_slot(self, slot: int):
        if 0 <= slot < len(self._items) and self._items[slot] is not None:
            return Index(slot, self._generations[slot]), self._items[slot]
        return None

    def contains(self, index: Index) -> bool:
        return (
            0 <= index.slot < len(self._items)
            and self._items[index.slot] is not None
            and self._generations[index.slot] == index.generation
        )

    def remove(self, index: Index):
        if not self.contains(index):
            return None
        value = self._items[index.slot]
        self._items[index.slot] = None
        self._generations[index.slot] += 1
        self._free.append(index.slot)
        self._len -= 1
        return value

    def __len__(self) -> int:
        return self._len

    @property
    def capacity(self) -> int:
        return len(self._items)

    def __iter__(self) -> Iterator[tuple[Index, Any]]:
        for slot, value in enumerate(self._items):
            if value is not None:
                yield Index(slot, self._generations[slot]), value

    def drain(self) -> Iterator[tuple[Index, Any]]:
        pairs = list(self)
        for idx, _ in pairs:
            self.remove(idx)
        yield from pairs
