"""Typed node → host event notifications (the reference's TODO'd
"Notify node that sample has finished", sampler.rs:496,513 — designed for
a batched device render instead of callbacks).

Copied from ``firewheel_tpu/core/events.py``; in the port the counters are
int64 tensors masked to 32 bits (or int32, the clip counter), and
:func:`diff_counters` diffs them modulo 2**32 whatever their integer type.

A device kernel cannot call back into the host, and host round-trips per
block would destroy the batched dispatch model.  Instead, a node that
wants to notify the host keeps **monotonic uint32 event counters inside
its recurrent state** — one or two scalar increments fused into the
kernel, i.e. free — and declares them via
:meth:`~firewheel_tpu_torch.core.node.NodeProcessor.event_counters`.  The host
diffs those counters against its last-seen totals whenever the
application polls (``FirewheelCtx.poll_events()`` /
``GraphProcessor.poll_events()``) and emits :class:`NodeEvent` records.

Properties of this design:

* **Zero hot-path cost** — no host sync, no extra dispatch; the counters
  ride the state pytree that is already resident and already migrating
  across live schedule swaps (so no event is lost over a topology edit).
* **Chunk-granular** — events are observed at poll time, not at the
  exact sample; ``count`` aggregates every occurrence since the last
  poll (a one-shot retriggered three times between polls reports
  ``count=3``).  Games poll once per frame; the engine's per-block
  command *timelines* (``play(at_sample=...)``) remain the
  sample-accurate direction, this is the return direction.
* **Wrap-safe** — totals diff modulo 2**32, so a counter running for
  years cannot glitch.
* **Pool-aware** — a counter leaf may be a vector (pooled voices); each lane emits its own event with ``lane`` set.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["NodeEvent", "diff_counters"]


@dataclasses.dataclass(frozen=True)
class NodeEvent:
    """One event stream's activity since the previous poll.

    ``count`` is the number of occurrences since the last poll (>= 1 —
    silent streams emit nothing); ``total`` the monotonic total since
    the counter was initialised (survives schedule swaps and
    checkpoint/restore).  ``lane`` indexes a pooled/vector counter leaf
    (``None`` for scalar nodes); ``instance`` indexes the batch
    dimension when polled through a :class:`BatchRenderer` (``None``
    single-instance)."""

    node_id: object
    name: str
    count: int
    total: int
    lane: Optional[int] = None
    instance: Optional[int] = None


def diff_counters(prev: np.ndarray, cur: np.ndarray) -> np.ndarray:
    """Element-wise ``cur - prev`` on 32-bit totals, wrap-safe.  The totals
    may be any integer type holding the counter's low 32 bits (int64
    carriers, int32 bit patterns)."""
    mask = np.int64(0xFFFFFFFF)
    cur = np.asarray(cur).astype(np.int64) & mask
    prev = np.asarray(prev).astype(np.int64) & mask
    return ((cur - prev) & mask).astype(np.uint32)
