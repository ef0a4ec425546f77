"""Checkpoint/resume: persist and restore engine state.

PyTorch port of ``firewheel_tpu/checkpoint.py``, writing the same files:
a checkpoint written by either package restores in the other.  All
recurrent audio state (phasors, smoothers, filter taps, delay lines,
playheads, meters) is one dict of tensors, so a checkpoint is that dict on
the host plus its metadata, and a later process resumes sample-exactly.

Format: a directory holding
* ``state.msgpack``, the state tree in ``flax.serialization``'s msgpack
  (written and read by the port's own codec, :mod:`~firewheel_tpu_torch.
  _msgpack`), with the int64 carriers of uint32 values written as uint32;
* ``meta.json``: sample rate, block size, node keys, and the caller's
  ``extra_meta`` (``FirewheelCtx.save_checkpoint`` adds the stream
  position).

**Fleet checkpoints** (:meth:`BatchRenderer.save_checkpoint`) use the JAX
package's per-process layout: ``state.rank<k>.msgpack`` holds rank k's
rows of the batch axis, and ``meta.json`` the fleet's metadata.  Every
rank of a fleet (:mod:`~firewheel_tpu_torch.parallel.distributed`) writes
its own rows; rank 0 publishes ``meta.json`` atomically, and a barrier on
the process group then holds every rank until all the files exist.  The
port records each rank's first row in ``meta.json`` (``rank_offsets``)
and places the rows by those offsets when it reads them back; the JAX
package's files carry no offsets and are read in rank order, the order
the port's ranks write them in, so either package reads the other's
files.  A fleet restores onto any number of ranks: each reads the rank
files that overlap its rows.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from . import _msgpack
from .convert import as_dicts, state_to_numpy, tree_map

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "restore_into",
    "save_sharded_checkpoint",
    "load_sharded_local",
    "read_meta",
]

_STATE_FILE = "state.msgpack"
_META_FILE = "meta.json"


def _topology() -> tuple[int, int]:
    """``(rank, process count)`` of the fleet's process group, read at
    each call (tests mock them in :mod:`~firewheel_tpu_torch.parallel.
    distributed`)."""
    from .parallel import distributed

    return distributed.process_index(), distributed.process_count()


def _file_dtype(t) -> np.dtype:
    """The dtype a template leaf (a tensor, or numpy) has in the file: the
    int64 carriers of uint32 values are uint32 there."""
    if isinstance(t, torch.Tensor):
        return np.dtype(np.uint32) if t.dtype == torch.int64 else \
            torch.empty((), dtype=t.dtype).numpy().dtype
    return np.asarray(t).dtype


def _write(path: str, tree) -> int:
    """Write a tree of tensors to ``path``; returns its bytes."""
    with open(path, "wb") as f:
        return _msgpack.write(f, state_to_numpy(tree))


def _read(path: str, template) -> dict:
    """Read the tree at ``path`` against ``template`` (leaves with a
    ``shape`` and a ``dtype``: tensors on any device, ``"meta"`` ones
    included) → nested dicts of numpy, each leaf checked against the
    template's shape and its dtype in the file."""
    with open(path, "rb") as f:
        tree = _msgpack.from_bytes(as_dicts(template), f.read())

    def walk(t, x, path=()):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], x[k], path + (k,))
            return
        x = np.asarray(x)
        want = (tuple(t.shape), _file_dtype(t))
        if (x.shape, x.dtype) != want:
            raise ValueError(f"checkpoint leaf {'/'.join(path)}: {x.dtype}{x.shape} "
                             f"where the template has {want[1]}{want[0]}")

    walk(as_dicts(template), tree)
    return tree


def _publish_meta(path: str, meta: dict) -> None:
    """Write ``meta.json`` atomically: a reader never sees half of it."""
    tmp = os.path.join(path, f".{_META_FILE}.{os.getpid()}.tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=2)
    os.replace(tmp, os.path.join(path, _META_FILE))


def _merge_meta(meta: dict, extra: dict | None, what: str) -> dict:
    if extra:
        reserved = set(meta) & set(extra)
        if reserved:
            raise ValueError(
                f"{what} uses reserved keys {sorted(reserved)}; nest user "
                "metadata under your own key instead"
            )
        meta.update(extra)
    return meta


def read_meta(path: str) -> dict:
    """The ``meta.json`` of the checkpoint at ``path``."""
    with open(os.path.join(path, _META_FILE)) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# Fleet (per-process) checkpointing
# ---------------------------------------------------------------------------

def save_sharded_checkpoint(path: str, state, meta: dict | None = None) -> int:
    """Write this process's rows of a batch-stacked state (or params) tree
    to ``path``; rank 0 also publishes the fleet metadata.  Every process
    of the fleet calls this with the same ``path`` (a shared filesystem)
    and returns once every rank's file and ``meta.json`` exist.  Rank k's
    rows start at k times this process's rows, the JAX package's layout.
    Returns the bytes of this rank's state file."""
    rank, count = _topology()
    per = _leading_extent(state)
    offsets = [k * per for k in range(count)]
    os.makedirs(path, exist_ok=True)
    nbytes = _write(os.path.join(path, f"state.rank{rank}.msgpack"), state)
    if rank == 0:
        full_meta = {
            "sharded": True,
            "process_count": count,
            "rank_offsets": offsets,
            "node_keys": sorted(state.keys()) if isinstance(state, dict) else None,
        }
        _publish_meta(path, _merge_meta(full_meta, meta, "meta"))
    if count > 1:
        import torch.distributed as dist

        # the other ranks read meta.json (and each other's files) once this
        # returns: hold them until rank 0 has published it
        dist.barrier()
    return nbytes


def _leading_extent(tree) -> int:
    """The batch every leaf of ``tree`` leads with."""
    extents = set()
    tree_map(lambda t: extents.add(int(t.shape[0])), as_dicts(tree))
    if len(extents) > 1:
        raise ValueError(f"leaves lead with different extents {sorted(extents)}")
    return extents.pop() if extents else 0


def _rank_offsets(meta: dict, ranks: int, per: int) -> list[int]:
    """Each old rank's first row: ``rank_offsets`` where the checkpoint
    records them (validated: the ranks' rows must tile the batch), rank
    order for the JAX package's files."""
    offsets = meta.get("rank_offsets")
    if offsets is None:
        return [k * per for k in range(ranks)]
    if (not isinstance(offsets, list) or len(offsets) != ranks
            or not all(type(o) is int for o in offsets)
            or sorted(offsets) != [k * per for k in range(ranks)]):
        raise ValueError(
            f"rank_offsets {offsets} do not tile {ranks} ranks of {per} rows")
    return offsets


def load_sharded_local(path: str, local_template, *, global_batch: int | None = None,
                       rows: slice | None = None):
    """Load this process's rows → ``(local_tree, meta)``: nested dicts of
    numpy with the file's dtypes (:func:`~firewheel_tpu_torch.convert.
    state_from_jax` lifts them).

    ``local_template``: the tree's structure and shapes with this
    process's rows leading every leaf (tensors on any device, ``"meta"``
    ones included).  ``rows``: the rows of the global batch to load
    (a renderer's ``local_rows``); by default this rank's contiguous share
    of ``global_batch``, or its own rank file when the checkpoint was
    written by as many processes as this fleet has.  Loading other rows,
    or from a checkpoint written by another number of processes, needs
    ``global_batch``, the batch every leaf shares; the rank files that
    overlap the rows are then read and their rows placed by each rank's
    offset."""
    meta = read_meta(path)
    rank, count = _topology()
    if rows is None and meta.get("process_count") == count:
        return _read(os.path.join(path, f"state.rank{rank}.msgpack"),
                     local_template), meta
    if global_batch is None:
        raise ValueError(
            f"fleet size mismatch: checkpoint has {meta.get('process_count')} "
            f"processes, this fleet has {count} (pass global_batch= to reshard)"
        )
    global_batch = int(global_batch)
    if rows is None:
        if global_batch % count:
            raise ValueError(f"global_batch {global_batch} must divide by this "
                             f"fleet's process count ({count})")
        per = global_batch // count
        rows = slice(rank * per, (rank + 1) * per)
    return _load_resharded(path, local_template, meta, global_batch, rows), meta


def _load_resharded(path: str, local_template, meta: dict, global_batch: int,
                    rows: slice):
    """Rebuild ``rows`` of the global batch from a checkpoint written by
    ``P`` processes, each rank file a contiguous ``[global_batch/P]`` run
    of rows starting at that rank's offset."""
    P = int(meta["process_count"])
    if P < 1 or global_batch % P:
        raise ValueError(
            f"global_batch {global_batch} must divide by the checkpoint's "
            f"process count ({P})"
        )
    start, end = rows.start, rows.stop
    if not 0 <= start < end <= global_batch:
        raise ValueError(f"rows {start}:{end} outside a batch of {global_batch}")
    old_per, new_per = global_batch // P, end - start
    template = as_dicts(local_template)

    def leaves(t):
        return [x for v in t.values() for x in leaves(v)] if isinstance(t, dict) else [t]

    for leaf in leaves(template):
        if tuple(leaf.shape[:1]) != (new_per,):
            raise ValueError(
                "resharded restore needs every leaf batched on the leading "
                f"axis with extent {new_per}; got shape {tuple(leaf.shape)}")
    old_template = tree_map(
        lambda t: torch.empty((old_per,) + tuple(t.shape[1:]), dtype=t.dtype,
                              device="meta"),
        template)
    offsets = _rank_offsets(meta, P, old_per)
    parts = []
    for k in sorted(range(P), key=lambda k: offsets[k]):
        lo, hi = max(start - offsets[k], 0), min(end - offsets[k], old_per)
        if lo < hi:
            old = _read(os.path.join(path, f"state.rank{k}.msgpack"), old_template)
            parts.append(tree_map(lambda x, lo=lo, hi=hi: np.asarray(x)[lo:hi], old))
    if len(parts) == 1:
        return parts[0]
    return tree_map(lambda *xs: np.concatenate(xs, axis=0), *parts)


# ---------------------------------------------------------------------------
# One processor
# ---------------------------------------------------------------------------

def save_checkpoint(path: str, processor, extra_meta: dict | None = None) -> None:
    """Write the processor's full recurrent state to ``path`` (a directory).

    ``processor``: a :class:`~firewheel_tpu_torch.processor.GraphProcessor`
    (or anything with ``state_dict()``, ``sample_rate`` and
    ``max_block_frames``)."""
    os.makedirs(path, exist_ok=True)
    state = processor.state_dict()
    _write(os.path.join(path, _STATE_FILE), state)
    meta = {
        "sample_rate": processor.sample_rate,
        "max_block_frames": processor.max_block_frames,
        "node_keys": sorted(state.keys()),
    }
    _publish_meta(path, _merge_meta(meta, extra_meta, "extra_meta"))


def load_checkpoint(path: str, template: Any):
    """Load a checkpoint against a ``template`` state tree (for structure
    and shapes) → ``(state, meta)``, the state as nested dicts of numpy
    (uint32 where the port carries int64)."""
    state = _read(os.path.join(path, _STATE_FILE), template)
    return state, read_meta(path)


def restore_into(path: str, processor) -> dict:
    """Restore a checkpoint into a live processor.

    The processor's graph must have the same node set, sample rate and
    block size (validated from the metadata before the state is read);
    returns the checkpoint metadata."""
    current = processor.state_dict()
    meta = read_meta(path)
    have = sorted(current.keys())
    want = meta.get("node_keys", have)
    if have != want:
        missing = set(want) - set(have)
        extra = set(have) - set(want)
        raise ValueError(
            "checkpoint/graph mismatch: "
            f"missing nodes {sorted(missing)}, unexpected {sorted(extra)}"
        )
    if meta.get("sample_rate") != processor.sample_rate:
        raise ValueError(
            f"sample-rate mismatch: checkpoint {meta.get('sample_rate')} vs "
            f"engine {processor.sample_rate}"
        )
    # block-size-dependent state (delay lines) would load wrong-shaped
    if meta.get("max_block_frames") != processor.max_block_frames:
        raise ValueError(
            "max_block_frames mismatch: checkpoint "
            f"{meta.get('max_block_frames')} vs engine "
            f"{processor.max_block_frames}"
        )
    state, meta = load_checkpoint(path, current)
    processor.set_state_dict(state)
    return meta

