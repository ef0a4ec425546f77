"""Param/state trees: conversion between the JAX package and the port.

The JAX package keeps params and state as pytrees: dicts keyed by
``repr(NodeID)``, whose leaves are numpy scalars, JAX arrays, NamedTuples
(``SmootherState``) or ``()`` for a stateless node.  The port keeps nested
dicts of tensors: a NamedTuple becomes a dict of its fields and ``()`` an
empty dict.  torch has no uint32 arithmetic on the CPU, so every uint32
leaf (the beep phase and increment; the sampler's playhead, sequence
numbers, loop bounds and event counters) rides as int64 holding the same
value; int64 is used for nothing else, which makes the mapping reversible.
bool, int32 and float32 leaves (masks and flags, counters and partition
fills, audio, spectra as real/imag pairs) convert as they are.

These functions take trees whose leaves are numpy arrays (``jax.tree.map
(np.asarray, tree)`` on the JAX side) and never import JAX.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "as_dicts", "tree_map", "params_from_jax", "state_from_jax", "state_to_numpy",
]


def tree_map(fn, tree, *rest):
    """Apply ``fn`` to the leaves of equally structured nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def as_dicts(tree):
    """JAX pytree containers → nested dicts (leaves untouched)."""
    if isinstance(tree, dict):
        return {k: as_dicts(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {k: as_dicts(v) for k, v in tree._asdict().items()}
    if isinstance(tree, tuple) and not tree:
        return {}
    if isinstance(tree, tuple) and all(isinstance(v, dict) for v in tree):
        return {str(i): as_dicts(v) for i, v in enumerate(tree)}
    return tree


def _leaf_to_torch(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    a = np.array(x)  # a writable copy: JAX hands out read-only buffers
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(a).to(device)


def _to_torch(tree, device):
    return tree_map(lambda x: _leaf_to_torch(x, device), as_dicts(tree))


def params_from_jax(tree, device) -> dict:
    """A JAX param tree (or the port's own numpy snapshot from
    ``collect_params``) → the port's dict of tensors on ``device``."""
    return _to_torch(tree, device)


def state_from_jax(tree, device) -> dict:
    """A JAX state tree (numpy leaves) → the port's dict of tensors on
    ``device``: a mid-stream handoff from one package to the other."""
    return _to_torch(tree, device)


def state_to_numpy(tree) -> dict:
    """The port's state (or params) → nested dicts of numpy arrays, with
    the int64 carriers of uint32 values back as uint32."""

    def leaf(t):
        a = t.detach().cpu().numpy()
        return a.astype(np.uint32) if a.dtype == np.int64 else a

    return tree_map(leaf, tree)
