"""Batched instances on one device.

PyTorch port of ``firewheel_tpu/parallel/mesh.py:BatchRenderer`` without
the mesh: a game server renders many independent instances of one graph,
whose params and state carry a leading batch axis B (the JAX package's
``vmap``).  Two lowerings: ``"xla"`` (the eager executor, every node a
torch kernel, one block at a time) and ``"hybrid"`` (megakernel islands
between torch stages, ``executor_hybrid.HybridMegaRenderer``).  The device
mesh and the pcm16/adpcm4 output formats are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..convert import as_dicts, params_from_jax, tree_map
from ..device import DEFAULT_DEVICE, resolve_device
from ..executor import ScheduleProgram

__all__ = ["BatchRenderer"]


class BatchRenderer:
    """Render B independent graph instances per dispatch on ``device`` (the
    card unless the caller passes ``device="cpu"``).

    Per-instance params and state carry a leading batch axis.
    ``render_chunk`` renders K blocks per call and returns
    ``f32[B, K, No, F]``.
    """

    def __init__(
        self,
        program: ScheduleProgram,
        batch: int,
        device: str | torch.device = DEFAULT_DEVICE,
        output_format: str = "f32",
        lowering: str = "xla",
        tile: int = 1,
    ):
        """``lowering``: ``"xla"`` (the eager executor; the name is the JAX
        package's) or ``"hybrid"`` (megakernel islands between torch
        stages); ``tile``: instances per CTA of the hybrid's island kernel.
        Both lowerings take and return the same param and state trees."""
        if lowering not in ("xla", "hybrid"):
            raise ValueError(f"lowering must be 'xla' or 'hybrid', got {lowering!r}")
        if output_format != "f32":
            raise NotImplementedError(
                f"output_format={output_format!r} is not ported yet "
                "(ROADMAP.md, Queue 2: pcm16/adpcm4); use 'f32'"
            )
        self.program = program
        self.batch = int(batch)
        self.device = resolve_device(device)
        self.output_format = output_format
        self.lowering = lowering
        self._tile = int(tile)
        self._chunk_cache: dict[Any, Any] = {}
        self._silent_in_cache: dict[int, Any] = {}

    # -- state/params with a leading batch axis -------------------------------
    def _broadcast(self, tree):
        """One instance's tree → ``[B, ...]`` tensors on the device, copied
        once per leaf on the device (no B-fold host staging)."""
        return tree_map(
            lambda t: t.unsqueeze(0).expand((self.batch,) + t.shape).clone(),
            params_from_jax(tree, self.device),
        )

    def init_state(self):
        return self._broadcast(self.program.init_state())

    def stack_params(self, params_list: Optional[Sequence[Any]] = None):
        """Stack per-instance param snapshots (or broadcast one)."""
        if params_list is None:
            return self._broadcast(self.program.collect_params())
        if len(params_list) != self.batch:
            raise ValueError(
                f"{len(params_list)} param snapshots for a batch of {self.batch}"
            )
        stacked = tree_map(
            lambda *xs: np.stack([np.asarray(x) for x in xs]),
            *(as_dicts(p) for p in params_list),
        )
        return params_from_jax(stacked, self.device)

    # -- per-instance control plane ----------------------------------------------
    def update_instance(self, stacked, index: int, tree_i):
        """Write one instance's slice of a stacked params or state tree.

        The write is IN PLACE (the JAX package returns a new tree): it
        moves one instance's worth of data and never copies the other B−1
        instances.  Returns ``stacked``."""
        def write(s, x):
            s[index] = x

        tree_map(write, stacked, params_from_jax(tree_i, self.device))
        return stacked

    # -- rendering ------------------------------------------------------------
    def render_chunk(self, params, state, graph_in=None, in_mask=None,
                     start_sample=0, status=0, num_blocks: int = 8):
        """Render ``num_blocks`` blocks for every instance.

        ``graph_in``: ``f32[B, K, Ni, F]`` (zeros if None).
        Returns ``(out [B, K, No, F], out_mask [B, K, No], state')``.
        """
        f = self.program.max_block_frames
        ni = self.program.num_graph_inputs
        b, k = self.batch, num_blocks
        if graph_in is None:
            cached = self._silent_in_cache.get(k)
            if cached is None:
                cached = (
                    torch.zeros((b, k, ni, f), dtype=torch.float32,
                                device=self.device),
                    torch.ones((b, k, ni), dtype=torch.bool, device=self.device),
                )
                self._silent_in_cache[k] = cached
            graph_in, default_mask = cached
            if in_mask is None:
                in_mask = default_mask
        elif in_mask is None:
            # provided inputs: not silent
            in_mask = torch.zeros((b, k, ni), dtype=torch.bool, device=self.device)
        if self.lowering == "hybrid":
            if int(status) != 0:
                raise ValueError(
                    "the hybrid lowering does not thread stream status; use "
                    "lowering='xla' for status-bearing streams"
                )
            hy = self._chunk_cache.get(("hybrid", k))
            if hy is None:
                from ..executor_hybrid import HybridMegaRenderer

                hy = HybridMegaRenderer(self.program, b, k, tile=self._tile,
                                        device=self.device)
                self._chunk_cache[("hybrid", k)] = hy
            return hy.render_chunk(params, state, graph_in, in_mask, start_sample)
        fn = self._chunk_cache.get(k)
        if fn is None:
            fn = self.program.chunk_fn(k)
            self._chunk_cache[k] = fn
        return fn(
            params_from_jax(params, self.device), state, graph_in, in_mask,
            start_sample, status,
        )
