"""Batched instances on one device: the serving fleet's renderer.

PyTorch port of ``firewheel_tpu/parallel/mesh.py:BatchRenderer`` without
the mesh: a game server renders many independent instances of one graph,
whose params and state carry a leading batch axis B (the JAX package's
``vmap``).  Two lowerings: ``"xla"`` (the eager executor, every node a
torch kernel, one block at a time) and ``"hybrid"`` (megakernel islands
between torch stages, ``executor_hybrid.HybridMegaRenderer``).

The serving control plane is here too: per-instance splices
(``update_instance``, ``reset_instance``), per-instance device events
(``poll_events``), fleet checkpoints, and ``render_stream``, the loop that
ships every chunk to the host (as interleaved pcm16 with
``output_format="pcm16"``, or one IMA ADPCM block per instance with
``"adpcm4"``) while the next one renders.  The device mesh and
multi-process sharding are not ported (ROADMAP.md).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..convert import as_dicts, params_from_jax, state_from_jax, tree_map
from ..core.sample_resource import pcm_f32_to_i16
from ..device import DEFAULT_DEVICE, resolve_device
from ..executor import ScheduleProgram, node_key
from ..ops.adpcm_device import encode_ima_chunk
from ..processor import _Stager

__all__ = ["BatchRenderer", "Egress"]


class _Fetch:
    """One chunk's device→host copy: ``wait()`` blocks until it has landed
    and returns the host array (a view of the egress buffer)."""

    __slots__ = ("host", "done")

    def __init__(self, host: torch.Tensor, done):
        self.host, self.done = host, done

    def wait(self) -> np.ndarray:
        if self.done is not None:
            self.done.synchronize()
        return self.host.numpy()


class Egress:
    """Device→host copies of rendered chunks, overlapped with the render of
    the next chunk.

    :meth:`start` enqueues the copy of one chunk's output into one of two
    host buffers, used in turn.  On a CUDA device the buffers are pinned
    and the copy runs on a side stream: it waits for an event recorded
    after the chunk's render, so the render stream goes on with the next
    chunk while the copy runs, and ``record_stream`` keeps the caching
    allocator from handing the output's memory to the next chunk while the
    copy still reads it.  On the CPU the copy runs at once.

    The array that ``_Fetch.wait`` returns is valid until the copy after
    next is started (two buffers): copy it to keep it longer."""

    def __init__(self, device: torch.device):
        self.device = device
        self._side = torch.cuda.Stream(device) if device.type == "cuda" else None
        self._key = None
        self._bufs: list = []
        self._turn = 0

    def start(self, out: torch.Tensor) -> _Fetch:
        key = (tuple(out.shape), out.dtype)
        if key != self._key:
            pinned = self._side is not None
            self._bufs = [torch.empty(out.shape, dtype=out.dtype, pin_memory=pinned)
                          for _ in range(2)]
            self._key, self._turn = key, 0
        host = self._bufs[self._turn]
        self._turn ^= 1
        if self._side is None:
            host.copy_(out)
            return _Fetch(host, None)
        self._side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._side):
            host.copy_(out, non_blocking=True)
        out.record_stream(self._side)
        done = torch.cuda.Event()
        done.record(self._side)
        return _Fetch(host, done)


def _unalias(state, params):
    """``state`` with every leaf that shares memory with a leaf of
    ``params`` copied.  A kernel may hand a param through as its new state
    (the sampler's sequence numbers), and the in-place splices of
    :meth:`BatchRenderer.update_instance` and :meth:`BatchRenderer.
    reset_instance` must write into one tree, not both."""
    ptrs = set()
    tree_map(lambda t: ptrs.add(t.untyped_storage().data_ptr()), params)
    return tree_map(
        lambda t: t.clone() if t.untyped_storage().data_ptr() in ptrs else t, state)


class BatchRenderer:
    """Render B independent graph instances per dispatch on ``device`` (the
    card unless the caller passes ``device="cpu"``).

    Per-instance params and state carry a leading batch axis.
    ``render_chunk`` renders K blocks per call and returns ``f32[B, K, No,
    F]``, interleaved ``int16[B, K, F, No]`` with ``output_format="pcm16"``,
    or ``uint8[B, block_align]`` with ``"adpcm4"``.
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
        Both lowerings take and return the same param and state trees.

        ``output_format``: ``"f32"`` returns ``f32[B, K, No, F]``;
        ``"pcm16"`` quantizes on the device to interleaved PCM
        ``int16[B, K, F, No]`` (frame-major: ``out[b].reshape(K*F, No)`` is
        the wire layout) by :func:`~firewheel_tpu_torch.core.sample_resource.
        pcm_f32_to_i16`, which halves the bytes a fleet ships to the
        host; ``"adpcm4"`` goes on to IMA ADPCM at 4 bits a sample on the
        device (:func:`~firewheel_tpu_torch.ops.adpcm_device.
        encode_ima_chunk`, K4 on the card), one block per instance a chunk,
        ``uint8[B, (4 + K·F/2)·No]``, a quarter of pcm16's bytes plus the
        headers (decode with :func:`~firewheel_tpu_torch.ops.adpcm_device.
        decode_ima_chunk`); it needs ``K·F`` divisible by 8."""
        if lowering not in ("xla", "hybrid"):
            raise ValueError(f"lowering must be 'xla' or 'hybrid', got {lowering!r}")
        if output_format not in ("f32", "pcm16", "adpcm4"):
            raise ValueError(f"output_format must be 'f32', 'pcm16' or 'adpcm4', "
                             f"got {output_format!r}")
        self.program = program
        self.batch = int(batch)
        self.device = resolve_device(device)
        self.output_format = output_format
        self.lowering = lowering
        self._tile = int(tile)
        self._chunk_cache: dict[Any, Any] = {}
        self._silent_in_cache: dict[int, Any] = {}
        #: poll_events() baselines: (node_key, event) -> int64[B, lanes]
        self._event_totals: dict[tuple, np.ndarray] = {}
        self._egress: Optional[Egress] = None
        self._stager = _Stager(self.device)

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
        """Stack per-instance param snapshots (or broadcast one: ``None``,
        or the same snapshot object for every instance)."""
        if params_list is None:
            return self._broadcast(self.program.collect_params())
        if len(params_list) != self.batch:
            raise ValueError(
                f"{len(params_list)} param snapshots for a batch of {self.batch}"
            )
        if all(p is params_list[0] for p in params_list):
            return self._broadcast(params_list[0])
        stacked = tree_map(
            lambda *xs: np.stack([np.asarray(x) for x in xs]),
            *(as_dicts(p) for p in params_list),
        )
        return params_from_jax(stacked, self.device)

    # -- per-instance control plane ----------------------------------------------
    def update_instance(self, stacked, index: int, tree_i):
        """Write one instance's slice of a stacked params or state tree.

        The write is IN PLACE (the JAX package returns a new tree), in the
        device's stream order: a chunk already enqueued renders the old
        values, the next one the new.  It moves one instance's worth of
        data and never copies the other B−1 instances.  Returns
        ``stacked``."""
        def write(s, x):
            s[index] = x

        # one staged host→device copy (pinned on the card, asynchronous):
        # a splice never waits for the chunk in flight
        tree_map(write, stacked, self._stager.stage(as_dicts(tree_i)))
        return stacked

    def _counter_leaves(self, state):
        """``(node_key, event_name, tensor [B, ...])`` for every declared
        event counter in ``state``."""
        for key, proc in self.program._procs.items():
            counters = proc.event_counters()
            st = state.get(key) if counters else None
            if not st:
                continue
            for name, leaf in counters.items():
                if leaf in st:
                    yield key, name, st[leaf]

    @staticmethod
    def _totals(t: torch.Tensor) -> np.ndarray:
        """A batched counter leaf → its 32-bit totals ``int64[B, lanes]``:
        one device→host fetch.  On the card that waits for the chunk in
        flight, as the JAX package's ``np.asarray`` does."""
        raw = t.cpu().numpy()
        return (raw.astype(np.int64) & 0xFFFFFFFF).reshape(raw.shape[0], -1)

    def poll_events(self, state):
        """Per-instance node events for a serving fleet (``list[NodeEvent]``
        with ``instance`` the batch index): one host fetch of each declared
        counter leaf covers all B instances.  Diff baselines live on this
        renderer, so poll from one place per renderer."""
        from ..core.events import NodeEvent, diff_counters

        ids = {node_key(sn.id): sn.id for sn in self.program.schedule.schedule}
        out: list = []
        for key, name, leaf in self._counter_leaves(state):
            scalar = leaf.ndim == 1  # [B] → a scalar counter
            cur = self._totals(leaf)
            prev = self._event_totals.get((key, name))
            if prev is None or prev.shape != cur.shape:
                prev = np.zeros_like(cur)
            delta = diff_counters(prev, cur)
            self._event_totals[(key, name)] = cur
            for b, lane in zip(*np.nonzero(delta)):
                out.append(NodeEvent(
                    node_id=ids.get(key, key), name=name,
                    count=int(delta[b, lane]), total=int(cur[b, lane]),
                    lane=None if scalar else int(lane), instance=int(b),
                ))
        return out

    def reset_instance(self, state, index: int, template=None):
        """Reset one instance to the program's initial state (a client
        disconnect or reconnect); every other instance's state is untouched.
        ``template``: the per-instance state tree to install; by default
        ``program.init_state()`` now (which reflects the template graph's
        current node values; SessionServer passes its saved idle snapshot).
        The instance's poll baselines move to the template's counters, so
        the next poll reports only the new tenant's events.  In place, as
        :meth:`update_instance`; returns ``state``."""
        tmpl = template if template is not None else self.program.init_state()
        for key, name, leaf in self._counter_leaves(tmpl):
            totals = self._event_totals.get((key, name))
            if totals is not None and index < totals.shape[0]:
                value = torch.as_tensor(leaf).reshape(1, -1)
                totals[index] = self._totals(value)[0]
        return self.update_instance(state, index, tmpl)

    # -- fleet checkpoint/restore ----------------------------------------------
    def save_checkpoint(self, path: str, state, extra_meta: dict | None = None) -> int:
        """Snapshot the fleet's recurrent state to ``path`` (a directory; see
        ``checkpoint.py``).  Returns the bytes of the state file."""
        from ..checkpoint import save_sharded_checkpoint

        meta = {
            "batch": self.batch,
            "sample_rate": self.program.sample_rate,
            "max_block_frames": self.program.max_block_frames,
        }
        if extra_meta:
            meta.update(extra_meta)
        return save_sharded_checkpoint(path, state, meta)

    def _batched_template(self, tree):
        """``tree``'s structure with ``[B, ...]`` leaves, on no device."""
        return tree_map(lambda t: torch.empty((self.batch,) + tuple(t.shape),
                                              dtype=t.dtype, device="meta"), tree)

    def restore_checkpoint(self, path: str):
        """Restore a fleet checkpoint (from either package) → ``(state,
        meta)``: bit-exact resume.  The metadata is checked before the state
        is read; the event baselines move to the restored totals, so the
        next ``poll_events()`` reports only post-restore events."""
        from ..checkpoint import load_sharded_local, read_meta

        meta = read_meta(path)
        for what, key, have in (("batch", "batch", self.batch),
                                ("sample-rate", "sample_rate", self.program.sample_rate),
                                ("block-size", "max_block_frames",
                                 self.program.max_block_frames)):
            if meta.get(key) != have:
                raise ValueError(f"{what} mismatch: checkpoint {meta.get(key)} vs "
                                 f"renderer {have}")
        local, meta = load_sharded_local(
            path, self._batched_template(self.program.init_state()),
            global_batch=self.batch)
        state = self._lift_local(local)
        for key, name, leaf in self._counter_leaves(state):
            self._event_totals[(key, name)] = self._totals(leaf)
        return state, meta

    def _lift_local(self, local_tree):
        """Loaded ``[B, ...]`` host leaves (uint32 where the port carries
        int64) → the batch tree on the device."""
        return state_from_jax(local_tree, self.device)

    # -- rendering ------------------------------------------------------------
    def _format(self, out: torch.Tensor) -> torch.Tensor:
        """``f32[B, K, No, F]`` → the output format, on the device."""
        if self.output_format == "pcm16":
            return pcm_f32_to_i16(out.transpose(-1, -2)).contiguous()
        if self.output_format == "adpcm4":
            b, k, no, f = out.shape
            pcm = pcm_f32_to_i16(out.transpose(-1, -2)).reshape(b, k * f, no)
            return encode_ima_chunk(pcm)
        return out

    def render_chunk(self, params, state, graph_in=None, in_mask=None,
                     start_sample=0, status=0, num_blocks: int = 8):
        """Render ``num_blocks`` blocks for every instance.

        ``graph_in``: ``f32[B, K, Ni, F]`` (zeros if None).
        Returns ``(out, out_mask [B, K, No], state')``, ``out`` as
        ``f32[B, K, No, F]``, with ``output_format="pcm16"`` as
        ``int16[B, K, F, No]``, and with ``"adpcm4"`` as ``uint8[B,
        block_align]`` (one IMA ADPCM block per instance).
        """
        f = self.program.max_block_frames
        ni = self.program.num_graph_inputs
        b, k = self.batch, num_blocks
        if self.output_format == "adpcm4" and (k * f) % 8:
            raise ValueError(f"output_format='adpcm4' needs K·F divisible by 8, "
                             f"got K={k}, F={f}")
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
        params = params_from_jax(params, self.device)
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
            out, om, st = hy.render_chunk(params, state, graph_in, in_mask,
                                          start_sample)
        else:
            fn = self._chunk_cache.get(k)
            if fn is None:
                fn = self.program.chunk_fn(k)
                self._chunk_cache[k] = fn
            out, om, st = fn(params, state, graph_in, in_mask, start_sample, status)
        return self._format(out), om, _unalias(st, params)

    def egress(self) -> Egress:
        """This renderer's :class:`Egress` (its two host buffers)."""
        if self._egress is None:
            self._egress = Egress(self.device)
        return self._egress

    def render_stream(self, params, state, *, num_chunks: int,
                      num_blocks: int = 8, start_sample: int = 0,
                      on_chunk=None):
        """Sustained serving loop with device→host egress: render
        ``num_chunks`` chunks and ship every chunk's audio to the host, the
        copy of chunk t overlapping the render of chunk t+1 (:class:`Egress`:
        a side stream and two pinned buffers on the card).  Pair with
        ``output_format="pcm16"`` to halve the shipped bytes, or with
        ``"adpcm4"`` to ship an eighth of them plus the IMA headers.

        ``on_chunk(host_out)`` is called with each chunk in order, as a
        NumPy view of an egress buffer that stays valid until ``on_chunk``
        returns (the buffer is refilled two chunks later): copy what you
        keep.  Without ``on_chunk`` the chunks are copied, collected and
        returned as a list (mind host memory at large B×K).
        Returns ``(chunks_or_None, final_state, next_start_sample)``.
        """
        f = self.program.max_block_frames
        collected = [] if on_chunk is None else None
        deliver = on_chunk if on_chunk is not None else \
            (lambda host: collected.append(host.copy()))
        egress = self.egress()
        pending = None
        s = int(start_sample)
        for _ in range(int(num_chunks)):
            out, _om, state = self.render_chunk(
                params, state, start_sample=s, num_blocks=num_blocks
            )
            s += num_blocks * f
            fetch = egress.start(out)
            if pending is not None:
                deliver(pending.wait())  # chunk t-1, while chunk t renders
            pending = fetch
        if pending is not None:
            deliver(pending.wait())
        return collected, state, s

