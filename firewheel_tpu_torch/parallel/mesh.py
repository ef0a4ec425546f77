"""Scale-out: batched instances and voice-parallel mixing over a device mesh.

PyTorch port of ``firewheel_tpu/parallel/mesh.py``.  A game server renders
many independent instances of one graph, whose params and state carry a
leading batch axis B (the JAX package's ``vmap``).  Two lowerings:
``"xla"`` (the eager executor, every node a torch kernel, one block at a
time) and ``"hybrid"`` (megakernel islands between torch stages,
``executor_hybrid.HybridMegaRenderer``).

* **Instance batching ("dp")**: with a mesh, :class:`BatchRenderer` shards
  the batch over one of its axes.  Torch runs one process per device
  (:mod:`.distributed`): every process makes the same calls with the same
  global arguments, and holds, renders and returns only its own
  contiguous block of rows (``local_rows``).  Instances are independent,
  so rendering needs no collective.
* **Voice parallelism ("vp")**: :class:`VoiceParallelMixer` shards one big
  mix's voices over a mesh axis; each process renders its voices, the mix
  is one ``all_reduce`` a chunk over that axis, and every process runs the
  master bus on the replicated mix.

Both compose: a 2-D mesh ``{"dp": ..., "vp": ...}`` shards instances on
one axis and voices on the other.

The serving control plane is here too: per-instance splices
(``update_instance``, ``reset_instance``), per-instance device events
(``poll_events``), per-rank fleet checkpoints, and ``render_stream``, the
loop that ships every chunk to the host (as interleaved pcm16 with
``output_format="pcm16"``, or one IMA ADPCM block per instance with
``"adpcm4"``) while the next one renders.
"""

from __future__ import annotations

import math
from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..convert import as_dicts, params_from_jax, state_from_jax, tree_map
from ..core.sample_resource import pcm_f32_to_i16
from ..device import DEFAULT_DEVICE, resolve_device
from ..executor import ScheduleProgram, node_key
from ..ops.adpcm_device import encode_ima_chunk
from ..processor import _Stager
from . import distributed

__all__ = ["BatchRenderer", "Egress", "VoiceParallelMixer", "make_mesh"]


def make_mesh(axis_sizes: dict[str, int], devices: str = "cuda"):
    """A ``torch.distributed.device_mesh.DeviceMesh`` over the fleet's
    processes with named axes, e.g. ``make_mesh({"dp": 4, "vp": 2})``:
    torch's counterpart of ``jax.sharding.Mesh``.  Its ``size(axis)``,
    ``get_local_rank(axis)`` and ``get_group(axis)`` are what the
    renderers read.

    Torch runs one process per device, where JAX meshes the devices of
    one process: the product of ``axis_sizes`` must equal the world size
    of the process group (:func:`~.distributed.initialize_multihost`),
    ranks laid out in row-major order over the axes.  Every process calls
    this with the same arguments (it creates a process group per axis).
    ``devices`` names the device type: the card by default, ``"cpu"``
    with the gloo backend.  Several ranks may share one device."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = tuple(int(v) for v in axis_sizes.values())
    world = distributed.process_count()
    if not distributed._initialized():
        raise RuntimeError("make_mesh needs the fleet's process group: call "
                           "initialize_multihost first")
    if math.prod(shape) != world:
        raise ValueError(f"mesh {dict(axis_sizes)} has {math.prod(shape)} ranks, "
                         f"the process group {world}")
    return init_device_mesh(devices, shape, mesh_dim_names=tuple(axis_sizes))


def _shard(total: int, mesh, axis: str, what: str) -> slice:
    """This process's contiguous block of ``total`` items sharded over
    ``axis`` of ``mesh`` (all of them without a mesh)."""
    if mesh is None:
        return slice(0, total)
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    if total % n:
        raise ValueError(f"{what} {total} must divide over mesh axis {axis}={n}")
    per = total // n
    start = mesh.get_local_rank(axis) * per
    return slice(start, start + per)


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
    card unless the caller passes ``device="cpu"``), optionally sharded
    over an axis of a mesh (:func:`make_mesh`).

    Per-instance params and state carry a leading batch axis.
    ``render_chunk`` renders K blocks per call and returns ``f32[B, K, No,
    F]``, interleaved ``int16[B, K, F, No]`` with ``output_format="pcm16"``,
    or ``uint8[B, block_align]`` with ``"adpcm4"``.

    With a mesh, B is the global batch and every process makes the same
    calls with the same global arguments (instance indices, ``graph_in``
    and param lists for all B instances).  Each process holds only its
    rows, ``local_rows``: a contiguous block of ``B / mesh.size(axis)`` at
    ``mesh.get_local_rank(axis)`` (ranks along the mesh's other axes hold
    the same rows).  Its trees and outputs lead with those rows, never
    with all B.
    """

    def __init__(
        self,
        program: ScheduleProgram,
        batch: int,
        device: str | torch.device = DEFAULT_DEVICE,
        output_format: str = "f32",
        lowering: str = "xla",
        tile: int = 1,
        mesh=None,
        axis: str = "dp",
    ):
        """``mesh``/``axis``: shard the batch over this axis of a
        :func:`make_mesh` mesh (``batch`` must divide by its size).
        ``lowering``: ``"xla"`` (the eager executor; the name is the JAX
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
        self.mesh = mesh
        self.axis = axis
        #: this process's rows of the global batch
        self.local_rows = _shard(self.batch, mesh, axis, "batch")
        self._rows = self.local_rows.stop - self.local_rows.start
        self.device = resolve_device(device)
        self.output_format = output_format
        self.lowering = lowering
        self._tile = int(tile)
        self._chunk_cache: dict[Any, Any] = {}
        self._silent_in_cache: dict[int, Any] = {}
        #: poll_events() baselines: (node_key, event) -> int64[rows, lanes]
        self._event_totals: dict[tuple, np.ndarray] = {}
        self._egress: Optional[Egress] = None
        self._stager = _Stager(self.device)

    # -- state/params with a leading batch axis -------------------------------
    def _broadcast(self, tree):
        """One instance's tree → ``[rows, ...]`` tensors on the device,
        copied once per leaf on the device (no rows-fold host staging)."""
        return tree_map(
            lambda t: t.unsqueeze(0).expand((self._rows,) + t.shape).clone(),
            params_from_jax(tree, self.device),
        )

    def init_state(self):
        return self._broadcast(self.program.init_state())

    def stack_params(self, params_list: Optional[Sequence[Any]] = None):
        """Stack per-instance param snapshots (or broadcast one: ``None``,
        or the same snapshot object for every instance).  ``params_list``
        holds all B instances' snapshots; only this process's rows are
        stacked, on the host, and put on the device."""
        if params_list is None:
            return self._broadcast(self.program.collect_params())
        if len(params_list) != self.batch:
            raise ValueError(
                f"{len(params_list)} param snapshots for a batch of {self.batch}"
            )
        mine = params_list[self.local_rows]
        if all(p is mine[0] for p in mine):
            return self._broadcast(mine[0])
        stacked = tree_map(
            lambda *xs: np.stack([np.asarray(x) for x in xs]),
            *(as_dicts(p) for p in mine),
        )
        return params_from_jax(stacked, self.device)

    # -- per-instance control plane ----------------------------------------------
    def _local_index(self, index: int) -> Optional[int]:
        """Global instance ``index`` → its row in this process's trees, or
        None where another process owns it."""
        index = int(index)
        if not 0 <= index < self.batch:
            raise IndexError(f"instance {index} outside a batch of {self.batch}")
        local = index - self.local_rows.start
        return local if 0 <= local < self._rows else None

    def update_instance(self, stacked, index: int, tree_i):
        """Write one instance's slice of a stacked params or state tree.

        The write is IN PLACE (the JAX package returns a new tree), in the
        device's stream order: a chunk already enqueued renders the old
        values, the next one the new.  It moves one instance's worth of
        data and never copies the other B−1 instances.  ``index`` is the
        global instance: with a mesh only the process that owns it writes,
        and the others return their tree unchanged (no collective).
        Returns ``stacked``."""
        local = self._local_index(index)
        if local is None:
            return stacked

        def write(s, x):
            s[local] = x

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
        """A batched counter leaf → its 32-bit totals ``int64[rows, lanes]``:
        one device→host fetch.  On the card that waits for the chunk in
        flight, as the JAX package's ``np.asarray`` does."""
        raw = t.cpu().numpy()
        return (raw.astype(np.int64) & 0xFFFFFFFF).reshape(raw.shape[0], -1)

    def poll_events(self, state):
        """Per-instance node events for a serving fleet (``list[NodeEvent]``
        with ``instance`` the global batch index): one host fetch of each
        declared counter leaf covers this process's instances, and each
        process reports its own.  Diff baselines live on this renderer, so
        poll from one place per renderer."""
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
                    lane=None if scalar else int(lane),
                    instance=self.local_rows.start + int(b),
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
        :meth:`update_instance`, and only on the process that owns
        ``index``; returns ``state``."""
        tmpl = template if template is not None else self.program.init_state()
        local = self._local_index(index)
        if local is None:
            return state
        for key, name, leaf in self._counter_leaves(tmpl):
            totals = self._event_totals.get((key, name))
            if totals is not None and local < totals.shape[0]:
                value = torch.as_tensor(leaf).reshape(1, -1)
                totals[local] = self._totals(value)[0]
        return self.update_instance(state, index, tmpl)

    # -- fleet checkpoint/restore ----------------------------------------------
    def save_checkpoint(self, path: str, state, extra_meta: dict | None = None) -> int:
        """Snapshot the fleet's recurrent state to ``path`` (a directory; see
        ``checkpoint.py``): each process writes its own rows, and every
        process of the fleet calls this with the same ``path``.  Returns
        the bytes of this process's state file."""
        meta = {
            "batch": self.batch,
            "axis": self.axis,
            "sample_rate": self.program.sample_rate,
            "max_block_frames": self.program.max_block_frames,
        }
        if extra_meta:
            meta.update(extra_meta)
        return self._save_rows(path, state, meta)

    def _save_rows(self, path: str, tree, meta: dict | None = None) -> int:
        """Write this process's rows of ``tree`` as its rank file of the
        fleet checkpoint at ``path``.  The batch axis must span every
        process: ranks that hold the same rows (an axis beside the
        batch's) cannot write one checkpoint, and every rank raises."""
        from ..checkpoint import save_sharded_checkpoint

        n = 1 if self.mesh is None else self.mesh.size(self.mesh.mesh_dim_names.index(self.axis))
        count = distributed.process_count()
        if n != count:
            raise ValueError(
                f"the batch axis {self.axis}={n} does not span the {count} processes: "
                "their rows do not tile the batch, so they cannot write one checkpoint")
        return save_sharded_checkpoint(path, tree, meta)

    def _batched_template(self, tree):
        """``tree``'s structure with ``[rows, ...]`` leaves, on no device."""
        return tree_map(lambda t: torch.empty((self._rows,) + tuple(t.shape),
                                              dtype=t.dtype, device="meta"), tree)

    def restore_checkpoint(self, path: str):
        """Restore a fleet checkpoint (from either package, written by any
        number of processes) → ``(state, meta)``: this process reads the
        rank files that overlap its rows.  Bit-exact resume.  The metadata
        is checked before the state is read; the event baselines move to
        the restored totals, so the next ``poll_events()`` reports only
        post-restore events."""
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
            global_batch=self.batch, rows=self.local_rows)
        state = self._lift_local(local)
        for key, name, leaf in self._counter_leaves(state):
            self._event_totals[(key, name)] = self._totals(leaf)
        return state, meta

    def _lift_local(self, local_tree):
        """Loaded ``[rows, ...]`` host leaves (uint32 where the port carries
        int64) → this process's batch tree on the device."""
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

        ``graph_in``: ``f32[B, K, Ni, F]`` (zeros if None), and ``in_mask``
        ``bool[B, K, Ni]``, for the global batch; with a mesh this process
        renders its rows of them.  Returns ``(out, out_mask [B, K, No],
        state')``, ``out`` as ``f32[B, K, No, F]``, with
        ``output_format="pcm16"`` as ``int16[B, K, F, No]``, and with
        ``"adpcm4"`` as ``uint8[B, block_align]`` (one IMA ADPCM block per
        instance); with a mesh, B is this process's rows (``local_rows``).
        """
        f = self.program.max_block_frames
        ni = self.program.num_graph_inputs
        b, k = self._rows, num_blocks
        graph_in, in_mask = self._mine(graph_in), self._mine(in_mask)
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

    def _mine(self, x):
        """This process's rows of a global ``[B, ...]`` operand."""
        if x is None or self._rows == self.batch:
            return x
        if x.shape[0] != self.batch:
            raise ValueError(f"an operand of {x.shape[0]} rows for a batch of "
                             f"{self.batch}")
        return x[self.local_rows]

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



class VoiceParallelMixer:
    """Shard a many-voice mix over a mesh axis: each process renders its
    voices, the mix is an ``all_reduce`` over the voice axis, then every
    process runs the master bus on the replicated mix.

    ``voice_program``: the compiled single-voice graph; the voices are a
    leading batch axis of its params and state, as :class:`BatchRenderer`
    batches instances.  ``master_program``: optional bus chain applied to
    the summed mix; its graph takes ``num_graph_inputs`` equal to the
    voice graph's outputs.  Params and state are ``{"voices": ...,
    "master": ...}`` trees, the JAX package's.  With a mesh each process
    holds ``num_voices / mesh.size(axis)`` voices (a contiguous block at
    ``mesh.get_local_rank(axis)``) and a replica of the master's.

    No voice reads the mix, so a chunk renders its K blocks of voices
    first and reduces their K mixes in one ``all_reduce`` (``f32[K, ch,
    F]``) before the master runs its K blocks: the outputs of a reduction
    a block, in one collective a chunk (``collectives`` counts them).
    """

    def __init__(
        self,
        voice_program: ScheduleProgram,
        num_voices: int,
        master_program: Optional[ScheduleProgram] = None,
        mesh=None,
        axis: str = "vp",
    ):
        self.voice_program = voice_program
        self.master_program = master_program
        self.num_voices = int(num_voices)
        self.mesh = mesh
        self.axis = axis
        #: this process's voices
        self.local_voices = _shard(self.num_voices, mesh, axis, "num_voices")
        self._voices = self.local_voices.stop - self.local_voices.start
        self.device = voice_program.device
        #: all_reduce calls made (one a chunk with a mesh)
        self.collectives = 0
        self._chunk_cache: dict[int, Any] = {}

    def init_state(self):
        voice = tree_map(lambda t: t.unsqueeze(0).expand((self._voices,) + t.shape)
                         .clone(), self.voice_program.init_state())
        master = (self.master_program.init_state()
                  if self.master_program is not None else {})
        return {"voices": voice, "master": master}

    def stack_voice_params(self, params_list: Optional[Sequence[Any]] = None):
        """``params_list``: all ``num_voices`` voices' snapshots (the voice
        program's current params for every voice by default); this
        process's voices are stacked on the host and put on the device."""
        if params_list is None:
            params_list = [self.voice_program.collect_params()] * self.num_voices
        if len(params_list) != self.num_voices:
            raise ValueError(f"{len(params_list)} param snapshots for "
                             f"{self.num_voices} voices")
        voices = tree_map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                          *(as_dicts(p) for p in list(params_list)[self.local_voices]))
        master = (self.master_program.collect_params()
                  if self.master_program is not None else {})
        return {"voices": params_from_jax(voices, self.device),
                "master": params_from_jax(master, self.device)}

    def step_fn(self, num_blocks: int):
        """``(params, state, start_sample) -> (out f32[K, ch, F], out_mask
        bool[K, ch], state')``: K blocks of every local voice, the mix
        (one ``all_reduce`` with a mesh), then K blocks of the master bus.
        The block clocks are :meth:`~firewheel_tpu_torch.executor.
        ScheduleProgram.block_clocks`' (``wrap_stream_sample`` and
        ``stream_time_from_sample``), the same for every voice."""
        vp, mp = self.voice_program, self.master_program
        voice_chunk = vp.chunk_fn(num_blocks)
        master_chunk = mp.chunk_fn(num_blocks) if mp is not None else None
        group = self.mesh.get_group(self.axis) if self.mesh is not None else None
        f, ni = vp.max_block_frames, vp.num_graph_inputs

        def chunk(params, state, start_sample):
            k, v, dev = num_blocks, self._voices, self.device
            outs, _, vstate = voice_chunk(
                params_from_jax(params["voices"], dev), state["voices"],
                torch.zeros((v, k, ni, f), dtype=torch.float32, device=dev),
                torch.ones((v, k, ni), dtype=torch.bool, device=dev),
                start_sample, 0)
            mix = outs.sum(dim=0)  # [K, ch, F]
            if group is not None:
                torch.distributed.all_reduce(mix, op=torch.distributed.ReduceOp.SUM,
                                             group=group)
                self.collectives += 1
            not_silent = torch.zeros(mix.shape[:-1], dtype=torch.bool, device=dev)
            if master_chunk is None:
                return mix, not_silent, {"voices": vstate, "master": {}}
            out, om, mstate = master_chunk(
                params_from_jax(params["master"], dev), state["master"], mix,
                not_silent, start_sample, 0)
            return out, om, {"voices": vstate, "master": mstate}

        return chunk

    def render_chunk(self, params, state, start_sample=0, num_blocks: int = 8):
        """Render ``num_blocks`` blocks of the mix → ``(out f32[K, ch, F],
        out_mask bool[K, ch], state')``, the same on every process."""
        fn = self._chunk_cache.get(num_blocks)
        if fn is None:
            fn = self.step_fn(num_blocks)
            self._chunk_cache[num_blocks] = fn
        return fn(params, state, start_sample)
