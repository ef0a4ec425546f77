"""Session multiplexing for serving fleets: many short-lived clients on
one batch renderer.

PyTorch port of ``firewheel_tpu/serving.py``.  :class:`SessionServer` is a
slot allocator with generation-checked session handles over a single
:class:`~firewheel_tpu_torch.parallel.mesh.BatchRenderer`:

* ``connect()`` claims a slot, resets its recurrent state, and splices the
  session's params (built by mutating the template graph's node handles in
  a ``configure`` callback): one instance's worth of data, the other B−1
  sessions undisturbed.
* ``disconnect()`` returns the slot to the idle pool and re-splices the
  server's idle (muted) snapshot, so a vacant slot renders silence.
* ``render()`` advances the whole fleet one chunk; ``render_fetched()``
  also ships the previous chunk to the host while this one renders;
  ``poll_events()`` returns device events grouped per live session, with
  slot reuse isolated by the renderer's per-instance baseline reset.
* Handles are generation-checked: a handle whose slot was re-assigned
  becomes a silent no-op.

Capacity is fixed per server (the renderer's batch); run one server per
(graph shape, batch) and route sessions between servers in the
application.  Over a mesh (``mesh=``/``axis=`` pass through to the
renderer) every process of the fleet runs the same server and makes the
same calls: each renders its own slots, checkpoints them to its own rank
file, and polls its own slots' events.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Callable, Optional

import numpy as np
import torch

from .convert import tree_map
from .core.sample_resource import SampleResource
from .executor import ScheduleProgram
from .parallel.mesh import BatchRenderer

__all__ = ["SessionServer", "SessionHandle"]

#: kept by reference in a control snapshot, wherever they sit: configure
#: callbacks replace such objects, they do not mutate them
_SHARED = (np.ndarray, torch.Tensor, SampleResource)


def _shared_memo(obj, memo: dict) -> dict:
    """``memo`` for ``copy.deepcopy(obj, memo)`` that maps every shared
    object inside ``obj``'s containers to itself."""
    if isinstance(obj, _SHARED):
        memo[id(obj)] = obj
    elif isinstance(obj, dict):
        for v in obj.values():
            _shared_memo(v, memo)
    elif isinstance(obj, (list, tuple, set, frozenset)):
        for v in obj:
            _shared_memo(v, memo)
    return memo


def _snap_dict(d: dict) -> dict:
    """Snapshot a node's ``__dict__``.  Container attributes (scheduled-
    command lists etc.) are deep-copied, so a configure callback that
    mutates something nested inside one cannot alias into another
    session's snapshot; the arrays, tensors and ``SampleResource``s inside
    them are kept by reference, as every other attribute is (the JAX
    package's snapshot copied those too, one copy per session)."""
    return {
        k: (copy.deepcopy(v, _shared_memo(v, {}))
            if isinstance(v, (list, dict, set, bytearray)) else v)
        for k, v in d.items()
    }


class SessionHandle:
    """Generation-checked handle for one connected session."""

    def __init__(self, server: "SessionServer", slot: int, gen: int):
        self._server = server
        self._slot = slot
        self._gen = gen

    @property
    def slot(self) -> int:
        return self._slot

    @property
    def alive(self) -> bool:
        return self._server._gens[self._slot] == self._gen

    def update(self, configure: Callable[[], None]) -> None:
        """Apply a control change to THIS session: ``configure()`` mutates
        the template graph's node handles, pre-restored to this session's
        current control state (so partial updates compose), and the
        resulting param snapshot is spliced into this slot only."""
        if self.alive:
            self._server._splice(
                self._slot, configure,
                base=self._server._slot_ctrl[self._slot],
            )

    def reset(self) -> None:
        """Reset this session's recurrent state (e.g. a reconnect)."""
        if self.alive:
            self._server._state = self._server._br.reset_instance(
                self._server._state, self._slot,
                template=self._server._idle_state,
            )

    def disconnect(self) -> None:
        if self.alive:
            self._server.disconnect(self)


class SessionServer:
    """Multiplex up to ``capacity`` client sessions onto one batch
    renderer.

    ``program`` is built from the TEMPLATE graph; keep the graph's node
    handles: ``connect``/``update`` configure a session by mutating them
    inside a callback, and the server snapshots params from the template
    afterward.  Construct the server while the template is in its IDLE
    state (sources muted or paused): that snapshot fills vacant slots, and
    every ``connect`` configure runs against the template restored to it
    (``update`` configures run against the session's own previous control
    state), so a partial configure never inherits another session's
    settings.  Between server calls the template sits in its idle state;
    attributes holding arrays or resources are restored by reference, so
    configure callbacks must replace them (``set_sample(...)``), not
    mutate them in place.

    ``renderer_kwargs`` pass through to :class:`BatchRenderer`
    (``device``, the card unless ``"cpu"`` is passed; ``lowering``;
    ``output_format``; ``tile``; ``mesh`` and ``axis`` to shard the slots
    over a mesh axis).
    """

    def __init__(
        self,
        program: ScheduleProgram,
        capacity: int,
        *,
        chunk_blocks: int = 16,
        **renderer_kwargs: Any,
    ):
        self.program = program
        self.capacity = int(capacity)
        self.chunk_blocks = int(chunk_blocks)
        self._br = BatchRenderer(program, batch=capacity, **renderer_kwargs)
        #: the idle template snapshots, captured NOW while the template is
        #: idle: vacant slots render these params, and every slot reset
        #: installs this state
        self._idle_params = program.collect_params()
        self._idle_state = program.init_state()
        #: the template nodes whose control state (``__dict__``) is
        #: snapshotted: the idle snapshot is the base of every ``connect``
        #: configure, and each live slot keeps its own for ``update``
        self._nodes = []
        seen: set[int] = set()
        for proc in program._procs.values():
            node = getattr(proc, "_node", None)
            if node is not None and id(node) not in seen:
                seen.add(id(node))
                self._nodes.append(node)
        self._idle_ctrl = self._capture_ctrl()
        self._slot_ctrl: list = [None] * capacity
        self._params = self._br.stack_params([self._idle_params] * capacity)
        self._state = self._br.init_state()
        self._free = list(range(capacity - 1, -1, -1))  # pop() → slot 0 first
        self._gens = [0] * capacity
        self._live: dict[int, SessionHandle] = {}
        self.sample = 0  # fleet stream clock (absolute samples)
        #: one-chunk render→fetch pipeline (render_fetched): the fetch of
        #: the chunk in flight
        self._inflight = None

    # -- session lifecycle -----------------------------------------------------
    def _capture_ctrl(self) -> list[dict]:
        return [_snap_dict(n.__dict__) for n in self._nodes]

    def _restore_ctrl(self, snaps: list[dict]) -> None:
        for node, d in zip(self._nodes, snaps):
            node.__dict__.clear()
            node.__dict__.update(_snap_dict(d))

    def _splice(self, slot: int, configure: Optional[Callable],
                base: Optional[list] = None) -> None:
        """Splice one slot's params.  ``configure`` runs against the
        template restored to ``base`` (the idle snapshot by default, or the
        session's own previous control state for ``update``); the template
        is restored to idle afterward either way."""
        if configure is not None:
            self._restore_ctrl(base if base is not None else self._idle_ctrl)
            try:
                configure()
                params_i = self.program.collect_params()
                self._reject_scheduled_commands()
                self._slot_ctrl[slot] = self._capture_ctrl()
            finally:
                self._restore_ctrl(self._idle_ctrl)
        else:
            params_i = self._idle_params
            self._slot_ctrl[slot] = None
        self._params = self._br.update_instance(self._params, slot, params_i)

    def _reject_scheduled_commands(self) -> None:
        """``at_sample=`` commands need per-dispatch timeline consumption
        (``collect_params(start_sample=...)``), which only the streaming
        :class:`~firewheel_tpu_torch.processor.GraphProcessor` performs; on
        the snapshot-based serving path they would never fire (and pile up
        on the template nodes).  Fail fast instead: issue immediate
        commands from ``configure`` and call ``handle.update`` when the
        change should apply (chunk-granular)."""
        for proc in self.program._procs.values():
            node = getattr(proc, "_node", None)
            pending = getattr(node, "_scheduled", None)
            if pending:
                pending.clear()
                raise ValueError(
                    f"{type(node).__name__}: at_sample= scheduled commands "
                    "are not supported on the SessionServer/BatchRenderer "
                    "path (no per-dispatch timeline consumption); use "
                    "immediate commands in configure()/update()"
                )

    def connect(
        self, configure: Callable[[], None] | None = None
    ) -> Optional[SessionHandle]:
        """Claim a slot for a new session (``None`` when full).
        ``configure()`` mutates the template graph's nodes into this
        session's starting state."""
        if not self._free:
            return None
        slot = self._free.pop()
        self._gens[slot] += 1
        try:
            self._state = self._br.reset_instance(
                self._state, slot, template=self._idle_state
            )
            self._splice(slot, configure)
        except Exception:
            # a raising configure() must not leak the slot
            self._gens[slot] += 1
            self._free.append(slot)
            raise
        h = SessionHandle(self, slot, self._gens[slot])
        self._live[slot] = h
        return h

    def disconnect(self, handle: SessionHandle) -> None:
        """Release a session's slot; the slot renders the idle template
        until re-assigned."""
        if not handle.alive:
            return
        slot = handle._slot
        self._gens[slot] += 1
        self._live.pop(slot, None)
        self._splice(slot, None)  # idle/muted params
        self._free.append(slot)

    @property
    def occupancy(self) -> int:
        return self.capacity - len(self._free)

    # -- the serving hot loop --------------------------------------------------
    def render(self, num_blocks: int | None = None):
        """Render one chunk for every slot → the renderer's output on the
        device (``f32[B, K, No, F]``, wire-ready ``int16[B, K, F, No]``
        with ``output_format="pcm16"``, or one IMA ADPCM block per slot,
        ``uint8[B, block_align]``, with ``"adpcm4"``).  Index by
        ``handle.slot`` for a session's audio; over a mesh B is this
        process's slots, ``handle.slot - renderer.local_rows.start``."""
        k = num_blocks or self.chunk_blocks
        out, _om, self._state = self._br.render_chunk(
            self._params, self._state, start_sample=self.sample, num_blocks=k,
        )
        self.sample += k * self.program.max_block_frames
        return out

    def render_fetched(self, num_blocks: int | None = None):
        """The shipped-audio hot loop: render the next chunk, start its copy
        to the host (:class:`~firewheel_tpu_torch.parallel.mesh.Egress`: a
        side stream on the card), and return the PREVIOUS chunk's audio,
        whose copy ran while this chunk rendered, as a NumPy array the
        caller owns; ``None`` on the first call (the pipeline primes, and
        the fleet's wire output runs one chunk behind ``self.sample``).
        Call :meth:`flush` on shutdown to drain the last chunk.  Construct
        the server with ``output_format="pcm16"`` to halve the bytes, or
        ``"adpcm4"`` to ship a row of IMA ADPCM per slot (an eighth of
        f32's bytes plus the headers)."""
        fetch = self._br.egress().start(self.render(num_blocks))
        prev, self._inflight = self._inflight, fetch
        return None if prev is None else prev.wait().copy()

    def flush(self):
        """Drain the render→fetch pipeline: the last chunk in flight as a
        NumPy array (``None`` when nothing is in flight)."""
        prev, self._inflight = self._inflight, None
        return None if prev is None else prev.wait().copy()

    # -- fleet checkpoint/resume -------------------------------------------------
    def save_checkpoint(self, path: str, extra_meta: dict | None = None) -> int:
        """Snapshot the whole fleet mid-stream: state and params, plus the
        slot allocator's control block (generations, free list, stream
        clock).  Over a mesh every process calls this with the same
        ``path`` and writes its own slots.  The chunk in flight in
        ``render_fetched`` is not part of the snapshot: ``flush()`` before
        saving.  Returns the bytes of this process's state and params
        files."""
        meta = {
            "session_server": {
                "capacity": self.capacity,
                "chunk_blocks": self.chunk_blocks,
                "gens": list(self._gens),
                "free": list(self._free),
                "sample": int(self.sample),
            }
        }
        if extra_meta:
            reserved = set(meta) & set(extra_meta)
            if reserved:
                raise ValueError(f"extra_meta uses reserved keys {reserved}")
            meta.update(extra_meta)
        nbytes = self._br.save_checkpoint(os.path.join(path, "state"), self._state,
                                          extra_meta=meta)
        return nbytes + self._br._save_rows(os.path.join(path, "params"),
                                            self._params)

    def restore_checkpoint(self, path: str):
        """Resume a saved fleet on a freshly constructed server (same
        template program and capacity; the mesh and the process count may
        differ: each process reads the rank files that overlap its slots)
        → ``{slot: SessionHandle}`` for every session live at save time
        (the application re-associates its clients by slot).  The resumed render is bit-exact, and the event
        counters re-baseline, so ``poll_events`` reports only post-restore
        events.  One documented loss: per-session control snapshots (the
        basis of partial ``update()`` composition) are host callback state
        and are not saved, so after a restore ``update()`` configures
        compose against the IDLE state: issue total updates for restored
        sessions."""
        from .checkpoint import load_sharded_local

        state, meta = self._br.restore_checkpoint(os.path.join(path, "state"))
        ctrl = meta["session_server"]
        if ctrl["capacity"] != self.capacity:
            raise ValueError(
                f"capacity mismatch: checkpoint {ctrl['capacity']} vs "
                f"server {self.capacity}"
            )
        template = tree_map(lambda t: torch.empty_like(t, device="meta"),
                            self._params)
        local, _ = load_sharded_local(os.path.join(path, "params"), template,
                                      global_batch=self.capacity,
                                      rows=self._br.local_rows)
        self._params = self._br._lift_local(local)
        self._state = state
        # the restored state carries device-side command sequence numbers
        # the fresh template does not know: each processor adopts the fleet
        # maximum, then the idle snapshots are taken again so later splices
        # start from the adopted counters instead of rewinding them to zero
        for key, proc in self.program._procs.items():
            st = state.get(key)
            if st:
                proc.resync_from_state(st)
        self._idle_params = self.program.collect_params()
        self._idle_ctrl = self._capture_ctrl()
        self._gens = list(ctrl["gens"])
        self._free = list(ctrl["free"])
        self.sample = int(ctrl["sample"])
        self._slot_ctrl = [None] * self.capacity  # see docstring
        self._inflight = None
        free = set(self._free)
        self._live = {slot: SessionHandle(self, slot, self._gens[slot])
                      for slot in range(self.capacity) if slot not in free}
        return dict(self._live)

    def poll_events(self) -> dict:
        """Device events since the last poll, grouped per LIVE session:
        ``{SessionHandle: [NodeEvent, ...]}``.  Events from vacant or
        re-assigned slots are dropped (the renderer re-baselines a slot's
        counters on reset, so a new tenant never inherits its
        predecessor's totals).  Over a mesh each process reports its own
        slots' sessions.  On the card the poll waits for the chunk in
        flight."""
        out: dict = {}
        for e in self._br.poll_events(self._state):
            h = self._live.get(e.instance)
            if h is not None:
                out.setdefault(h, []).append(e)
        return out
