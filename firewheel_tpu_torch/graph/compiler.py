"""The graph compiler: DAG → topologically-sorted schedule + buffer plan.

Reference algorithm: ``crates/firewheel-graph/src/graph/compiler.rs:139-418``
(itself adapted from m-hilgendorf/audio-graph, per ``graph/error.rs:1-2``):

1. *preprocess* — rebuild per-node adjacency from the edge list
   (compiler.rs:191-228);
2. *sort topologically* — Kahn's BFS with ``graph_in`` forced first and
   ``graph_out`` forced last (compiler.rs:232-300);
3. *solve buffer requirements* — a greedy register allocator over block
   buffers with a free list, fan-out sharing via reference counts, and
   generation counters kept for debugging/visualization
   (compiler.rs:302-412);
4. *merge* — emit the :class:`CompiledSchedule` (compiler.rs:415-417).

On TPU the schedule is not interpreted buffer-by-buffer at runtime; the
executor (``firewheel_tpu/executor.py``) unrolls it at trace time into one
fused XLA computation.  The buffer plan still matters: it is the stable
naming scheme connecting edges to SSA values, keeps the pretty-printed
debug dump meaningful, and bounds arena size if a Pallas megakernel wants a
physical arena.
"""

from __future__ import annotations

import dataclasses
import typing
from collections import deque
from typing import Any, Optional

from .arena import Arena, Index
from .errors import CompileCycleDetected, ManyToOneError

__all__ = [
    "NodeID",
    "NodeEntry",
    "Edge",
    "EdgeID",
    "InBufferAssignment",
    "OutBufferAssignment",
    "ScheduledNode",
    "CompiledSchedule",
    "compile_graph",
    "cycle_detected",
]


@dataclasses.dataclass(frozen=True)
class NodeID:
    """Globally unique node handle (graph.rs:19-74): generational index plus
    a debug name (the name does not participate in equality)."""

    idx: Index
    debug_name: str = "dangling"

    DANGLING: typing.ClassVar["NodeID"]

    def __eq__(self, other):
        return isinstance(other, NodeID) and self.idx == other.idx

    def __hash__(self):
        return hash(self.idx)

    def __repr__(self):
        return f"{self.debug_name}-{self.idx.slot}-{self.idx.generation}"


NodeID.DANGLING = NodeID(Index.DANGLING)


@dataclasses.dataclass(frozen=True)
class EdgeID:
    """Globally unique edge handle (compiler.rs:61-63)."""

    idx: Index

    def __repr__(self):
        return f"edge-{self.idx.slot}-{self.idx.generation}"


@dataclasses.dataclass(frozen=True)
class Edge:
    """A connection from (src_node, src_port) to (dst_node, dst_port)
    (compiler.rs:67-78)."""

    id: EdgeID
    src_node: NodeID
    src_port: int
    dst_node: NodeID
    dst_port: int


@dataclasses.dataclass
class NodeEntry:
    """Arena entry for a node (compiler.rs:12-39)."""

    id: NodeID
    num_inputs: int
    num_outputs: int
    weight: Any
    incoming: list = dataclasses.field(default_factory=list)
    outgoing: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass(frozen=True)
class InBufferAssignment:
    """Buffer for an input port (schedule.rs:104-115)."""

    buffer_index: int
    should_clear: bool
    generation: int


@dataclasses.dataclass(frozen=True)
class OutBufferAssignment:
    """Buffer for an output port (schedule.rs:118-126)."""

    buffer_index: int
    generation: int


@dataclasses.dataclass
class ScheduledNode:
    """A node with assigned buffers and a place in the schedule
    (schedule.rs:12-30)."""

    id: NodeID
    input_buffers: list[InBufferAssignment] = dataclasses.field(default_factory=list)
    output_buffers: list[OutBufferAssignment] = dataclasses.field(default_factory=list)

    def __repr__(self):
        # Debug-dump format mirrors schedule.rs:32-101.
        parts = [f"{{ {self.id!r}"]
        if self.input_buffers:
            parts.append(
                " | in: [" + ", ".join(str(b.buffer_index) for b in self.input_buffers) + "]"
            )
        if self.output_buffers:
            parts.append(
                " | out: [" + ", ".join(str(b.buffer_index) for b in self.output_buffers) + "]"
            )
        if self.input_buffers:
            parts.append(
                " | in_clear: ["
                + ", ".join("y" if b.should_clear else "n" for b in self.input_buffers)
                + "]"
            )
            parts.append(
                " | in_gen: [" + ", ".join(str(b.generation) for b in self.input_buffers) + "]"
            )
        if self.output_buffers:
            parts.append(
                " | out_gen: [" + ", ".join(str(b.generation) for b in self.output_buffers) + "]"
            )
        parts.append(" }")
        return "".join(parts)


@dataclasses.dataclass
class CompiledSchedule:
    """The compiler's output: an ordered node list plus a buffer plan
    (schedule.rs:166-207).

    The reference also owns the flat ``Vec<f32>`` arena; here the arena is
    materialized by the executor as traced SSA values (or a device array for
    the megakernel path), so this object stays pure data.
    """

    schedule: list[ScheduledNode]
    num_buffers: int
    max_block_frames: int

    def __repr__(self):
        lines = ["CompiledSchedule {", "    schedule: {"]
        for n in self.schedule:
            lines.append(f"        {n!r}")
        lines.append("    }")
        lines.append(f"    num_buffers: {self.num_buffers}")
        lines.append(f"    max_block_frames: {self.max_block_frames}")
        lines.append("}")
        return "\n".join(lines)


class _BufferRef:
    """Allocator handle with a live-reference count (compiler.rs:81-97).

    The reference expresses sharing with ``Rc`` strong counts; ``count``
    tracks the same number explicitly.
    """

    __slots__ = ("idx", "generation", "count")

    def __init__(self, idx: int, generation: int):
        self.idx = idx
        self.generation = generation
        self.count = 1


class _BufferAllocator:
    """Greedy block-buffer allocator with free-list reuse
    (compiler.rs:92-136)."""

    def __init__(self):
        self._free: list[tuple[int, int]] = []  # (idx, generation)
        self.count = 0

    def acquire(self) -> _BufferRef:
        if self._free:
            idx, generation = self._free.pop()
        else:
            idx, generation = self.count, 0
            self.count += 1
        return _BufferRef(idx, generation)

    def release(self, ref: _BufferRef):
        if ref.count == 1:
            self._free.append((ref.idx, ref.generation + 1))
        else:
            ref.count -= 1


def _sort_topologically(
    nodes: Arena,
    graph_in_id: NodeID,
    graph_out_id: NodeID,
    build_schedule: bool,
) -> Optional[list[ScheduledNode]]:
    """Kahn's BFS (compiler.rs:232-300).  Returns None on a cycle."""
    in_degree = [0] * nodes.capacity
    for _, entry in nodes:
        for edge in entry.outgoing:
            in_degree[edge.dst_node.idx.slot] += 1

    queue: deque[int] = deque()
    # graph_in first so no other root can steal its buffers
    # (compiler.rs:249-252).
    queue.append(graph_in_id.idx.slot)
    for _, entry in nodes:
        if not entry.incoming and entry.id.idx.slot != graph_in_id.idx.slot:
            queue.append(entry.id.idx.slot)

    schedule: list[ScheduledNode] = []
    num_visited = 0
    while queue:
        slot = queue.popleft()
        num_visited += 1
        _, entry = nodes.get_by_slot(slot)
        for edge in entry.outgoing:
            dst_slot = edge.dst_node.idx.slot
            in_degree[dst_slot] -= 1
            if in_degree[dst_slot] == 0:
                queue.append(dst_slot)
        if build_schedule and slot != graph_out_id.idx.slot:
            schedule.append(ScheduledNode(entry.id))

    if build_schedule:
        # graph_out last so no leaf can overwrite its buffers
        # (compiler.rs:286-292).
        schedule.append(ScheduledNode(graph_out_id))

    if num_visited != len(nodes):
        return None
    return schedule


def _solve_buffer_requirements(
    nodes: Arena, schedule: list[ScheduledNode]
) -> int:
    """Greedy buffer assignment with fan-out sharing (compiler.rs:302-412).

    Returns the total number of buffers used.
    """
    allocator = _BufferAllocator()
    assignment_table: dict[EdgeID, _BufferRef] = {}

    for entry in schedule:
        node_entry = nodes.get(entry.id.idx)
        to_release: list[_BufferRef] = []

        for port_idx in range(node_entry.num_inputs):
            edges = [e for e in node_entry.incoming if e.dst_port == port_idx]
            if not edges:
                # Unconnected input: fresh buffer, must be cleared
                # (compiler.rs:339-349).
                ref = allocator.acquire()
                entry.input_buffers.append(
                    InBufferAssignment(ref.idx, True, ref.generation)
                )
                to_release.append(ref)
            elif len(edges) == 1:
                # Connected input: take the producer's buffer
                # (compiler.rs:350-362).
                ref = assignment_table.pop(edges[0].id, None)
                assert ref is not None, "No buffer assigned to edge!"
                entry.input_buffers.append(
                    InBufferAssignment(ref.idx, False, ref.generation)
                )
                to_release.append(ref)
            else:
                raise ManyToOneError(entry.id, port_idx)

        for port_idx in range(node_entry.num_outputs):
            edges = [e for e in node_entry.outgoing if e.src_port == port_idx]
            ref = allocator.acquire()
            entry.output_buffers.append(
                OutBufferAssignment(ref.idx, ref.generation)
            )
            if not edges:
                # Unconnected output: released right away
                # (compiler.rs:377-386).
                to_release.append(ref)
            else:
                # Fan-out: every edge shares the one buffer; it is freed when
                # the last consumer releases it (compiler.rs:387-399).
                for edge in edges:
                    assignment_table[edge.id] = ref
                    ref.count += 1
                ref.count -= 1  # the producer's own handle drops here

        for ref in to_release:
            allocator.release(ref)

    return allocator.count


def compile_graph(
    nodes: Arena,
    graph_in_id: NodeID,
    graph_out_id: NodeID,
    max_block_frames: int,
) -> CompiledSchedule:
    """Main compilation pipeline (compiler.rs:139-152).

    ``nodes`` must already have adjacency rebuilt (the graph layer's
    preprocess step).
    """
    schedule = _sort_topologically(nodes, graph_in_id, graph_out_id, True)
    if schedule is None:
        raise CompileCycleDetected()
    num_buffers = _solve_buffer_requirements(nodes, schedule)
    return CompiledSchedule(schedule, num_buffers, max_block_frames)


def cycle_detected(nodes: Arena, graph_in_id: NodeID, graph_out_id: NodeID) -> bool:
    """Standalone cycle check (compiler.rs:154-168)."""
    return _sort_topologically(nodes, graph_in_id, graph_out_id, False) is None
