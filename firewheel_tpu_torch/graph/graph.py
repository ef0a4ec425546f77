"""The mutable audio graph: nodes, edges, and the compile/activate lifecycle.

Mirrors ``crates/firewheel-graph/src/graph.rs:109-698``: an arena-backed DAG
with one-to-many connections, a one-edge-per-input-port rule, optional cycle
checking, a ``needs_compile`` dirty flag, and activation bookkeeping so node
processors (here: pure kernels + state pytrees) survive schedule swaps.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Iterator, Optional

from ..core.node import AudioNode, NodeActivationError, NodeProcessor, MAX_PORTS
from .arena import Arena
from .compiler import (
    CompiledSchedule,
    Edge,
    EdgeID,
    NodeEntry,
    NodeID,
    compile_graph,
    cycle_detected,
)
from .errors import (
    CycleDetected,
    DstNodeNotFound,
    EdgeAlreadyExists,
    InPortOutOfRange,
    InputPortAlreadyConnected,
    NodeActivationFailed,
    OutPortOutOfRange,
    SrcNodeNotFound,
)

log = logging.getLogger(__name__)

__all__ = ["AudioGraphConfig", "NodeWeight", "SchedulePackage", "AudioGraph"]


@dataclasses.dataclass(frozen=True)
class AudioGraphConfig:
    """Defaults mirror graph.rs:98-107."""

    num_graph_inputs: int = 0
    num_graph_outputs: int = 2
    initial_node_capacity: int = 64
    initial_edge_capacity: int = 256


@dataclasses.dataclass
class NodeWeight:
    """Per-node bookkeeping (graph.rs:76-80)."""

    node: AudioNode
    activated: bool = False
    updates: bool = False


@dataclasses.dataclass
class SchedulePackage:
    """Everything shipped to the executor on a schedule swap — the
    ``ScheduleHeapData`` analog (schedule.rs:128-150).

    ``new_node_processors`` carries freshly activated processors;
    ``nodes_to_remove`` names processors the executor must drop and whose
    state must not migrate; on return trip ``removed_node_processors`` is
    filled so deactivation happens off the hot path.
    """

    schedule: CompiledSchedule
    nodes_to_remove: list[NodeID]
    new_node_processors: list[tuple[NodeID, NodeProcessor]]
    removed_node_processors: list[tuple[NodeID, NodeProcessor]] = dataclasses.field(
        default_factory=list
    )


class _DummySentinel(AudioNode):
    """Placeholder node object for the graph_in/graph_out sentinels
    (graph.rs:133,146 use DummyAudioNode)."""

    debug_name = "dummy"

    def info(self):
        from ..core.node import AudioNodeInfo

        return AudioNodeInfo(
            num_max_supported_inputs=MAX_PORTS, num_max_supported_outputs=MAX_PORTS
        )

    def activate(self, sample_rate, max_block_frames, num_inputs, num_outputs):
        from ..nodes.dummy import DummyProcessor

        return DummyProcessor(sample_rate, max_block_frames, num_inputs, num_outputs)


class _ArenaView:
    """Read-only arena facade hiding a set of slots from iteration/len —
    how the pruning pass feeds the compiler a subgraph without cloning
    the arena (NodeIDs must stay stable for state migration)."""

    __slots__ = ("_arena", "_hidden")

    def __init__(self, arena: Arena, hidden_slots: frozenset):
        self._arena = arena
        self._hidden = hidden_slots

    def __iter__(self):
        return (
            (idx, entry)
            for idx, entry in self._arena
            if entry.id.idx.slot not in self._hidden
        )

    def __len__(self) -> int:
        return len(self._arena) - len(self._hidden)

    @property
    def capacity(self) -> int:
        return self._arena.capacity

    def get(self, index):
        return self._arena.get(index)

    def get_by_slot(self, slot: int):
        return self._arena.get_by_slot(slot)


class AudioGraph:
    """User-mutable DAG compiled into :class:`CompiledSchedule`\\ s."""

    def __init__(self, config: AudioGraphConfig = AudioGraphConfig()):
        self._nodes: Arena = Arena()
        self._edges: Arena = Arena()
        self._connected_input_ports: set[tuple[NodeID, int]] = set()
        self._existing_edges: dict[tuple, EdgeID] = {}

        # graph_in / graph_out sentinels (graph.rs:128-154).
        in_entry = NodeEntry(
            NodeID.DANGLING, 0, config.num_graph_inputs, NodeWeight(_DummySentinel())
        )
        self._graph_in_id = NodeID(self._nodes.insert(in_entry), "graph_in")
        in_entry.id = self._graph_in_id

        out_entry = NodeEntry(
            NodeID.DANGLING, config.num_graph_outputs, 0, NodeWeight(_DummySentinel())
        )
        self._graph_out_id = NodeID(self._nodes.insert(out_entry), "graph_out")
        out_entry.id = self._graph_out_id

        self._needs_compile = True
        self._nodes_to_remove_from_schedule: list[NodeID] = []
        self._nodes_to_activate: list[NodeID] = [self._graph_in_id, self._graph_out_id]
        self._active_nodes_to_remove: dict[NodeID, NodeEntry] = {}

        #: opt-in compile-time pruning: dormant nodes (``AudioNode.
        #: is_dormant``) and silence-transparent subgraphs fed only by them
        #: are dropped from the compiled schedule — the static counterpart
        #: of the reference's per-block silence skipping (volume.rs:94-100).
        #: Re-enable via ``notify_dormancy_changed()``; parked state
        #: resumes frozen (processor.py keeps it host-side).
        self.prune_dormant = False

    def notify_dormancy_changed(self) -> None:
        """Mark the graph dirty after toggling a node's dormancy (e.g.
        ``BeepTestNode.set_enabled``) so the next ``update()`` recompiles —
        with ``prune_dormant`` set this is the recompile-on-enable hook."""
        self._needs_compile = True

    # -- introspection -------------------------------------------------------
    def graph_in_node(self) -> NodeID:
        return self._graph_in_id

    def graph_out_node(self) -> NodeID:
        return self._graph_out_id

    def node(self, node_id: NodeID) -> Optional[AudioNode]:
        entry = self._nodes.get(node_id.idx)
        return entry.weight.node if entry else None

    # alias with the reference's mutable-accessor name (graph.rs:245)
    node_mut = node

    def node_info(self, node_id: NodeID) -> Optional[NodeEntry]:
        return self._nodes.get(node_id.idx)

    def nodes(self) -> Iterator[NodeEntry]:
        for _, entry in self._nodes:
            yield entry

    def edges(self) -> Iterator[Edge]:
        for _, edge in self._edges:
            yield edge

    def edge(self, edge_id: EdgeID) -> Optional[Edge]:
        return self._edges.get(edge_id.idx)

    @property
    def current_node_capacity(self) -> int:
        return self._nodes.capacity

    def needs_compile(self) -> bool:
        return self._needs_compile

    # -- mutation ------------------------------------------------------------
    def add_node(
        self, num_inputs: int, num_outputs: int, node: AudioNode
    ) -> NodeID:
        """Insert a node (graph.rs:201-231)."""
        # a real exception, not an assert: the 64-bit SilenceMask machinery
        # silently mishandles wider nodes, and asserts vanish under -O
        if not (0 <= num_inputs <= MAX_PORTS and 0 <= num_outputs <= MAX_PORTS):
            raise ValueError(
                f"port counts ({num_inputs}, {num_outputs}) outside "
                f"[0, {MAX_PORTS}] (the SilenceMask width, node.rs:62)"
            )
        info = node.info()
        entry = NodeEntry(
            NodeID.DANGLING,
            num_inputs,
            num_outputs,
            NodeWeight(node, activated=False, updates=info.updates),
        )
        new_id = NodeID(self._nodes.insert(entry), node.debug_name)
        entry.id = new_id
        self._nodes_to_activate.append(new_id)
        self._needs_compile = True
        return new_id

    def remove_node(self, node_id: NodeID) -> list[EdgeID]:
        """Remove a node and all its edges (graph.rs:268-299).

        Raises ``ValueError`` for missing nodes or the graph in/out
        sentinels (the reference returns ``Err(())``).
        """
        if node_id == self._graph_in_id or node_id == self._graph_out_id:
            raise ValueError("cannot remove the graph in/out node")
        entry = self._nodes.remove(node_id.idx)
        if entry is None:
            raise ValueError(f"node {node_id} not found")

        removed: list[EdgeID] = []
        for port_idx in range(entry.num_inputs):
            removed += self._remove_edges_with_input_port(node_id, port_idx)
        for port_idx in range(entry.num_outputs):
            removed += self._remove_edges_with_output_port(node_id, port_idx)
        for port_idx in range(entry.num_inputs):
            self._connected_input_ports.discard((node_id, port_idx))

        self._nodes_to_remove_from_schedule.append(node_id)
        if entry.weight.activated:
            self._active_nodes_to_remove[node_id] = entry
        self._needs_compile = True
        return removed

    def reset(self):
        """Remove all non-sentinel nodes (graph.rs:171-182)."""
        for node_id in [
            e.id
            for e in self.nodes()
            if e.id not in (self._graph_in_id, self._graph_out_id)
        ]:
            self.remove_node(node_id)

    def set_num_inputs(self, node_id: NodeID, num_inputs: int) -> list[EdgeID]:
        """Resize a node's input ports (graph.rs:315-343)."""
        if node_id == self._graph_in_id:
            raise ValueError("cannot set inputs of the graph in node")
        if not 0 <= num_inputs <= MAX_PORTS:
            raise ValueError(
                f"num_inputs {num_inputs} outside [0, {MAX_PORTS}] "
                "(the SilenceMask width, node.rs:62)"
            )
        entry = self._nodes.get(node_id.idx)
        if entry is None:
            raise ValueError(f"node {node_id} not found")
        removed: list[EdgeID] = []
        if num_inputs < entry.num_inputs:
            for port_idx in range(num_inputs, entry.num_inputs):
                removed += self._remove_edges_with_input_port(node_id, port_idx)
                self._connected_input_ports.discard((node_id, port_idx))
        entry.num_inputs = num_inputs
        self._needs_compile = True
        return removed

    def set_num_outputs(self, node_id: NodeID, num_outputs: int) -> list[EdgeID]:
        """Resize a node's output ports (graph.rs:349-375)."""
        if node_id == self._graph_out_id:
            raise ValueError("cannot set outputs of the graph out node")
        if not 0 <= num_outputs <= MAX_PORTS:
            raise ValueError(
                f"num_outputs {num_outputs} outside [0, {MAX_PORTS}] "
                "(the SilenceMask width, node.rs:62)"
            )
        entry = self._nodes.get(node_id.idx)
        if entry is None:
            raise ValueError(f"node {node_id} not found")
        removed: list[EdgeID] = []
        if num_outputs < entry.num_outputs:
            for port_idx in range(num_outputs, entry.num_outputs):
                removed += self._remove_edges_with_output_port(node_id, port_idx)
        entry.num_outputs = num_outputs
        self._needs_compile = True
        return removed

    def connect(
        self,
        src_node: NodeID,
        src_port: int,
        dst_node: NodeID,
        dst_port: int,
        check_for_cycles: bool = False,
    ) -> EdgeID:
        """Add an edge, validating ports / duplicates / one-edge-per-input
        (graph.rs:396-477).  Raises an :class:`AddEdgeError` variant."""
        src_entry = self._nodes.get(src_node.idx)
        if src_entry is None:
            raise SrcNodeNotFound(src_node)
        dst_entry = self._nodes.get(dst_node.idx)
        if dst_entry is None:
            raise DstNodeNotFound(dst_node)
        # both bounds: a negative index (Python's "last port" idiom) would
        # pass the upper check, then crash buffer allocation at compile —
        # or silently route nowhere
        if not 0 <= src_port < src_entry.num_outputs:
            raise OutPortOutOfRange(src_node, src_port, src_entry.num_outputs)
        if not 0 <= dst_port < dst_entry.num_inputs:
            raise InPortOutOfRange(dst_node, dst_port, dst_entry.num_inputs)
        if src_node.idx == dst_node.idx:
            raise CycleDetected()

        key = (src_node, src_port, dst_node, dst_port)
        if key in self._existing_edges:
            raise EdgeAlreadyExists()
        if (dst_node, dst_port) in self._connected_input_ports:
            raise InputPortAlreadyConnected(dst_node, dst_port)
        self._connected_input_ports.add((dst_node, dst_port))

        edge = Edge(EdgeID(None), src_node, src_port, dst_node, dst_port)
        idx = self._edges.insert(edge)
        edge = dataclasses.replace(edge, id=EdgeID(idx))
        # replace the arena payload with the id-carrying edge
        self._edges._items[idx.slot] = edge
        self._existing_edges[key] = edge.id

        if check_for_cycles and self.cycle_detected():
            self._edges.remove(idx)
            del self._existing_edges[key]
            self._connected_input_ports.discard((dst_node, dst_port))
            raise CycleDetected()

        self._needs_compile = True
        return edge.id

    def disconnect(
        self, src_node: NodeID, src_port: int, dst_node: NodeID, dst_port: int
    ) -> bool:
        """Remove an edge by endpoints (graph.rs:483-501)."""
        edge_id = self._existing_edges.get((src_node, src_port, dst_node, dst_port))
        if edge_id is None:
            return False
        return self.disconnect_by_edge_id(edge_id)

    def disconnect_by_edge_id(self, edge_id: EdgeID) -> bool:
        """Remove an edge by ID (graph.rs:507-524)."""
        edge = self._edges.remove(edge_id.idx)
        if edge is None:
            return False
        self._existing_edges.pop(
            (edge.src_node, edge.src_port, edge.dst_node, edge.dst_port), None
        )
        self._connected_input_ports.discard((edge.dst_node, edge.dst_port))
        self._needs_compile = True
        return True

    def _remove_edges_with_input_port(self, node_id: NodeID, port_idx: int):
        to_remove = [
            e.id
            for _, e in self._edges
            if e.dst_node == node_id and e.dst_port == port_idx
        ]
        for eid in to_remove:
            self.disconnect_by_edge_id(eid)
        return to_remove

    def _remove_edges_with_output_port(self, node_id: NodeID, port_idx: int):
        to_remove = [
            e.id
            for _, e in self._edges
            if e.src_node == node_id and e.src_port == port_idx
        ]
        for eid in to_remove:
            self.disconnect_by_edge_id(eid)
        return to_remove

    # -- compilation ---------------------------------------------------------
    def _preprocess(self, exclude_slots: frozenset = frozenset()):
        """Rebuild adjacency (compiler.rs:191-228), optionally dropping
        every edge touching an excluded node (the pruning pass)."""
        for _, entry in self._nodes:
            assert entry.num_inputs <= MAX_PORTS
            assert entry.num_outputs <= MAX_PORTS
            entry.incoming.clear()
            entry.outgoing.clear()
        for _, edge in self._edges:
            if (
                edge.src_node.idx.slot in exclude_slots
                or edge.dst_node.idx.slot in exclude_slots
            ):
                continue
            self._nodes.get(edge.src_node.idx).outgoing.append(edge)
            self._nodes.get(edge.dst_node.idx).incoming.append(edge)

    def _dormant_pruned_slots(self) -> frozenset:
        """Arena slots dropped by the dormancy pruning pass: nodes whose
        ``is_dormant()`` is True, then (to a fixed point) every
        ``silence_transparent`` node all of whose connected inputs come
        from pruned nodes.  Requires ``_preprocess()`` adjacency."""
        sentinels = {self._graph_in_id.idx.slot, self._graph_out_id.idx.slot}
        pruned: set[int] = set()
        for _, entry in self._nodes:
            slot = entry.id.idx.slot
            if slot in sentinels:
                continue
            try:
                dormant = bool(entry.weight.node.is_dormant())
            except Exception:  # a user node with a broken hook must not
                dormant = False  # take compilation down
            if dormant:
                pruned.add(slot)
        changed = True
        while changed:
            changed = False
            for _, entry in self._nodes:
                slot = entry.id.idx.slot
                if slot in pruned or slot in sentinels:
                    continue
                if not getattr(
                    entry.weight.node, "silence_transparent", False
                ):
                    continue
                if all(
                    e.src_node.idx.slot in pruned for e in entry.incoming
                ):
                    # every *connected* input (possibly none) feeds from a
                    # pruned node — this node can only emit silence
                    pruned.add(slot)
                    changed = True
        return frozenset(pruned)

    def cycle_detected(self) -> bool:
        self._preprocess()
        return cycle_detected(self._nodes, self._graph_in_id, self._graph_out_id)

    # -- latency (PDC) ---------------------------------------------------
    def path_latencies(self, sample_rate: int):
        """Accumulated algorithmic latency (frames) arriving at each node
        — see :mod:`firewheel_tpu.graph.latency`."""
        from .latency import path_latencies

        return path_latencies(self, sample_rate)

    def output_latency_frames(self, sample_rate: int) -> int:
        """Total latency of the mix at ``graph_out`` (sync visuals to it)."""
        from .latency import output_latency_frames

        return output_latency_frames(self, sample_rate)

    def compensate_latency(self, sample_rate: int):
        """Splice alignment delays so every merge's inputs arrive
        phase-aligned (automatic PDC); returns a
        :class:`~firewheel_tpu.graph.latency.LatencyReport`.  Idempotent;
        safe on a live graph (the next ``update()`` hot-swaps)."""
        from .latency import compensate_latency

        return compensate_latency(self, sample_rate)

    def compile_internal(self, max_block_frames: int) -> CompiledSchedule:
        """Compile without activating nodes — the pure data transformation
        the reference unit-tests against (graph.rs:629-642)."""
        assert max_block_frames > 0
        self._preprocess()
        nodes = self._nodes
        if self.prune_dormant:
            pruned = self._dormant_pruned_slots()
            if pruned:
                self._preprocess(exclude_slots=pruned)
                nodes = _ArenaView(self._nodes, pruned)
        return compile_graph(
            nodes, self._graph_in_id, self._graph_out_id, max_block_frames
        )

    def compile(
        self, sample_rate: int, max_block_frames: int
    ) -> SchedulePackage:
        """Compile and activate pending nodes, with rollback on failure
        (graph.rs:586-627)."""
        schedule = self.compile_internal(max_block_frames)

        new_processors: list[tuple[NodeID, NodeProcessor]] = []
        for node_id in self._nodes_to_activate:
            entry = self._nodes.get(node_id.idx)
            if entry is None:
                continue
            try:
                processor = entry.weight.node.activate(
                    sample_rate,
                    max_block_frames,
                    entry.num_inputs,
                    entry.num_outputs,
                )
            except Exception as e:
                # ANY failure in a user activate() hook (not just the
                # declared NodeActivationError) must roll back the already-
                # activated processors — otherwise a plain bug in one node
                # leaves earlier nodes activated with orphaned processors
                # and every later update() re-raises
                for n_id, proc in new_processors:
                    rolled = self._nodes.get(n_id.idx)
                    rolled.weight.node.deactivate(proc)
                    rolled.weight.activated = False
                raise NodeActivationFailed(node_id, e) from e
            entry.weight.activated = True
            new_processors.append((node_id, processor))

        package = SchedulePackage(
            schedule, list(self._nodes_to_remove_from_schedule), new_processors
        )
        self._needs_compile = False
        self._nodes_to_activate.clear()
        self._nodes_to_remove_from_schedule.clear()
        log.debug("compiled new audio graph: %r", package.schedule)
        return package

    # -- activation lifecycle (graph.rs:644-697) ------------------------------
    def on_schedule_returned(self, package: SchedulePackage):
        for node_id, processor in package.removed_node_processors:
            entry = self._active_nodes_to_remove.pop(node_id, None)
            if entry is not None:
                entry.weight.node.deactivate(processor)
                entry.weight.activated = False
                continue
            entry = self._nodes.get(node_id.idx)
            if entry is not None and entry.weight.activated:
                entry.weight.node.deactivate(processor)
                entry.weight.activated = False
                self._nodes_to_activate.append(node_id)
        package.removed_node_processors.clear()

    def on_processor_dropped(self, processors: dict[NodeID, NodeProcessor]):
        for node_id, processor in processors.items():
            entry = self._nodes.get(node_id.idx)
            if entry is not None and entry.weight.activated:
                entry.weight.node.deactivate(processor)
                entry.weight.activated = False

    def deactivate(self):
        self._active_nodes_to_remove.clear()
        self._nodes_to_remove_from_schedule.clear()
        self._needs_compile = True
        self._nodes_to_activate.clear()
        for idx, entry in self._nodes:
            if entry.weight.activated:
                entry.weight.node.deactivate(None)
                entry.weight.activated = False
            # requeue under the entry's ORIGINAL id: NodeID equality ignores
            # the debug name but node_key (= repr) does not, and the
            # sentinels' ids are named graph_in/graph_out while their node
            # object is a Dummy — renaming them here would desync the
            # processor's state keys from the schedule's
            self._nodes_to_activate.append(entry.id)

    def update(self):
        for _, entry in self._nodes:
            if entry.weight.updates:
                entry.weight.node.update()
