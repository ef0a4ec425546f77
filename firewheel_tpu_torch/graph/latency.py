"""Automatic latency analysis and compensation (PDC).

Nodes that delay their signal path (a lookahead limiter's window, a
linear-phase FIR's group delay, an explicit alignment delay) declare it
through ``AudioNode.latency_frames(sample_rate)``.  When two paths with
different accumulated latency merge — a dry chain summed with a limited
chain, a parallel-compression bus — the un-delayed side arrives early and
the mix comb-filters.  Every DAW ships automatic plugin-delay compensation
for exactly this; this module is the graph-level pass:

* :func:`path_latencies` — accumulated latency arriving at each node
  (longest-path over the DAG, in frames);
* :func:`output_latency_frames` — total latency at ``graph_out`` (games
  use it to keep visuals/haptics in sync with the audible mix);
* :func:`compensate_latency` — splice :class:`~firewheel_tpu.nodes.delay.
  DelayCompNode` instances onto the early edges of every merge so all
  inputs of every node arrive aligned.  Idempotent: inserted delays
  report their own latency, so a second pass finds nothing to fix.

Beyond the reference's shipped code ("delay compensation" is listed and
unimplemented in its design scope, ``DESIGN_DOC.md:17-18``); the graph
surface it edits mirrors ``crates/firewheel-graph/src/graph.rs``.

The pass is a pure graph edit — it uses only the public mutation API
(``add_node`` / ``disconnect_by_edge_id`` / ``connect``), so it composes
with the live-edit machinery: run it on a RUNNING context and the next
``update()`` compiles the compensated schedule and hot-swaps it with
state migration, like any other batch of edits.
"""

from __future__ import annotations

import dataclasses

from .compiler import Edge, NodeID
from .errors import CycleDetected

__all__ = [
    "LatencyInsertion",
    "LatencyReport",
    "path_latencies",
    "output_latency_frames",
    "compensate_latency",
]


@dataclasses.dataclass(frozen=True)
class LatencyInsertion:
    """One spliced alignment delay: ``channels`` edges from ``src_node``
    to ``dst_node`` now route through ``delay_node`` (``frames`` deep)."""

    src_node: NodeID
    dst_node: NodeID
    delay_node: NodeID
    frames: int
    channels: int


@dataclasses.dataclass
class LatencyReport:
    """Result of :func:`compensate_latency`."""

    insertions: list[LatencyInsertion]
    output_latency_frames: int

    @property
    def total_inserted_frames(self) -> int:
        return sum(i.frames * i.channels for i in self.insertions)


def _node_latency(graph, node_id: NodeID, sample_rate: int) -> int:
    node = graph.node(node_id)
    if node is None:  # sentinel entries still resolve via graph.node()
        return 0
    lat = int(node.latency_frames(sample_rate))
    if lat < 0:
        raise ValueError(
            f"{node_id}: latency_frames must be >= 0, got {lat}"
        )
    return lat


def _topo_order(graph, edges_by_dst: dict) -> list[NodeID]:
    """Kahn's BFS over the current graph (compiler.rs:249-292 runs the
    same sort at compile time; this pass needs it pre-compile)."""
    indegree: dict[NodeID, int] = {}
    node_ids = [entry.id for entry in graph.nodes()]
    for nid in node_ids:
        indegree[nid] = len(edges_by_dst.get(nid, ()))
    ready = [nid for nid in node_ids if indegree[nid] == 0]
    out_adj: dict[NodeID, list[NodeID]] = {}
    for dst, es in edges_by_dst.items():
        for e in es:
            out_adj.setdefault(e.src_node, []).append(dst)
    order: list[NodeID] = []
    while ready:
        nid = ready.pop()
        order.append(nid)
        for dst in out_adj.get(nid, ()):
            indegree[dst] -= 1
            if indegree[dst] == 0:
                ready.append(dst)
    if len(order) != len(node_ids):
        raise CycleDetected()
    return order


def _edges_by_dst(graph) -> dict[NodeID, list[Edge]]:
    by_dst: dict[NodeID, list[Edge]] = {}
    for e in graph.edges():
        by_dst.setdefault(e.dst_node, []).append(e)
    return by_dst


def _arrivals(graph, sample_rate: int, edges_by_dst: dict) -> dict[NodeID, int]:
    """Longest-path accumulated latency arriving at each node's inputs."""
    arrival: dict[NodeID, int] = {}
    for nid in _topo_order(graph, edges_by_dst):
        es = edges_by_dst.get(nid, ())
        arrival[nid] = max(
            (
                arrival[e.src_node] + _node_latency(graph, e.src_node, sample_rate)
                for e in es
            ),
            default=0,
        )
    return arrival


def path_latencies(graph, sample_rate: int) -> dict[NodeID, int]:
    """Accumulated algorithmic latency (frames) arriving at each node.

    A node's own declared latency is NOT included in its entry — the value
    is what its *inputs* carry (sources and the graph_in sentinel read 0).
    """
    return _arrivals(graph, sample_rate, _edges_by_dst(graph))


def output_latency_frames(graph, sample_rate: int) -> int:
    """Total latency of the rendered mix at ``graph_out``, in frames."""
    arrival = path_latencies(graph, sample_rate)
    out_id = graph.graph_out_node()
    return arrival.get(out_id, 0) + _node_latency(graph, out_id, sample_rate)


def compensate_latency(graph, sample_rate: int) -> LatencyReport:
    """Align every merge point by splicing ``DelayCompNode``s onto the
    early edges.

    For each node whose in-edges carry different accumulated latencies,
    every edge arriving ``d`` frames early is routed through a fresh
    ``d``-frame :class:`~firewheel_tpu.nodes.delay.DelayCompNode`; edges
    from the same source node to the same destination share one
    (multi-channel) delay, so a stereo pair costs a single node.  Returns
    a :class:`LatencyReport`; run on a live graph, the next ``update()``
    hot-swaps the compensated schedule.
    """
    from ..nodes.delay import DelayCompNode

    edges_by_dst = _edges_by_dst(graph)
    arrival = _arrivals(graph, sample_rate, edges_by_dst)

    insertions: list[LatencyInsertion] = []
    for dst, es in edges_by_dst.items():
        if len(es) < 2:
            continue  # single-input nodes can't be misaligned
        lat_of = {
            e.id: arrival[e.src_node]
            + _node_latency(graph, e.src_node, sample_rate)
            for e in es
        }
        target = max(lat_of.values())
        # group early edges by source node: deficit is per-(src, dst)
        by_src: dict[NodeID, list[Edge]] = {}
        for e in es:
            if target - lat_of[e.id] > 0:
                by_src.setdefault(e.src_node, []).append(e)
        for src, early in by_src.items():
            deficit = target - lat_of[early[0].id]
            early.sort(key=lambda e: (e.src_port, e.dst_port))
            k = len(early)
            delay_id = graph.add_node(k, k, DelayCompNode(delay_frames=deficit))
            for i, e in enumerate(early):
                graph.disconnect_by_edge_id(e.id)
                graph.connect(e.src_node, e.src_port, delay_id, i)
                graph.connect(delay_id, i, e.dst_node, e.dst_port)
            insertions.append(
                LatencyInsertion(src, dst, delay_id, deficit, k)
            )

    return LatencyReport(
        insertions=insertions,
        output_latency_frames=output_latency_frames(graph, sample_rate),
    )
