"""Graph error taxonomy.

Mirrors ``crates/firewheel-graph/src/graph/error.rs`` — the reference returns
``Result``s; here each variant is an exception class so ``connect``/``compile``
raise idiomatically while tests can still match on the exact variant.
"""

from __future__ import annotations

__all__ = [
    "AddEdgeError",
    "SrcNodeNotFound",
    "DstNodeNotFound",
    "InPortOutOfRange",
    "OutPortOutOfRange",
    "EdgeAlreadyExists",
    "InputPortAlreadyConnected",
    "CycleDetected",
    "CompileGraphError",
    "CompileCycleDetected",
    "ManyToOneError",
    "NodeActivationFailed",
    "MessageChannelFull",
]


class AddEdgeError(Exception):
    """Base for errors adding an edge (error.rs:14-38)."""


class SrcNodeNotFound(AddEdgeError):
    def __init__(self, node_id):
        self.node_id = node_id
        super().__init__(f"could not find source node with ID {node_id}")


class DstNodeNotFound(AddEdgeError):
    def __init__(self, node_id):
        self.node_id = node_id
        super().__init__(f"could not find destination node with ID {node_id}")


class InPortOutOfRange(AddEdgeError):
    def __init__(self, node, port_idx, num_in_ports):
        self.node, self.port_idx, self.num_in_ports = node, port_idx, num_in_ports
        super().__init__(
            f"input port idx {port_idx} is out of range on node {node} "
            f"with {num_in_ports} input ports"
        )


class OutPortOutOfRange(AddEdgeError):
    def __init__(self, node, port_idx, num_out_ports):
        self.node, self.port_idx, self.num_out_ports = node, port_idx, num_out_ports
        super().__init__(
            f"output port idx {port_idx} is out of range on node {node} "
            f"with {num_out_ports} output ports"
        )


class EdgeAlreadyExists(AddEdgeError):
    def __init__(self):
        super().__init__("edge already exists in the graph")


class InputPortAlreadyConnected(AddEdgeError):
    """One-edge-per-input-port rule (graph.rs:444-446)."""

    def __init__(self, node_id, port_idx):
        self.node_id, self.port_idx = node_id, port_idx
        super().__init__(
            f"input port {port_idx} on node {node_id} is already connected"
        )


class CycleDetected(AddEdgeError):
    def __init__(self):
        super().__init__("cycle was detected")


class CompileGraphError(Exception):
    """Base for graph-compilation errors (error.rs:100-116)."""


class CompileCycleDetected(CompileGraphError):
    def __init__(self):
        super().__init__("a cycle was detected")


class ManyToOneError(CompileGraphError):
    def __init__(self, node_id, port_idx):
        self.node_id, self.port_idx = node_id, port_idx
        super().__init__(
            f"multiple edges go to input port {port_idx} on node {node_id}"
        )


class NodeActivationFailed(CompileGraphError):
    def __init__(self, node_id, error):
        self.node_id, self.error = node_id, error
        super().__init__(f"node {node_id} failed to activate: {error}")


class MessageChannelFull(CompileGraphError):
    def __init__(self):
        super().__init__("message channel is full")
