"""The DAG model, its compiler (the ``firewheel-graph`` analog) and the
latency-compensation pass and the scene files (``serialize``), copied from
``firewheel_tpu/graph``."""

from .arena import Arena, Index
from .compiler import (
    CompiledSchedule,
    Edge,
    EdgeID,
    InBufferAssignment,
    NodeEntry,
    NodeID,
    OutBufferAssignment,
    ScheduledNode,
    compile_graph,
    cycle_detected,
)
from .errors import (
    AddEdgeError,
    CompileCycleDetected,
    CompileGraphError,
    CycleDetected,
    DstNodeNotFound,
    EdgeAlreadyExists,
    InPortOutOfRange,
    InputPortAlreadyConnected,
    ManyToOneError,
    MessageChannelFull,
    NodeActivationFailed,
    OutPortOutOfRange,
    SrcNodeNotFound,
)
from .graph import AudioGraph, AudioGraphConfig, NodeWeight, SchedulePackage
from .latency import (
    LatencyInsertion,
    LatencyReport,
    compensate_latency,
    output_latency_frames,
    path_latencies,
)

__all__ = [
    "Arena",
    "Index",
    "CompiledSchedule",
    "Edge",
    "EdgeID",
    "InBufferAssignment",
    "NodeEntry",
    "NodeID",
    "OutBufferAssignment",
    "ScheduledNode",
    "compile_graph",
    "cycle_detected",
    "AddEdgeError",
    "CompileCycleDetected",
    "CompileGraphError",
    "CycleDetected",
    "DstNodeNotFound",
    "EdgeAlreadyExists",
    "InPortOutOfRange",
    "InputPortAlreadyConnected",
    "ManyToOneError",
    "MessageChannelFull",
    "NodeActivationFailed",
    "OutPortOutOfRange",
    "SrcNodeNotFound",
    "AudioGraph",
    "AudioGraphConfig",
    "NodeWeight",
    "SchedulePackage",
    "LatencyInsertion",
    "LatencyReport",
    "compensate_latency",
    "output_latency_frames",
    "path_latencies",
]

from .serialize import SCENE_VERSION, load_graph, register_node_class, save_graph  # noqa: E402

__all__ += ["SCENE_VERSION", "load_graph", "register_node_class", "save_graph"]
