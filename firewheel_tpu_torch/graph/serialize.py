"""Scene files: save/load an AudioGraph (topology + node configs).

Beyond-reference engine surface (the reference keeps graphs purely
in-memory): a graph — its node set with configuration, port counts, and
edges — serializes to a single ``.npz`` scene file (JSON structure +
raw arrays for IRs/taps/samples) and reloads into a fresh, compilable
``AudioGraph``.  Use cases: editor save files, fleet bring-up from a
scene catalog, golden-scene regression fixtures.

Serialized per node: the *configuration* (everything a fresh
``add_node`` needs — the attrs behind the constructor and the live
setters).  NOT serialized: transient control state (playing flags, seek
sequence numbers) and recurrent DSP state — for sample-exact state
snapshots of a RUNNING engine use ``checkpoint.py``, which composes with
this module (scene file = topology, checkpoint = state).

``StreamingSamplerNode`` readers are host resources (file handles,
callbacks); the node's config round-trips but the reader must be
re-attached after load (``set_reader``) — the scene stores
``reader_path`` when the reader exposes one (``WavStreamReader``) and
re-opens it automatically.

Round-trip contract (tested): ``load_graph(save_graph(g))`` compiles to
a schedule that renders bit-identically to the original graph's.
"""

from __future__ import annotations

import json
from typing import Any

import numpy as np

from ..core.sample_resource import SampleResource
from .graph import AudioGraph, AudioGraphConfig

__all__ = ["save_graph", "load_graph", "register_node_class", "SCENE_VERSION"]

SCENE_VERSION = 1


# --------------------------------------------------------------------------
# Per-class specs: scalar attrs copied verbatim + array attrs stored in the
# npz payload.  A node class absent here raises at save time (loudly, not a
# half-saved scene).
# --------------------------------------------------------------------------

_SCALAR_ATTRS: dict[str, list[str]] = {
    "DummyAudioNode": [],
    "BeepTestNode": ["freq_hz", "gain", "_enabled"],
    "VolumeNode": ["_percent_volume", "_raw_gain"],
    "SumNode": [],
    "HardClipNode": ["threshold_gain"],
    "MonoToStereoNode": [],
    "StereoToMonoNode": [],
    "StereoPanNode": ["_pan"],
    "PitchShiftNode": ["_semitones", "_mix", "window_secs"],
    "StereoWidthNode": ["_width"],
    "FilterNode": ["filter_type", "backend", "_freq", "_q", "_gain_db"],
    "DelayCompNode": ["_delay_frames", "_delay_secs"],
    "EchoNode": ["_delay_secs", "_feedback", "_wet", "_dry"],
    "ConvolutionReverbNode": ["method", "_wet", "_dry"],
    "FirFilterNode": ["_gain", "_report_latency"],
    "Spatializer3DNode": [
        "_position", "volume_gain", "ref_distance", "rolloff",
        "doppler", "speed_of_sound", "max_distance_m", "motion_smooth_secs",
    ],
    "BinauralSpatializerNode": [
        "_position", "volume_gain", "ref_distance", "rolloff", "head_radius",
    ],
    "DbMeterNode": [],
    "LoudnessMeterNode": ["_channel_weights"],
    "CompressorNode": [
        "_threshold_db", "_ratio", "_attack_secs", "_release_secs",
        "_makeup_db", "_knee_db",
    ],
    "LimiterNode": ["_ceiling_db", "_lookahead_secs", "_release_secs"],
    "DuckerNode": ["_threshold_db", "_duck_db", "_attack_secs", "_release_secs"],
    "GateNode": [
        "_threshold_db", "_range_db", "_attack_secs", "_release_secs",
        "_hold_secs", "_hysteresis_db",
    ],
    "NoiseNode": ["_color", "_gain_db", "_enabled", "_seed"],
    "LFONode": ["_shape", "_freq_hz", "_depth", "_offset"],
    "SamplerNode": [
        "quality", "poolable", "_percent_volume", "_raw_gain", "_rate",
        "_attack_secs", "_release_secs",
    ],
    # structural grain config + live tempo/pitch; transient control
    # state (playing/seek/play seqs) is excluded per the module contract
    "GranularSamplerNode": [
        "grain_frames", "overlap", "align",
        "_percent_volume", "_raw_gain", "_tempo", "_pitch_rate",
    ],
    "StreamingSamplerNode": [
        "_percent_volume", "_raw_gain", "_window_secs", "_rate",
    ],
    # silence_transparent is derived (= not dc_block) — re-derived on
    # load, never stored, so a future derivation change wins over scenes
    "WaveshaperNode": [
        "curve", "_drive_db", "_output_db", "_mix", "_dc_block",
    ],
    # bands ride in `extra` (a list of dataclasses, not flat scalars)
    "ParametricEQNode": [],
    "ModDelayNode": [
        "_rate_hz", "_base_delay_secs", "_depth_secs", "_mix",
        "_phase_spread", "_fb_mode", "_feedback", "_max_delay_secs",
    ],
    "TremoloNode": ["_rate_hz", "_depth", "_phase_spread", "_bipolar"],
}

_ARRAY_ATTRS: dict[str, list[str]] = {
    "ConvolutionReverbNode": ["_ir"],
    "FirFilterNode": ["_taps"],
}

# Minimal valid constructor call per class (attrs are overwritten after).
_CTOR_ARGS: dict[str, tuple] = {
    "BeepTestNode": (440.0, -12.0),
    "VolumeNode": (100.0,),
    "HardClipNode": (0.0,),
    "ConvolutionReverbNode": (np.zeros(1, np.float32),),
    "FirFilterNode": (np.zeros(3, np.float32),),
}


# Third-party node classes registered at runtime (register_node_class).
_EXTRA_CLASSES: dict[str, type] = {}


def register_node_class(
    cls: type,
    scalar_attrs: "list[str]",
    array_attrs: "list[str] | None" = None,
    ctor_args: tuple = (),
) -> None:
    """Make a custom node class scene-file serializable.

    ``scalar_attrs``: JSON-able attributes copied verbatim on save/load;
    ``array_attrs``: numpy-array attributes stored in the npz payload;
    ``ctor_args``: a minimal valid constructor call (attrs are
    overwritten after construction).  See docs/EXTENDING.md.
    """
    name = cls.__name__
    _EXTRA_CLASSES[name] = cls
    _SCALAR_ATTRS[name] = list(scalar_attrs)
    if array_attrs:
        _ARRAY_ATTRS[name] = list(array_attrs)
    if ctor_args:
        _CTOR_ARGS[name] = tuple(ctor_args)


def _node_registry() -> dict[str, type]:
    from .. import nodes as _n

    reg: dict[str, type] = dict(_EXTRA_CLASSES)
    for name in _SCALAR_ATTRS:
        if name in reg:
            continue
        cls = getattr(_n, name, None)
        if cls is None and name == "DummyAudioNode":
            from ..nodes.dummy import DummyAudioNode as cls  # noqa: N813
        assert cls is not None, f"registry class {name} not importable"
        reg[name] = cls
    return reg


def _jsonable(v: Any):
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    if isinstance(v, tuple):
        return list(v)
    return v


def save_graph(graph: AudioGraph, path: str) -> None:
    """Serialize ``graph`` (topology + node configs) to an ``.npz`` scene.

    Raises ``TypeError`` for node classes without a serialization spec
    (custom third-party nodes: extend ``_SCALAR_ATTRS``/``_ARRAY_ATTRS``).
    """
    arrays: dict[str, np.ndarray] = {}
    node_rows = []
    gin, gout = graph.graph_in_node(), graph.graph_out_node()

    for entry in graph.nodes():
        if entry.id in (gin, gout):
            continue
        node = entry.weight.node
        cls_name = type(node).__name__
        if cls_name not in _SCALAR_ATTRS:
            raise TypeError(
                f"no serialization spec for node class {cls_name!r}; "
                "register it in graph/serialize.py"
            )
        key = f"{entry.id.debug_name}-{entry.id.idx.slot}-{entry.id.idx.generation}"
        cfg = {
            a: _jsonable(getattr(node, a)) for a in _SCALAR_ATTRS[cls_name]
        }
        tuple_attrs = [
            a for a in _SCALAR_ATTRS[cls_name]
            if isinstance(getattr(node, a), tuple)
        ]
        for a in _ARRAY_ATTRS.get(cls_name, ()):
            arrays[f"{key}:{a}"] = np.asarray(getattr(node, a))
        extra: dict[str, Any] = {}
        if cls_name == "SamplerNode":
            smp = node._sample
            if smp is not None:
                arrays[f"{key}:sample"] = np.asarray(smp.data)
                extra["sample_rate"] = smp.sample_rate
                extra["has_sample"] = True
            loop = node._loop
            if loop is not None:
                extra["loop"] = [loop.start_secs, loop.end_secs, loop.full]
        if cls_name == "GranularSamplerNode":
            smp = node._sample
            if smp is not None:
                arrays[f"{key}:sample"] = np.asarray(smp.data)
                extra["sample_rate"] = smp.sample_rate
                extra["has_sample"] = True
        if cls_name == "StreamingSamplerNode":
            reader = node._reader
            reader_path = getattr(reader, "path", None)
            if reader_path:
                extra["reader_path"] = str(reader_path)
        if cls_name == "ParametricEQNode":
            extra["bands"] = [
                [b.band_type, b.frequency_hz, b.q, b.gain_db, b.enabled]
                for b in node._bands
            ]
        node_rows.append({
            "key": key,
            "cls": cls_name,
            "num_inputs": entry.num_inputs,
            "num_outputs": entry.num_outputs,
            "cfg": cfg,
            "tuple_attrs": tuple_attrs,
            "extra": extra,
        })

    def edge_key(nid):
        if nid == gin:
            return "graph_in"
        if nid == gout:
            return "graph_out"
        return f"{nid.debug_name}-{nid.idx.slot}-{nid.idx.generation}"

    edges = [
        [edge_key(e.src_node), e.src_port, edge_key(e.dst_node), e.dst_port]
        for e in graph.edges()
    ]

    scene = {
        "version": SCENE_VERSION,
        "num_graph_inputs": graph.node_info(gin).num_outputs,
        "num_graph_outputs": graph.node_info(gout).num_inputs,
        "nodes": node_rows,
        "edges": edges,
    }
    arrays["__scene__"] = np.frombuffer(
        json.dumps(scene).encode(), np.uint8
    )
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_graph(path: str) -> "tuple[AudioGraph, dict]":
    """Load a scene file → ``(graph, node_ids)`` where ``node_ids`` maps
    the saved node keys to the fresh graph's ``NodeID``s (look up live
    node handles via ``graph.node(node_ids[key])``)."""
    data = np.load(path)
    scene = json.loads(bytes(data["__scene__"]).decode())
    if scene["version"] > SCENE_VERSION:
        raise ValueError(
            f"scene version {scene['version']} is newer than this engine "
            f"(supports <= {SCENE_VERSION})"
        )
    reg = _node_registry()

    g = AudioGraph(AudioGraphConfig(
        num_graph_inputs=scene["num_graph_inputs"],
        num_graph_outputs=scene["num_graph_outputs"],
    ))
    ids: dict[str, Any] = {
        "graph_in": g.graph_in_node(), "graph_out": g.graph_out_node(),
    }
    for row in scene["nodes"]:
        cls = reg[row["cls"]]
        node = cls(*_CTOR_ARGS.get(row["cls"], ()))
        for a in _ARRAY_ATTRS.get(row["cls"], ()):
            setattr(node, a, np.array(data[f"{row['key']}:{a}"]))
        tuple_attrs = set(row.get("tuple_attrs", ()))
        for a, v in row["cfg"].items():
            # JSON flattens tuples to lists; restore recorded tuple attrs
            # (group_key hashing and position handling rely on tuples)
            if a in tuple_attrs:
                v = tuple(v)
            setattr(node, a, v)
        extra = row.get("extra", {})
        if row["cls"] == "SamplerNode":
            if extra.get("has_sample"):
                node.set_sample(SampleResource(
                    np.array(data[f"{row['key']}:sample"]),
                    sample_rate=extra.get("sample_rate"),
                ))
            if "loop" in extra:
                from ..nodes.sampler import LoopRange

                s, e, full = extra["loop"]
                node.set_loop_range(
                    LoopRange.FULL if full else LoopRange.range_secs(s, e)
                )
        if row["cls"] == "GranularSamplerNode" and extra.get("has_sample"):
            node.set_sample(SampleResource(
                np.array(data[f"{row['key']}:sample"]),
                sample_rate=extra.get("sample_rate"),
            ))
        if row["cls"] == "ParametricEQNode":
            from ..nodes.eq import EQBand

            node._bands = [
                EQBand(bt, f, q, g, en) for bt, f, q, g, en in extra["bands"]
            ]
        if row["cls"] == "WaveshaperNode":
            # derived, not stored (see _SCALAR_ATTRS note)
            node.silence_transparent = not node._dc_block
        if row["cls"] == "StreamingSamplerNode" and "reader_path" in extra:
            from ..utils.wav import WavStreamReader

            try:
                node.set_reader(WavStreamReader(extra["reader_path"]))
            except Exception as e:
                # the file moved/was deleted/is on another machine: the
                # scene still loads (docstring contract) — re-attach a
                # reader by hand via set_reader()
                import sys as _sys

                print(
                    f"[firewheel_tpu] scene reader {extra['reader_path']!r} "
                    f"unavailable ({type(e).__name__}); node loaded without "
                    "a reader",
                    file=_sys.stderr,
                )
        ids[row["key"]] = g.add_node(
            row["num_inputs"], row["num_outputs"], node
        )
    for src_key, src_port, dst_key, dst_port in scene["edges"]:
        g.connect(ids[src_key], src_port, ids[dst_key], dst_port)
    return g, ids
