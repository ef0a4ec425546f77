"""The megakernel lowering: a whole compiled schedule in one CUDA kernel.

PyTorch port of ``firewheel_tpu/executor_pallas.py:MegaRenderer`` (the TPU
kernel K2, ``MegaRenderer._build.kernel``).  Where the eager executor
(:mod:`~firewheel_tpu_torch.executor`) launches a few hundred torch kernels
per block, the megakernel renders K blocks of B instances in one launch
(``csrc/megakernel.cu``): one warp per instance, ``tile`` instances per
CTA, each instance's arena buffers, silence flags and leaves in shared
memory for all K blocks, the K-block loop inside the kernel.  The same
tables drive the island kernel K3 of the hybrid lowering (:mod:`~
firewheel_tpu_torch.executor_hybrid`), which renders one run of the
schedule's rows.  An arena that does not fit a CTA's shared memory at one
instance a CTA (:func:`spills`) lives in a device-memory workspace instead,
the rest of the instance's part staying on chip.

* :func:`lower_schedule` turns the compiled schedule, or an island of it,
  into what the kernel walks: an int32 op table (one row per interior
  node, in schedule order), the buffer indices of each row with their
  ``should_clear`` flags, per-op float constants, the output buffers, an
  island's live-in buffers, and the leaf table: where each param, state
  and derived leaf of the flat leaf list lives in an instance's block of
  32-bit leaf words.
* :func:`pack_leaves` and :func:`unpack_leaf` convert between leaves and
  those words as the kernel does.
* :func:`mega_chunk_reference` and :func:`island_chunk_reference` are the
  plain versions of K2 and K3.  They walk the same tables, keep the leaves
  as words, and call the port's own node kernels for each row, so the CPU
  tests check the lowering and the word layout.
* :class:`MegaRenderer` is the JAX package's API.  On a CPU device it runs
  the plain version; on a CUDA device it launches the kernel or raises.

A processor is eligible when the kernel has a device function for its
class (:data:`OPS`) and its ``supports_megakernel`` attribute is true; a
graph with stream inputs is not.  Two of the JAX megakernel's semantics
are Mosaic workarounds and are not kept: its filter falls back to the
associative scan and its clip counter freezes.  Here the filter runs what
its eager kernel runs: on the ``"pallas"`` backend the sequential
recurrence of K1 (``csrc/biquad_step.cuh``), on ``"auto"`` K7's associative
scan, as the EQ's row of one band (:func:`op_for`); and the clip counter
counts, as on the eager path.  The spatializer's one-pole runs sequentially
too, on the same biquad step (the eager path runs the JAX package's
associative scan; the two agree to ~1e-7); the doppler spatializer opts
out.  The FX palette's nodes have rows as in the JAX package, all but the
mod delay's feedback program: the EQ's bands and the waveshaper's DC
blocker run K7's associative scan inside the row (``csrc/assoc_scan.cuh``),
as their eager kernels do, so these rows equal eager bit for bit; the mod
delay's line and the pitch ring stay in device memory as the echo's line
does.  The mastering bus's nodes have rows too (the compressor, ducker,
limiter and loudness meter, with the LFO, the delay compensator and the
meter as a sink), bit for bit but the loudness meter's ring, whose hop sums
run in another order (held to a tolerance on the card).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Any, Callable, Optional

import numpy as np
import torch

from .convert import params_from_jax
from .core.node import BlockInfo
from .device import DEFAULT_DEVICE, resolve_device
from .executor import ScheduleProgram, node_key, refuse_stripped_masks, refuse_timelines
from .nodes.beep_test import BeepTestProcessor
from .nodes.channel import MonoToStereoProcessor, StereoToMonoProcessor
from .nodes.delay import DelayCompProcessor, EchoProcessor
from .nodes.dummy import DummyProcessor
from .nodes.dynamics import (
    CompressorProcessor, DuckerProcessor, GateProcessor, LimiterProcessor,
)
from .nodes.eq import ParametricEQProcessor
from .nodes.filter import FilterProcessor
from .nodes.generators import LFOProcessor
from .nodes.hard_clip import HardClipProcessor
from .nodes.loudness import LoudnessMeterProcessor
from .nodes.meter import DbMeterProcessor, _SinkMeterProcessor
from .nodes.mod_effects import ModDelayProcessor, TremoloProcessor
from .nodes.pan import StereoPanProcessor
from .nodes.pitch_shift import PitchShiftProcessor
from .nodes.spatial import Spatializer3DProcessor
from .nodes.stereo_width import StereoWidthProcessor
from .nodes.sum import SumProcessor
from .nodes.volume import _MUTE_F32, VolumeProcessor
from .nodes.waveshaper import SHAPES, WaveshaperProcessor
from .ops.cuda_build import CudaLibrary
from .ops.grad import refuse_gradients
from .parallel.mesh import BatchRenderer

__all__ = [
    "KernelOperands",
    "LeafSpec",
    "LoweredSchedule",
    "MegaRenderer",
    "OPS",
    "LIBRARY",
    "eligible",
    "island_chunk_reference",
    "lower_schedule",
    "mega_chunk_reference",
    "op_for",
    "pack_leaves",
    "shared_bytes",
    "spills",
    "supports_megakernel",
    "unpack_leaf",
]

# Fields of an op-table row; csrc/megakernel.cu reads the same layout (48
# bytes, three int4 loads).
OP, N_IN, N_OUT, IO, SLOT, N_SLOT, CONST, AUX0, AUX1, WORD, N_CLEAR, GROUP = range(12)
ROW_WIDTH = 12
# Fields of a leaf-table row, and the leaf types of its LEAF_TYPE field.
LEAF_WORD, LEAF_COUNT, LEAF_TYPE, LEAF_STATE = range(4)
WORD32, BOOL, INT64 = range(3)
_LEAF_TYPES = {torch.float32: WORD32, torch.int32: WORD32, torch.bool: BOOL,
               torch.int64: INT64}


@dataclasses.dataclass(frozen=True)
class _Op:
    """One device function of the kernel.

    ``layout`` lists the (tree, path) of every leaf of the node in the
    order of its slots (or gives them for a processor); the device function
    reads them by position.  ``in_memory`` names the leaves that stay in
    device memory instead of the instance's leaf words (a line: the echo's,
    the mod delay's, the pitch ring), and ``line`` gives that line's length,
    the row's ``AUX0``.  ``consts`` gives the processor's float constants,
    ``aux`` its structural ints (``AUX0``, ``AUX1``) when it has no line,
    ``scan`` the scratch words a row of ``F`` frames needs
    (:func:`scan_words`), ``derive`` (for a ``"derived"`` leaf)
    computes a leaf from the node's params once per chunk, and ``plain``
    gives the node kernel that the plain versions call for the row."""

    code: int
    layout: Any = ()
    in_memory: tuple = ()
    consts: Callable[[Any], tuple] = lambda proc: ()
    derive: Optional[Callable[[Any, dict], torch.Tensor]] = None
    line: Optional[Callable[[Any], int]] = None
    aux: Callable[[Any], tuple] = lambda proc: (0, 0)
    scan: Callable[[Any, int], int] = lambda proc, f: 0
    # the filter's and the spatializer's recurrences run sequentially in
    # the kernel
    plain: Callable[[Any], Callable] = lambda proc: getattr(
        proc, "sequential_kernel", proc.kernel)


def _smoother_consts(proc, eps):
    b, a, log_b = proc._coeffs
    return (float(a), float(log_b), float(np.float32(eps)))


def _filter_coef(proc, p):
    """The RBJ coefficients of every instance, ``f32[B, 5]``: constant over
    a chunk, computed by the node's own design on the params' device."""
    coeffs = proc._design(p["freq"], p["q"], p["gain_db"], proc.sample_rate)
    return torch.stack(tuple(coeffs), dim=-1).contiguous()


_SMOOTHER = ("target", "last", "status")


def scan_words(levels: int, frames: int) -> int:
    """Scratch words of a row in shared memory (csrc/megakernel.cu:
    scan_row, scan_levels): a row of ``frames`` floats padded to a float4,
    then the associative scan's levels, ``frames − 1`` elements of
    ``levels`` floats (6: the biquad's maps, 2: the one-pole's, 0: none)."""
    return _round4(frames) + levels * max(frames - 1, 0)


def _eq_layout(proc):
    bands = range(len(proc._types))
    return (tuple(("params", ("bands", str(i), k)) for i in bands
                  for k in ("b0", "b1", "b2", "a1", "a2"))
            + tuple(("state", (f"{z}_{i}",)) for i in bands for z in ("z1", "z2")))


def _waveshaper_layout(proc):
    dc = (("state", ("x1",)), ("state", ("y1",))) if proc._node._dc_block else ()
    return (("params", ("drive",)), ("params", ("out",)), ("params", ("mix",))) + dc


def _params(*keys):
    return tuple(("params", (k,)) for k in keys)


def _loudness_consts(proc):
    """The K-weighting's two sections (b0, b1, b2, a1, a2 each, as float32:
    what the eager path hands K7), then the channel weights."""
    return tuple(float(np.float32(c)) for c in (*proc._shelf, *proc._hp, *proc._weights))


_METER = (("state", ("peak",)), ("state", ("rms_sq",)))


#: processor class → the kernel's device function for it
OPS: dict[type, _Op] = {
    DummyProcessor: _Op(0),
    BeepTestProcessor: _Op(1, (
        ("params", ("enabled",)), ("params", ("inc",)), ("params", ("gain",)),
        ("state", ("phase",)),
    )),
    VolumeProcessor: _Op(
        2,
        (("params", ("raw_gain",)),) + tuple(("state", ("gain", f)) for f in _SMOOTHER),
        consts=lambda proc: _smoother_consts(proc, proc._eps) + (_MUTE_F32,),
    ),
    StereoPanProcessor: _Op(
        3,
        (("params", ("pan",)),) + tuple(("state", ("pan", f)) for f in _SMOOTHER),
        consts=lambda proc: _smoother_consts(proc, 1e-5),
    ),
    SumProcessor: _Op(4),
    FilterProcessor: _Op(
        5,
        (("params", ("freq",)), ("params", ("q",)), ("params", ("gain_db",)),
         ("state", ("z1",)), ("state", ("z2",)), ("derived", ("coef",))),
        derive=_filter_coef,
    ),
    EchoProcessor: _Op(6, (
        ("params", ("feedback",)), ("params", ("wet",)), ("params", ("dry",)),
        ("state", ("line",)),
    ), in_memory=(("state", ("line",)),), line=lambda proc: proc.delay_frames),
    HardClipProcessor: _Op(7, (("params", ("threshold",)), ("state", ("clip_count",)))),
    DbMeterProcessor: _Op(
        8, _METER, consts=lambda proc: (proc._peak_decay, proc._rms_alpha)),
    # the speaker spatializer without doppler (the doppler one opts out);
    # its one-pole runs the sequential recurrence (sequential_kernel)
    Spatializer3DProcessor: _Op(
        9,
        (("params", ("gain",)), ("params", ("pan",)), ("params", ("lp_b",)))
        + tuple(("state", ("gain", f)) for f in _SMOOTHER)
        + tuple(("state", ("pan", f)) for f in _SMOOTHER) + (("state", ("lp",)),),
        consts=lambda proc: _smoother_consts(proc, 1e-5),
    ),
    # the FX palette (examples/interactive_graph.py): every node but the
    # flanger, whose feedback program opts out
    MonoToStereoProcessor: _Op(10),
    StereoToMonoProcessor: _Op(11),
    StereoWidthProcessor: _Op(
        12,
        (("params", ("width",)),) + tuple(("state", ("width", f)) for f in _SMOOTHER),
        consts=lambda proc: _smoother_consts(proc, 1e-5),
    ),
    TremoloProcessor: _Op(
        13,
        (("params", ("rate",)), ("params", ("depth",)), ("params", ("spread",)),
         ("state", ("phase",))),
        aux=lambda proc: (int(proc._node._bipolar), 0),
    ),
    WaveshaperProcessor: _Op(
        14, _waveshaper_layout,
        consts=lambda proc: (float(np.float32(proc._dc_r)),),
        aux=lambda proc: (SHAPES.index(proc._node.curve), int(proc._node._dc_block)),
        scan=lambda proc, f: scan_words(2, f) if proc._node._dc_block else 0,
    ),
    GateProcessor: _Op(
        15,
        _params("open_lin", "close_lin", "floor", "att_b", "rel_b", "hold_n")
        + (("state", ("open",)), ("state", ("hold",)), ("state", ("gain",))),
        scan=lambda proc, f: scan_words(0, f),
    ),
    ParametricEQProcessor: _Op(
        16, _eq_layout, aux=lambda proc: (len(proc._types), 0),
        scan=lambda proc, f: scan_words(6, f),
    ),
    ModDelayProcessor: _Op(
        17,
        _params("rate", "base", "depth", "mix", "spread", "feedback")
        + (("state", ("line",)), ("state", ("phase",))),
        in_memory=(("state", ("line",)),), line=lambda proc: proc._window,
    ),
    PitchShiftProcessor: _Op(
        18,
        (("params", ("ratio",)), ("params", ("mix",)), ("state", ("ring",)),
         ("state", ("phase",))),
        in_memory=(("state", ("ring",)),), line=lambda proc: proc._window,
    ),
    # the mastering bus (examples/mastering_bus.py), the latency pass's
    # delay and the meter as a sink; the envelopes and the limiter's release
    # run on one lane into the scratch row
    CompressorProcessor: _Op(
        19,
        _params("threshold_db", "ratio", "knee_db", "makeup", "att_b", "rel_b")
        + (("state", ("env",)),),
        scan=lambda proc, f: scan_words(0, f),
    ),
    DuckerProcessor: _Op(
        20, _params("threshold_db", "duck_db", "att_b", "rel_b") + (("state", ("env",)),),
        scan=lambda proc, f: scan_words(0, f),
    ),
    # the dry line in device memory; the scratch holds the level sequence
    # (the tail, then the block) and the gains
    LimiterProcessor: _Op(
        21,
        _params("ceiling", "rel_b")
        + (("state", ("delay",)), ("state", ("level_tail",)), ("state", ("env",))),
        in_memory=(("state", ("delay",)),), line=lambda proc: proc.lookahead,
        scan=lambda proc, f: _round4(proc.lookahead + f) + _round4(f),
    ),
    # the scratch holds the shelf's output, the weighted power and the levels
    LoudnessMeterProcessor: _Op(
        22,
        tuple(("state", (k,)) for k in ("shelf_z", "hp_z", "ring", "counts", "pos", "idx")),
        consts=_loudness_consts,
        aux=lambda proc: (proc.hop_frames, int(proc.init_state()["ring"].shape[0])),
        scan=lambda proc, f: scan_words(6, f) + _round4(f),
    ),
    LFOProcessor: _Op(23, _params("inc", "depth", "offset", "shape") + (("state", ("phase",)),)),
    DelayCompProcessor: _Op(
        24, (("state", ("buf",)),), in_memory=(("state", ("buf",)),),
        line=lambda proc: proc.delay_frames,
    ),
    _SinkMeterProcessor: _Op(
        25, _METER, consts=lambda proc: (proc._peak_decay, proc._rms_alpha)),
}
#: the filter on the ``"auto"`` backend: the EQ's device function with one
#: band, its coefficients derived per instance as the eager kernel derives
#: them, then its state; the params, which only the derivation reads, come
#: last and the device function does not read them.  It runs K7's scan as
#: the eager kernel does, so the row equals eager bit for bit.
_SCAN_FILTER = _Op(
    OPS[ParametricEQProcessor].code,
    (("derived", ("coef",)), ("state", ("z1",)), ("state", ("z2",)),
     ("params", ("freq",)), ("params", ("q",)), ("params", ("gain_db",))),
    derive=_filter_coef, aux=lambda proc: (1, 0),
    scan=lambda proc, f: scan_words(6, f), plain=lambda proc: proc.kernel,
)


def op_for(proc) -> _Op:
    """The device function that renders ``proc``'s row: :data:`OPS` by its
    class, but the ``"auto"`` filter's associative scan on the EQ's."""
    if isinstance(proc, FilterProcessor) and proc._backend == "scan":
        return _SCAN_FILTER
    return OPS[type(proc)]


#: device functions of rows with a line in device memory
_LINES = {op.code for op in OPS.values() if op.line is not None}
#: the device functions beyond the mixer's (the FX palette's, the mastering
#: bus's), compiled only into the kernels that a table with such rows
#: launches (csrc/megakernel.cu:run_fx_row)
FX_ROWS = frozenset(range(OPS[MonoToStereoProcessor].code,
                          OPS[_SinkMeterProcessor].code + 1))
#: device functions whose rows may run side by side on parts of a warp
_GROUPABLE = {OPS[c].code for c in (DummyProcessor, BeepTestProcessor,
                                    VolumeProcessor, StereoPanProcessor)}
MAX_GROUP = 4


def eligible(proc) -> bool:
    """True when the kernel has a device function for ``proc`` and the
    processor does not opt out."""
    return type(proc) in OPS and getattr(proc, "supports_megakernel", True)


def supports_megakernel(program: ScheduleProgram) -> bool:
    """True when the kernel can render ``program``: no stream inputs, and a
    device function for every processor that does not opt out."""
    if program.num_graph_inputs != 0:
        return False
    return all(eligible(p) for p in program._procs.values())


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """One leaf of the flat list: ``tree`` is ``"params"``, ``"state"`` or
    ``"derived"``; ``shape`` is one instance's shape."""

    tree: str
    key: str
    path: tuple
    dtype: torch.dtype
    shape: tuple


@dataclasses.dataclass(frozen=True)
class LoweredSchedule:
    """What the kernel walks (see :func:`lower_schedule`).  Row ``n``'s
    leaves are ``leaves[ops[n, SLOT]: ops[n, SLOT] + ops[n, N_SLOT]]``, and
    their words start at ``ops[n, WORD]``."""

    ops: np.ndarray        # int32 [n_ops, ROW_WIDTH]
    io: np.ndarray         # int32: per row, inputs, their clear flags, outputs
    consts: np.ndarray     # float32: per row, the processor's constants
    out_row: np.ndarray    # int32 [No, 2]: output buffer, should_clear
    in_bufs: np.ndarray    # int32 [n_in]: an island's live-in buffers
    leaf_words: np.ndarray  # int32 [n_leaves, 4]: word, count, type, is state
    keys: tuple            # node key of each row
    leaves: tuple          # LeafSpec
    num_words: int         # leaf words per instance
    num_buffers: int
    frames: int
    echo_channels: int     # channels of all rows with a line (the kernel's records)
    scan_words: int = 0    # scratch words per instance (the most a row needs)


def _flat(tree, prefix=()):
    """(path, leaf) pairs of a nested dict, in insertion order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _nest(pairs) -> dict:
    """Inverse of :func:`_flat`."""
    out: dict = {}
    for path, v in pairs:
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = v
    return out


def lower_schedule(program: ScheduleProgram, nodes=None, live_in=(),
                   live_out=None) -> LoweredSchedule:
    """Lower ``program``'s schedule to the kernel's tables.

    With ``nodes`` (a run of the schedule's interior entries, all
    eligible), lower that run alone as an island: its rows read the
    ``live_in`` buffers, seeded every block, and its outputs are the
    ``live_out`` buffers, returned as they are.  Without, lower the whole
    schedule, whose outputs are the graph outputs."""
    if nodes is None:
        if not supports_megakernel(program):
            raise ValueError(
                "graph not eligible for the megakernel (stream inputs, or a "
                "node with no device function) — use BatchRenderer"
            )
        nodes = program.schedule.schedule[1:-1]
        out_row = [[ib.buffer_index, int(ib.should_clear)]
                   for ib in program.schedule.schedule[-1].input_buffers]
    else:
        bad = [node_key(sn.id) for sn in nodes
               if not eligible(program._procs[node_key(sn.id)])]
        if bad:
            raise ValueError(f"nodes with no device function in an island: {bad}")
        out_row = [[b, 0] for b in (live_out or ())]
    rows, io, consts, keys, leaves, words = [], [], [], [], [], []
    echo_channels = num_words = scan = 0
    for sn in nodes:
        key = node_key(sn.id)
        proc = program._procs[key]
        op = op_for(proc)
        mine = [
            LeafSpec("params", key, path, t.dtype, tuple(t.shape))
            for path, t in _flat(params_from_jax(proc.collect_params(), "cpu"))
        ] + [
            LeafSpec("state", key, path, t.dtype, tuple(t.shape))
            for path, t in _flat(proc.init_state())
        ]
        if op.derive is not None:
            mine.append(LeafSpec("derived", key, ("coef",), torch.float32, (5,)))
        got = {(leaf.tree, leaf.path): leaf for leaf in mine}
        layout = op.layout(proc) if callable(op.layout) else op.layout
        if sorted(got) != sorted(layout):
            raise AssertionError(f"{key}: leaves {tuple(got)}, the kernel reads {layout}")
        mine = [got[leaf] for leaf in layout]  # in the order the kernel reads
        aux0, aux1 = op.aux(proc)
        if op.line is not None:
            aux0, aux1 = op.line(proc), echo_channels
            echo_channels += proc.num_inputs
        scan = max(scan, op.scan(proc, program.max_block_frames))
        rows.append([op.code, len(sn.input_buffers), len(sn.output_buffers),
                     len(io), len(leaves), len(mine), len(consts), aux0, aux1,
                     num_words, sum(ib.should_clear for ib in sn.input_buffers), 1])
        io += [ib.buffer_index for ib in sn.input_buffers]
        io += [int(ib.should_clear) for ib in sn.input_buffers]
        io += [ob.buffer_index for ob in sn.output_buffers]
        for leaf in mine:
            count = (0 if (leaf.tree, leaf.path) in op.in_memory
                     else math.prod(leaf.shape))
            words.append([num_words, count, _LEAF_TYPES[leaf.dtype],
                          int(leaf.tree == "state")])
            num_words += count
        leaves += mine
        consts += op.consts(proc)
        keys.append(key)
    rows = np.asarray(rows, np.int32).reshape(-1, ROW_WIDTH)
    _group_rows(rows, io)
    return LoweredSchedule(
        ops=rows,
        io=np.asarray(io, np.int32),
        consts=np.asarray(consts, np.float32),
        out_row=np.asarray(out_row, np.int32).reshape(-1, 2),
        in_bufs=np.asarray(live_in, np.int32).reshape(-1),
        leaf_words=np.asarray(words, np.int32).reshape(-1, 4),
        keys=tuple(keys),
        leaves=tuple(leaves),
        num_words=num_words,
        num_buffers=program.schedule.num_buffers,
        frames=program.max_block_frames,
        echo_channels=echo_channels,
        scan_words=scan,
    )


# -- the leaf words -----------------------------------------------------------

def _to_words(lowered: LoweredSchedule, i: int, v: torch.Tensor) -> torch.Tensor:
    """Leaf ``i``'s value ``[B, *shape]`` → its words ``int32 [B, count]``:
    bool as 0/1, the uint32 carried in int64 as its low 32 bits, f32 by its
    bits, int32 as it is."""
    v = v.reshape(v.shape[0], -1)
    typ = int(lowered.leaf_words[i, LEAF_TYPE])
    if typ == BOOL:
        return v.to(torch.int32)
    if typ == INT64:
        low = v & 0xFFFFFFFF
        return torch.where(low >= 2**31, low - 2**32, low).to(torch.int32)
    return v.contiguous().view(torch.int32)


def pack_leaves(lowered: LoweredSchedule, values) -> torch.Tensor:
    """Every instance's leaf words, ``int32 [B, num_words]``, from the leaf
    list ``values`` (``[B, *shape]`` tensors; those that stay in device
    memory are not read).  ``lowered`` must have leaf words."""
    cols = [_to_words(lowered, i, v) for i, v in enumerate(values)
            if lowered.leaf_words[i, LEAF_COUNT]]
    return torch.cat(cols, 1)


def unpack_leaf(lowered: LoweredSchedule, words: torch.Tensor, i: int) -> torch.Tensor:
    """Leaf ``i`` from ``words`` (``int32 [B, num_words]``) as a ``[B,
    *shape]`` tensor of its dtype, a copy."""
    leaf = lowered.leaves[i]
    at, count, typ, _ = (int(x) for x in lowered.leaf_words[i])
    w = words[:, at: at + count]
    if typ == BOOL:
        v = w != 0
    elif typ == INT64:
        v = w.to(torch.int64) & 0xFFFFFFFF
    else:
        v = w.clone(memory_format=torch.contiguous_format)
        if leaf.dtype == torch.float32:
            v = v.view(torch.float32)
    return v.reshape((words.shape[0],) + leaf.shape)


class _LeafStore:
    """The plain versions' leaves during a chunk: the words, and the leaves
    that stay in device memory as tensors."""

    def __init__(self, lowered: LoweredSchedule, values, batch: int, device):
        self.lowered = lowered
        self.words = (pack_leaves(lowered, values) if lowered.num_words else
                      torch.zeros((batch, 0), dtype=torch.int32, device=device))
        self.memory = {i: v for i, v in enumerate(values)
                       if not lowered.leaf_words[i, LEAF_COUNT]}

    def get(self, i: int) -> torch.Tensor:
        if i in self.memory:
            return self.memory[i]
        return unpack_leaf(self.lowered, self.words, i)

    def set(self, i: int, v: torch.Tensor) -> None:
        if i in self.memory:
            self.memory[i] = v
            return
        at, count = (int(x) for x in self.lowered.leaf_words[i, :2])
        self.words[:, at: at + count] = _to_words(self.lowered, i, v)


def _group_rows(rows, io) -> None:
    """Set each row's GROUP field, in place: runs of up to MAX_GROUP (a power
    of two) consecutive rows of one groupable device function, with equal
    port counts of at most two, no cleared input, and no buffer that one row
    writes and a later row of the run reads or writes, run side by side in
    the kernel (the group's size on its first row, 0 on the others).  A
    later row may write what an earlier one reads (the allocator reuses a
    consumed input for the next row's output): the kernel reads a group's
    inputs before it writes any output.  The plain versions walk the rows
    one by one, as the schedule orders them."""
    def bufs(r):
        at, n_in, n_out = int(r[IO]), int(r[N_IN]), int(r[N_OUT])
        return set(io[at: at + n_in]), set(io[at + 2 * n_in: at + 2 * n_in + n_out])

    def joins(a, b):
        return (a[OP] == b[OP] and a[N_IN] == b[N_IN] and a[N_OUT] == b[N_OUT]
                and not b[N_CLEAR])

    n = 0
    while n < len(rows):
        size = 1
        if (rows[n, OP] in _GROUPABLE and not rows[n, N_CLEAR]
                and rows[n, N_IN] <= 2 and rows[n, N_OUT] <= 2):
            writes = bufs(rows[n])[1]
            while (size < MAX_GROUP and n + size < len(rows)
                   and joins(rows[n], rows[n + size])):
                ins, outs = bufs(rows[n + size])
                if ins & writes or outs & writes:
                    break
                writes |= outs
                size += 1
            size = 1 << (size.bit_length() - 1)  # 32 lanes split evenly
        rows[n: n + size, GROUP] = 0
        rows[n, GROUP] = size
        n += size


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _row_io(lowered: LoweredSchedule, row):
    n_in, n_out, at = int(row[N_IN]), int(row[N_OUT]), int(row[IO])
    ins = lowered.io[at: at + n_in].tolist()
    clear = lowered.io[at + n_in: at + 2 * n_in].tolist()
    outs = lowered.io[at + 2 * n_in: at + 2 * n_in + n_out].tolist()
    return ins, clear, outs


def _new_state_tree(state, lowered: LoweredSchedule, values):
    """``state`` with every state leaf of the list replaced by ``values``."""
    out = {k: dict(v) if isinstance(v, dict) else v for k, v in state.items()}
    for i, leaf in enumerate(lowered.leaves):
        if leaf.tree == "state":
            out[leaf.key] = _nest(
                list(_flat(out[leaf.key])) + [(leaf.path, values[i])]
            )
    return out


def _chunk_clocks(program: ScheduleProgram, start_sample, num_blocks: int,
                  device):
    """Each block's ``BlockInfo``, as ``ScheduleProgram.chunk_fn`` computes
    them."""
    samples, times = program.block_clocks(start_sample, num_blocks,
                                          program.max_block_frames, device)
    status = torch.zeros((), dtype=torch.int64, device=device)
    return [BlockInfo(times[k], samples[k], status) for k in range(num_blocks)]


def _walk_rows(program: ScheduleProgram, lowered: LoweredSchedule,
               store: _LeafStore, bufs, flags, info, zeros, silent):
    """One block of the op table in torch: each row gathers its inputs from
    ``bufs``/``flags``, calls its node's kernel on its leaves (read from
    ``store``) and scatters its outputs; ``store`` takes each row's new
    state."""
    batch, f = zeros.shape
    for row, key in zip(lowered.ops, lowered.keys):
        ins, clear, out_idx = _row_io(lowered, row)
        rows = [zeros if c else bufs[b] for b, c in zip(ins, clear)]
        rmask = [silent if c else flags[b] for b, c in zip(ins, clear)]
        if rows:
            inputs, in_mask = torch.stack(rows, -2), torch.stack(rmask, -1)
        else:
            inputs = zeros.new_zeros((batch, 0, f))
            in_mask = silent.new_zeros((batch, 0))
        mine = range(int(row[SLOT]), int(row[SLOT]) + int(row[N_SLOT]))
        p = _nest([(lowered.leaves[i].path, store.get(i)) for i in mine
                   if lowered.leaves[i].tree == "params"])
        s_slots = [i for i in mine if lowered.leaves[i].tree == "state"]
        s = _nest([(lowered.leaves[i].path, store.get(i)) for i in s_slots])
        proc = program._procs[key]
        y, s2, om = op_for(proc).plain(proc)(p, s, inputs, in_mask, info)
        for i, (path, t) in zip(s_slots, _flat(s2), strict=True):
            assert path == lowered.leaves[i].path, (key, path)
            store.set(i, t)
        for j, b in enumerate(out_idx):
            bufs[b] = y[:, j]
            flags[b] = om[:, j]


def _leaf_values(program: ScheduleProgram, lowered: LoweredSchedule, params,
                 state):
    """The leaf list from batch-stacked trees, derived leaves computed from
    the params as the kernel's wrapper computes them."""
    values = []
    for leaf in lowered.leaves:
        if leaf.tree == "derived":
            proc = program._procs[leaf.key]
            values.append(op_for(proc).derive(proc, params[leaf.key]))
        else:
            tree = params if leaf.tree == "params" else state
            values.append(_get(tree, (leaf.key,) + leaf.path))
    return values


def _final_state(state, lowered: LoweredSchedule, store: _LeafStore):
    return _new_state_tree(state, lowered, [
        store.get(i) if leaf.tree == "state" else None
        for i, leaf in enumerate(lowered.leaves)
    ])


def mega_chunk_reference(program: ScheduleProgram, lowered: LoweredSchedule,
                         params, state, start_sample, num_blocks: int,
                         batch: int):
    """Plain version of the kernel: K blocks for every instance, walking the
    op table with the leaves packed into their words, one node kernel call
    per row.

    ``params``/``state`` are batch-stacked trees of tensors (``[B, ...]``
    leaves).  Returns ``(out f32[B, K, No, F], masks bool[B, K, No],
    state')``."""
    values = _leaf_values(program, lowered, params, state)
    device = values[0].device if values else program.device
    f = lowered.frames
    zeros = torch.zeros((batch, f), dtype=torch.float32, device=device)
    silent = torch.ones((batch,), dtype=torch.bool, device=device)
    store = _LeafStore(lowered, values, batch, device)

    outs, masks = [], []
    for info in _chunk_clocks(program, start_sample, num_blocks, device):
        bufs: dict[int, torch.Tensor] = {}
        flags: dict[int, torch.Tensor] = {}
        _walk_rows(program, lowered, store, bufs, flags, info, zeros, silent)
        o_rows, o_flags = [], []
        for b, c in lowered.out_row.tolist():
            if c:
                o_rows.append(zeros)
                o_flags.append(silent)
            else:
                o_rows.append(bufs[b].masked_fill(flags[b][:, None], 0.0))
                o_flags.append(flags[b])
        if o_rows:
            outs.append(torch.stack(o_rows, -2))
            masks.append(torch.stack(o_flags, -1))
        else:
            outs.append(zeros.new_zeros((batch, 0, f)))
            masks.append(silent.new_zeros((batch, 0)))
    return (torch.stack(outs, 1), torch.stack(masks, 1),
            _final_state(state, lowered, store))


def island_chunk_reference(program: ScheduleProgram, lowered: LoweredSchedule,
                           params, state, env, env_flags, start_sample,
                           num_blocks: int, batch: int):
    """Plain version of the island kernel (K3): :func:`mega_chunk_reference`
    for an island lowered with live-in and live-out buffers.

    Each block seeds the live-in buffers and their flags from ``env
    f32[B, K, n_in, F]`` and ``env_flags bool[B, K, n_in]``, walks the
    island's rows, and returns the live-out buffers as they are, not zeroed
    by their flags: ``(rows f32[B, K, n_out, F], flags bool[B, K, n_out],
    state')``."""
    values = _leaf_values(program, lowered, params, state)
    device = env.device
    f = lowered.frames
    zeros = torch.zeros((batch, f), dtype=torch.float32, device=device)
    silent = torch.ones((batch,), dtype=torch.bool, device=device)
    in_bufs = lowered.in_bufs.tolist()
    out_bufs = [b for b, _ in lowered.out_row.tolist()]
    store = _LeafStore(lowered, values, batch, device)

    outs, masks = [], []
    infos = _chunk_clocks(program, start_sample, num_blocks, device)
    for k, info in enumerate(infos):
        bufs = {b: env[:, k, j] for j, b in enumerate(in_bufs)}
        flags = {b: env_flags[:, k, j] for j, b in enumerate(in_bufs)}
        _walk_rows(program, lowered, store, bufs, flags, info, zeros, silent)
        if out_bufs:
            outs.append(torch.stack([bufs[b] for b in out_bufs], -2))
            masks.append(torch.stack([flags[b] for b in out_bufs], -1))
        else:
            outs.append(zeros.new_zeros((batch, 0, f)))
            masks.append(silent.new_zeros((batch, 0)))
    return (torch.stack(outs, 1), torch.stack(masks, 1),
            _final_state(state, lowered, store))


# -- the CUDA kernel ----------------------------------------------------------

MAX_TILE = 8      # instances (warps) per CTA at most (csrc/megakernel.cu:kMaxTile)
MAX_SHARED_BYTES = 232448  # the most shared memory one CTA may take (H100)


def _bind(lib):
    head = (
        [ctypes.c_void_p] * 10         # ops, io, consts, out_row, leaves, ptrs,
                                       # out, masks (flags), scratch, arena
        + [ctypes.c_int] * 6           # n_ops, n_io, n_consts, n_out, n_leaves,
                                       # num_words
        + [ctypes.c_int64]             # scratch per echo channel
        + [ctypes.c_int] * 9           # batch, tile, K, F, buffers, echo channels,
                                       # scan words, FX rows, spill
        + [ctypes.c_void_p]            # stream
    )
    lib.fw_mega_render.argtypes = head
    lib.fw_island_render.argtypes = head + [
        ctypes.c_void_p, ctypes.c_int,      # in_bufs, n_in
        ctypes.c_void_p, ctypes.c_void_p,   # env, env_flags
    ]
    lib.fw_mega_render.restype = lib.fw_island_render.restype = ctypes.c_int
    lib.fw_mega_shared_bytes.argtypes = [ctypes.c_int] * 12
    lib.fw_mega_shared_bytes.restype = ctypes.c_int64


#: ``csrc/megakernel.cu`` (K2 and K3), built with nvcc at first use; its
#: ten instantiations, the port's longest build, are optimised on every
#: core (``--split-compile=0``)
LIBRARY = CudaLibrary("fw_mega", "megakernel.cu", ("assoc_scan.cuh", "biquad_step.cuh"),
                      _bind, flags=("--split-compile=0",))


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


#: 32-bit words of one echo channel's record (csrc/megakernel.cu:EchoChannel)
ECHO_WORDS = 10


def _shared_bytes(lowered: LoweredSchedule, tile: int, spill: bool) -> int:
    tables = (lowered.ops.size + lowered.io.size + lowered.consts.size
              + lowered.out_row.size + lowered.in_bufs.size)
    arena = 0 if spill else lowered.num_buffers * _round4(lowered.frames)
    per_instance = (arena + ECHO_WORDS * lowered.echo_channels + lowered.num_buffers
                    + lowered.num_words + lowered.scan_words)
    return 4 * (_round4(tables) + tile * _round4(per_instance))


def spills(lowered: LoweredSchedule) -> bool:
    """True when one instance's arena does not fit a CTA's shared memory (at
    tile 1, with everything else): the kernel then keeps every instance's
    buffers in a device-memory workspace, ``f32[B, num_buffers,
    round4(F)]``, and the rest on chip."""
    return _shared_bytes(lowered, 1, False) > MAX_SHARED_BYTES


def shared_bytes(lowered: LoweredSchedule, tile: int) -> int:
    """Dynamic shared memory of one CTA (csrc/megakernel.cu:shared_bytes) in
    the layout the kernel takes (:func:`spills`): the tables once, then per
    instance the buffers (each padded to a whole float4; none when they
    spill), the echo channels' records, the buffers' flags, the leaf words
    and the rows' scratch, each part rounded up to 16 bytes."""
    return _shared_bytes(lowered, tile, spills(lowered))


def shared_sizes(lowered: LoweredSchedule, tile: int) -> tuple:
    """The arguments of ``fw_mega_shared_bytes`` for ``lowered``."""
    return (lowered.ops.shape[0], lowered.io.size, lowered.consts.size,
            lowered.out_row.shape[0], lowered.in_bufs.size, lowered.num_words,
            tile, lowered.frames, lowered.num_buffers, lowered.echo_channels,
            lowered.scan_words, int(spills(lowered)))


def check_launchable(lowered: LoweredSchedule, tile: int, who: str) -> None:
    """Raises ``ValueError`` unless the kernel can render ``lowered`` with
    ``tile`` instances a CTA: at most ``MAX_TILE`` of them in at most
    ``MAX_SHARED_BYTES`` of shared memory in the layout it takes (the
    arena spilled to device memory when it does not fit at tile 1), and
    blocks of at least one frame (of any length: the kernel pads each arena
    row to a whole float4)."""
    if lowered.frames <= 0:
        raise ValueError(f"{who}: blocks of {lowered.frames} frames")
    smem = shared_bytes(lowered, tile)
    if tile > MAX_TILE or smem > MAX_SHARED_BYTES:
        raise ValueError(
            f"{who}: tile {tile} needs {smem} bytes of shared memory per CTA "
            f"(at most {MAX_TILE} instances and {MAX_SHARED_BYTES} bytes)")


class KernelOperands:
    """What every launch of one lowered schedule on one CUDA device needs:
    the tables on the device, and per chunk the leaf pointer table, the new
    state leaves and the echo scratch.  ``who`` names the caller in
    errors."""

    def __init__(self, program: ScheduleProgram, lowered: LoweredSchedule,
                 batch: int, num_blocks: int, tile: int, device: torch.device,
                 who: str):
        self.program, self.lowered, self.who = program, lowered, who
        self.batch, self.num_blocks, self.tile = batch, num_blocks, tile
        self.device = device
        check_launchable(lowered, tile, who)
        self.tables = tuple(
            torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in (lowered.ops, lowered.io, lowered.consts, lowered.out_row,
                      lowered.leaf_words, lowered.in_bufs)
        )

    def _checked_values(self, params, state):
        values = _leaf_values(self.program, self.lowered, params, state)
        for leaf, v in zip(self.lowered.leaves, values):
            want = (self.batch,) + leaf.shape
            if (not isinstance(v, torch.Tensor) or v.device != self.device
                    or v.dtype != leaf.dtype or tuple(v.shape) != want):
                got = (getattr(v, "device", None), getattr(v, "dtype", None),
                       tuple(getattr(v, "shape", ())))
                raise ValueError(
                    f"{self.who}: {leaf.tree} {leaf.key}/{'/'.join(leaf.path)} "
                    f"must be a {leaf.dtype} {want} tensor on {self.device}; "
                    f"got {got}"
                )
        # the eager path hands over pooled state as strided views
        return [v.contiguous() for v in values]

    def chunk(self, params, state):
        """``(values, ptrs, new, scratch, stride)`` for one chunk: the input
        leaves (contiguous copies where a leaf was not; the caller holds
        them until the launch is enqueued, or the allocator hands their
        memory to the next tensor), the device table of (input, output)
        pointers per leaf, the new state leaves (a list aligned with the
        leaves, params in their slots), and the scratch: the echoes a
        chunk's final line does not keep, then the spilled arena
        (:func:`spills`)."""
        lw, dev = self.lowered, self.device
        values = self._checked_values(params, state)
        new = [torch.empty_like(v) if leaf.tree == "state" else v
               for leaf, v in zip(lw.leaves, values)]
        ptrs = [p for v, w in zip(values, new) for p in (v.data_ptr(), w.data_ptr())]
        ptrs_d = torch.tensor(ptrs or [0], dtype=torch.int64).pin_memory().to(
            dev, non_blocking=True)
        stride = max([0] + [max(0, self.num_blocks * lw.frames - int(r[AUX0]))
                            for r in lw.ops if r[OP] in _LINES])
        arena = (self.batch * lw.num_buffers * _round4(lw.frames)
                 if spills(lw) else 0)
        scratch = torch.empty((self._arena_offset(stride) + arena,),
                              dtype=torch.float32, device=dev)
        return values, ptrs_d, new, scratch, stride

    def _arena_offset(self, stride: int) -> int:
        """Where the spilled arena starts in the scratch, in floats: after
        the echoes, on a 16-byte boundary (its rows are read as float4s)."""
        return _round4(self.batch * self.lowered.echo_channels * stride)

    def args(self, ptrs, out, masks, scratch, stride, stream):
        """The arguments both C entry points share, in their order."""
        lw = self.lowered
        fx = int(bool(FX_ROWS & set(lw.ops[:, OP].tolist())))
        spill = spills(lw)
        arena = scratch.data_ptr() + 4 * self._arena_offset(stride) if spill else None
        ops, io, consts, out_row, leaf_words, _ = self.tables
        return (ops.data_ptr(), io.data_ptr(), consts.data_ptr(),
                out_row.data_ptr(), leaf_words.data_ptr(), ptrs.data_ptr(),
                out.data_ptr(), masks.data_ptr(), scratch.data_ptr(), arena,
                lw.ops.shape[0], lw.io.size, lw.consts.size, lw.out_row.shape[0],
                len(lw.leaves), lw.num_words, stride, self.batch, self.tile,
                self.num_blocks, lw.frames, lw.num_buffers, lw.echo_channels,
                lw.scan_words, fx, int(spill), stream)


class MegaRenderer:
    """Batched K-block renderer backed by one kernel launch per chunk.

    The API of the JAX package's ``MegaRenderer``: ``render_chunk(params,
    state, start_sample)`` with batch-stacked params and state →
    ``(out f32[B, K, No, F], masks bool[B, K, No], state')``.  The state has
    the tree and layout of :class:`~firewheel_tpu_torch.parallel.
    BatchRenderer`'s, so the two can hand state to each other mid-stream.
    ``tile`` instances share one CTA.  ``device`` is the card unless the
    caller passes ``"cpu"``.
    """

    #: kernel launches since the counter was last set to 0
    launches = 0

    def __init__(self, program: ScheduleProgram, batch: int, num_blocks: int,
                 tile: int = 1, device: str | torch.device = DEFAULT_DEVICE):
        if batch % tile != 0:
            raise ValueError(f"batch {batch} % tile {tile} != 0")
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        refuse_stripped_masks(program, "MegaRenderer")
        self.program = program
        self.batch = int(batch)
        self.num_blocks = int(num_blocks)
        self.tile = int(tile)
        self.device = resolve_device(device)
        self.lowered = lower_schedule(program)
        self._batched = BatchRenderer(program, batch, self.device)
        self._operands = None

    def stack_params(self, params_list=None):
        return self._batched.stack_params(params_list)

    def init_state(self):
        return self._batched.init_state()

    def render_chunk(self, params, state, start_sample=0):
        refuse_timelines(params, "MegaRenderer")
        refuse_gradients("MegaRenderer (K2)", params, state)
        params = params_from_jax(params, self.device)
        if self.device.type == "cpu":
            return mega_chunk_reference(self.program, self.lowered, params,
                                        state, start_sample, self.num_blocks,
                                        self.batch)
        if self.device.type != "cuda":
            raise ValueError(f"MegaRenderer: unsupported device {self.device}")
        return self._launch(params, state)

    def _launch(self, params, state):
        if self._operands is None:
            self._operands = KernelOperands(
                self.program, self.lowered, self.batch, self.num_blocks,
                self.tile, self.device, "MegaRenderer")
        ko, lw, dev = self._operands, self.lowered, self.device
        values, ptrs, new, scratch, stride = ko.chunk(params, state)
        n_out = lw.out_row.shape[0]
        out = torch.empty((self.batch, self.num_blocks, n_out, lw.frames),
                          dtype=torch.float32, device=dev)
        masks = torch.empty((self.batch, self.num_blocks, n_out),
                            dtype=torch.bool, device=dev)

        lib = LIBRARY.load()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.fw_mega_render(
                *ko.args(ptrs, out, masks, scratch, stride, stream))
        del values  # enqueued: the stream orders any reuse after the kernel
        if err != 0:
            raise RuntimeError(f"MegaRenderer: kernel launch failed (cudaError {err})")
        MegaRenderer.launches += 1
        return out, masks, _new_state_tree(state, lw, new)
