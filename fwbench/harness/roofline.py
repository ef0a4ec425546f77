"""The benchmark's own yardstick for a kernel's least time on the card.

The work is counted from the graph's node semantics and the cell's shapes,
never from the program's lowering tables:

* each input byte the work needs is read once, each output byte written
  once: the params and the state of the nodes, the channels that enter the
  kernel from outside it and the channels that leave it;
* a delay line is charged for the frames it reads and writes in the chunk;
* the f32 operations a frame come from each node's formula (a sine or a
  cosine counts as one).

The least time is the larger of the bytes over the card's memory bandwidth
and the operations over its f32 rate (:data:`PEAKS`, NVIDIA's data sheet,
SXM part, dense, at the full 700 W).
"""

from __future__ import annotations

from dataclasses import dataclass

#: published peaks by ``torch.cuda.get_device_name()``
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12, "f32_per_s": 67e12},
}

F32 = 4


@dataclass(frozen=True)
class NodeWork:
    """One session's work in a node: ``param_bytes`` read once a chunk,
    ``state_bytes`` read and written once a chunk, ``line_bytes_per_frame``
    moved by a delay line each frame (read and written), and
    ``ops_per_frame`` f32 operations each frame (all channels)."""

    param_bytes: int = 0
    state_bytes: int = 0
    line_bytes_per_frame: int = 0
    ops_per_frame: int = 0


def node_work(kind: str, spec: dict, channels: int = 2) -> NodeWork:
    """The work of one node of ``kind`` (``spec``: what the configuration
    says of it, see each config's ``node_kinds``)."""
    c = channels
    if kind == "beep_test":
        # phase += inc; sin(2π·phase); × gain (one row, copied to the channels)
        return NodeWork(param_bytes=9, state_bytes=4, ops_per_frame=4)
    if kind == "volume":
        # out = in × gain; the smoother (target, last, status)
        return NodeWork(param_bytes=4, state_bytes=12, ops_per_frame=c)
    if kind == "stereo_pan":
        # mid = (L + R)·0.5, then mid × gl, mid × gr
        return NodeWork(param_bytes=4, state_bytes=12, ops_per_frame=4)
    if kind == "sum":
        return NodeWork(ops_per_frame=spec["inputs"] - c)
    if kind == "filter":
        # y = b0·x + z1; z1 = b1·x − a1·y + z2; z2 = b2·x − a2·y
        return NodeWork(param_bytes=12, state_bytes=2 * c * F32, ops_per_frame=9 * c)
    if kind == "echo":
        # e = x + fb·d; y = dry·x + wet·d, d the line's delayed frame
        return NodeWork(param_bytes=12, line_bytes_per_frame=2 * c * F32,
                        ops_per_frame=5 * c)
    if kind == "hard_clip":
        return NodeWork(param_bytes=4, state_bytes=4, ops_per_frame=2 * c)
    if kind == "db_meter":
        # |x|, max, x², the mean's sum
        return NodeWork(state_bytes=2 * c * F32, ops_per_frame=4 * c)
    raise KeyError(f"no work formula for a {kind!r} node")


@dataclass(frozen=True)
class Work:
    bytes: float
    ops: float

    def least_s(self, card: str) -> float | None:
        """The least time on ``card``, or None for a card with no peaks."""
        peak = PEAKS.get(card)
        if peak is None:
            return None
        return max(self.bytes / peak["bytes_per_s"], self.ops / peak["f32_per_s"])


def island_work(kinds: list[str], specs: dict, sessions: int, frames: int,
                in_channels: int, out_channels: int, channels: int = 2) -> Work:
    """One launch of a kernel that runs the nodes ``kinds`` over
    ``frames`` frames (all K blocks of a chunk) for ``sessions`` sessions,
    with ``in_channels`` entering it and ``out_channels`` leaving it."""
    per = [node_work(k, specs.get(k, {}), channels) for k in kinds]
    per_session = (
        sum(w.param_bytes + 2 * w.state_bytes for w in per)
        + frames * sum(w.line_bytes_per_frame for w in per)
        + frames * (in_channels + out_channels) * F32
    )
    ops = frames * sum(w.ops_per_frame for w in per)
    return Work(bytes=float(sessions * per_session), ops=float(sessions * ops))


def biquad_launch_work(sessions: int, frames: int, channels: int = 2) -> Work:
    """One launch of the sequential biquad (K1) over every session's
    channels for ``frames`` frames: x read, y written, the state read and
    written, five coefficients a session."""
    lanes = sessions * channels
    nbytes = lanes * (2 * frames * F32 + 2 * 2 * F32) + sessions * 5 * F32
    return Work(bytes=float(nbytes), ops=float(lanes * frames * 9))
