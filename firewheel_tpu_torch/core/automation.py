"""Automatable parameters: keyframe curves with cubic-bezier easing.

Reference scope: "Automatable parameters on nodes, with support for bezier
automation curves" (``DESIGN_DOC.md:31``, unimplemented there).

Design: automation runs on the **control plane** — curves are evaluated on
the host each ``update()`` tick and staged into node params like any live
set_* call, so automated params ride the same smoothers and param path as
manual ones.  (Sample-accurate curve rendering inside kernels is a possible
later extension; block-rate automation at ≤ 21 ms resolution plus the 10 ms
param smoothers matches what game engines ship.)

A curve is a sequence of keyframes; each segment between keyframes is a
cubic bezier in (time, value) with per-keyframe outgoing/incoming handles
(DAW-style).  Solving value-at-time uses a few Newton steps on the time
polynomial (monotonic in the parameter because handle times are clamped to
the segment).
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Callable, Sequence

__all__ = ["Keyframe", "AutomationCurve", "ParamAutomator"]


@dataclasses.dataclass(frozen=True)
class Keyframe:
    """A point on an automation curve.

    ``out_handle`` / ``in_handle`` are (dt, dv) bezier handle offsets for
    the outgoing and incoming segment; ``(0, 0)`` handles give linear
    interpolation toward the neighbor.
    """

    time: float
    value: float
    out_handle: tuple[float, float] = (0.0, 0.0)
    in_handle: tuple[float, float] = (0.0, 0.0)


class AutomationCurve:
    """Piecewise cubic-bezier value-vs-time curve."""

    def __init__(self, keyframes: Sequence[Keyframe]):
        assert keyframes, "curve needs at least one keyframe"
        kfs = sorted(keyframes, key=lambda k: k.time)
        self._kfs = kfs
        self._times = [k.time for k in kfs]

    @staticmethod
    def linear(points: Sequence[tuple[float, float]]) -> "AutomationCurve":
        """Convenience: piecewise-linear curve from (time, value) pairs."""
        return AutomationCurve([Keyframe(t, v) for t, v in points])

    @staticmethod
    def hold(value: float) -> "AutomationCurve":
        return AutomationCurve([Keyframe(0.0, value)])

    @property
    def end_time(self) -> float:
        return self._times[-1]

    def value_at(self, t: float) -> float:
        kfs, times = self._kfs, self._times
        if t <= times[0]:
            return kfs[0].value
        if t >= times[-1]:
            return kfs[-1].value
        i = bisect.bisect_right(times, t) - 1
        k0, k1 = kfs[i], kfs[i + 1]
        dt = k1.time - k0.time
        if dt <= 0:
            return k1.value

        # Control points; handle times clamped inside the segment so the
        # time polynomial is monotone in u and Newton converges.
        h0t = min(max(k0.out_handle[0], 0.0), dt)
        h1t = min(max(-k1.in_handle[0], 0.0), dt)
        p0t, p1t = k0.time, k0.time + h0t
        p2t, p3t = k1.time - h1t, k1.time
        p0v, p1v = k0.value, k0.value + k0.out_handle[1]
        p2v, p3v = k1.value + k1.in_handle[1], k1.value

        def bez(u, a, b, c, d):
            w = 1.0 - u
            return w * w * w * a + 3 * w * w * u * b + 3 * w * u * u * c + u * u * u * d

        def bez_dt(u, a, b, c, d):
            w = 1.0 - u
            return 3 * w * w * (b - a) + 6 * w * u * (c - b) + 3 * u * u * (d - c)

        # Newton for u such that time(u) == t, seeded linearly.
        u = (t - k0.time) / dt
        for _ in range(8):
            f = bez(u, p0t, p1t, p2t, p3t) - t
            df = bez_dt(u, p0t, p1t, p2t, p3t)
            if abs(df) < 1e-12:
                break
            u -= f / df
            u = min(max(u, 0.0), 1.0)
            if abs(f) < 1e-9:
                break
        return float(bez(u, p0v, p1v, p2v, p3v))


@dataclasses.dataclass
class _Lane:
    setter: Callable[[float], None]
    curve: AutomationCurve
    start_time: float
    loop: bool
    #: block-accurate lane: the setter accepts ``at_sample=`` and the
    #: automator schedules one value per render block ahead of the stream
    block_accurate: bool = False
    #: next stream sample to schedule (block-accurate lanes)
    next_sample: int | None = None


class ParamAutomator:
    """Drives node parameter setters from automation curves.

    Tick it from the game loop (or let :class:`~firewheel_tpu_torch.backend.
    context.FirewheelCtx` tick it in ``update()``) with the current stream
    time; each lane evaluates its curve and calls the bound setter — the
    value then flows through the normal live-param staging path.
    """

    def __init__(self):
        self._lanes: dict[object, _Lane] = {}

    def add(
        self,
        key,
        setter: Callable[[float], None],
        curve: AutomationCurve,
        start_time: float = 0.0,
        loop: bool = False,
        block_accurate: bool = False,
    ):
        """Bind ``setter`` (e.g. ``node.set_percent_volume``) to ``curve``.
        ``key`` identifies the lane for removal (any hashable).

        ``block_accurate=True``: the setter must accept ``at_sample=`` (e.g.
        ``VolumeNode.set_percent_volume``); the automator then schedules one
        curve value per render block so the sweep applies block-accurately
        even inside K-blocks-per-dispatch chunked streams (the reference's
        per-block param application, volume.rs:92)."""
        self._lanes[key] = _Lane(
            setter, curve, start_time, loop, block_accurate=block_accurate
        )

    def remove(self, key) -> bool:
        return self._lanes.pop(key, None) is not None

    def clear(self):
        self._lanes.clear()

    def tick(self, stream_time_secs: float):
        done = []
        # setters may add/remove lanes (curve chaining) — snapshot first
        for key, lane in list(self._lanes.items()):
            if lane.block_accurate:
                continue  # driven by tick_blocks
            t = stream_time_secs - lane.start_time
            if t < 0:
                continue
            if lane.loop and lane.curve.end_time > 0:
                t = t % lane.curve.end_time
            lane.setter(lane.curve.value_at(t))
            if not lane.loop and t > lane.curve.end_time:
                done.append(key)
        # finished one-shot lanes park at their final value and drop out
        for key in done:
            del self._lanes[key]

    def tick_blocks(
        self,
        start_sample: int,
        horizon_frames: int,
        sample_rate: float,
        block_frames: int,
    ):
        """Schedule block-accurate lane values for every block boundary in
        ``[cursor, start_sample + horizon_frames)``.  Each boundary is
        scheduled exactly once (a per-lane cursor), so over-scheduling
        ahead of a backpressured stream never duplicates sets."""
        end = int(start_sample) + int(horizon_frames)
        done = []
        for key, lane in list(self._lanes.items()):
            if not lane.block_accurate:
                continue
            cur = (
                lane.next_sample
                if lane.next_sample is not None
                else int(start_sample)
            )
            if cur % block_frames:
                cur += block_frames - (cur % block_frames)
            finished = False
            while cur < end:
                t = cur / sample_rate - lane.start_time
                if t >= 0:
                    tt = (
                        t % lane.curve.end_time
                        if (lane.loop and lane.curve.end_time > 0)
                        else t
                    )
                    lane.setter(lane.curve.value_at(tt), at_sample=cur)
                    if not lane.loop and t >= lane.curve.end_time:
                        # this set carried the clamped final value — the
                        # lane parks exactly at curve end, not one block
                        # short of it
                        finished = True
                        break
                cur += block_frames
            lane.next_sample = cur
            if finished:
                done.append(key)
        for key in done:
            del self._lanes[key]

    def reset_block_cursors(self) -> None:
        """Rewind every block-accurate lane's scheduling cursor.  Called on
        stream (re-)activation: a fresh OutputStream restarts its sample
        clock at 0, and a stale cursor from the previous stream would park
        the lane until the new clock caught up."""
        for lane in self._lanes.values():
            if lane.block_accurate:
                lane.next_sample = None
