"""Reduce a ``torch.profiler`` trace of a few chunks to what the per-layer
metrics read: the device's operations with their times, how long the
device was busy in the traced window, the idle gaps by what the host was
doing, and the operations that took most device time.

The profile is kept small: only the traced chunks are profiled, and
nothing is written to disk.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field

#: the port's hand-written kernels (``firewheel_tpu_torch/csrc``), by the
#: name of their entry in the device trace
PORT_KERNELS = {
    "K1": ("biquad_seq_kernel",),
    "K2": ("mega_kernel",),
    "K3": ("island_kernel",),
    "K4": ("adpcm_encode_kernel",),
    "K5": ("sample_scan_kernel",),
    "K6": ("noise_uniform_kernel",),
    "K7": ("biquad_scan_kernel", "one_pole_scan_kernel"),
    "K8": ("biquad_bwd_kernel", "one_pole_bwd_kernel"),
    "K9": ("sample_scan_bwd_kernel",),
}

#: the harness's host spans, named ``fwbench.<step>``
SPAN_PREFIX = "fwbench."
TRACE_SPAN = SPAN_PREFIX + "trace"


@dataclass(frozen=True)
class DeviceOp:
    name: str
    start: float  # seconds on the profiler's clock
    end: float

    @property
    def seconds(self) -> float:
        return self.end - self.start


def port_kernel(name: str) -> str | None:
    """``"K1"``…``"K9"`` for a device op of the port's kernels, else None."""
    for tag, entries in PORT_KERNELS.items():
        if any(e in name for e in entries):
            return tag
    return None


def is_copy(name: str) -> bool:
    return name.startswith("Memcpy") or name.startswith("Memset")


@dataclass
class Trace:
    """One traced stretch of the window."""

    ops: list                      # DeviceOp, kernels and copies
    window: tuple                  # (start, end) of the traced stretch, seconds
    host: list = field(default_factory=list)   # (name, start, end) host events

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def kernels(self) -> list:
        return [o for o in self.ops if not is_copy(o.name)]

    def copies(self) -> list:
        """The device→host copies."""
        return [o for o in self.ops if o.name.startswith("Memcpy DtoH")]

    def busy_intervals(self) -> list:
        """The union of the device ops' intervals inside the window."""
        lo, hi = self.window
        spans = sorted((max(o.start, lo), min(o.end, hi)) for o in self.ops
                       if o.end > lo and o.start < hi)
        merged: list = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def idle_gaps(self, top: int = 10) -> list:
        """``[[what the host was doing, seconds], …]``: the device's idle
        time in the window, summed by the innermost host event at each
        gap's middle (under the harness's own span), longest first."""
        lo, hi = self.window
        edges = [lo] + [t for ab in self.busy_intervals() for t in ab] + [hi]
        gaps = sorted((0.5 * (a + b), b - a) for a, b in zip(edges[::2], edges[1::2])
                      if b > a)
        events = sorted((h for h in self.host if h[0] != TRACE_SPAN), key=lambda h: h[1])
        totals: dict = {}
        active: list = []      # heap of (end, start, name): events begun by now
        j = 0
        for mid, length in gaps:
            while j < len(events) and events[j][1] <= mid:
                heapq.heappush(active, (events[j][2], events[j][1], events[j][0]))
                j += 1
            while active and active[0][0] < mid:
                heapq.heappop(active)
            spans = [h for h in active if h[2].startswith(SPAN_PREFIX)]
            inner = min(active, key=lambda h: h[0] - h[1], default=None)
            outer = min(spans, key=lambda h: h[0] - h[1], default=None)
            label = outer[2] if outer else "outside the harness's spans"
            if inner is not None and inner is not outer:
                label += " > " + inner[2]
            totals[label[:120]] = totals.get(label[:120], 0.0) + length
        return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:top]]

    def device_ops(self, top: int = 10) -> list:
        """``[[device op, seconds], …]``, the most device time first."""
        totals: dict = {}
        for o in self.ops:
            key = o.name[:120]
            totals[key] = totals.get(key, 0.0) + o.seconds
        return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:top]]


def from_profile(prof) -> Trace:
    """A :class:`Trace` from a finished ``torch.profiler.profile`` whose
    traced stretch ran inside a ``record_function(TRACE_SPAN)``."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    ops, host, window = [], [], None
    for e in prof.events():
        start, end = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.device_type == cuda:
            # a host span shows on the device's timeline as an annotation
            if not e.name.startswith(SPAN_PREFIX):
                ops.append(DeviceOp(e.name, start, end))
        else:
            host.append((e.name, start, end))
            if e.name == TRACE_SPAN:
                window = (start, end)
    if window is None:
        raise RuntimeError(f"the profile holds no {TRACE_SPAN} span")
    return Trace(ops=ops, window=window, host=host)
