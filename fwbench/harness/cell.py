"""One cell of the benchmark, found by name, and one run of it.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``: a configuration
(``configs/<config>.json`` with its builder ``configs/<config>.py`` and
its plain reference ``reference/<config>.py``) under a traffic mix
(``traffic/<traffic>.json``).  Per-layer metrics are readers
``metrics/<metric>.py``.  Everything is found by the names in
``BENCHMARK.json``, so a cell, a configuration or a metric is added by
adding files.

A run builds the fleet (the program through the port's public builders,
the per-session params on the device from the seed), warms up the cell's
own shapes, then serves the window through the program's own loop,
``BatchRenderer.render_stream`` (render chunk t, start its copy to the
host, wait for chunk t−1's copy, hand it to the consumer), as many chunks
as fill the window's seconds at the warm-up's pace.  The consumer keeps
the rows of the compared sessions and nothing else.  After
the window the plain reference renders those sessions again and the
shipped int16 is compared with it.
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib.util
import json
import random
import statistics
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from . import trace as tracemod

ROOT = Path(__file__).resolve().parents[2]


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: Path):
    """Import the Python file ``path`` under a name of its own."""
    path = Path(path).resolve()
    tag = hashlib.sha1(str(path).encode()).hexdigest()[:8]
    name = f"fwbench_{path.stem.replace('.', '_').replace('-', '_')}_{tag}"
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def applies(entry: dict, cell: str) -> bool:
    """Whether a metric entry of ``BENCHMARK.json`` is reported in ``cell``."""
    return cell in entry.get("workloads", [cell])


class Cell:
    """A cell's files, found by its name in ``bench`` (``BENCHMARK.json``)
    under the checkout ``root``."""

    def __init__(self, bench: dict, name: str, traffic: dict | None = None,
                 root: Path = ROOT):
        here = Path(root) / "fwbench"
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.entry = found[0]
        self.name = name
        (conf,) = [c for c in bench["configs"] if c["name"] == self.entry["config"]]
        cfg_path = Path(root) / conf["file"]
        self.cfg = load_json(cfg_path)
        self.config = load_module(cfg_path.with_suffix(".py"))
        self.reference = load_module(here / "reference" / f"{conf['name']}.py")
        self.traffic = traffic or load_json(here / "traffic" / f"{self.entry['traffic']}.json")
        self.end_to_end = [m for m in bench["end_to_end"] if applies(m, name)]
        self.per_layer = [(m, load_module(here / "metrics" / f"{m['name']}.py"))
                          for m in bench["per_layer"] if applies(m, name)]

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])


@dataclass
class Fleet:
    """The program, its renderer and the fleet's params and state."""

    cell: Cell
    program: object
    renderer: object
    params: dict
    state: dict
    values: dict          # the benchmark's own per-session values, [B, ...]
    live: torch.Tensor    # bool[B]
    compared: list        # the sessions whose shipped audio is compared
    start_sample: int = 0


def build_fleet(cell: Cell, seed: int, device) -> Fleet:
    """Build the program and the fleet's trees, and draw every session's
    values on ``device`` from ``seed``."""
    from firewheel_tpu_torch.parallel.mesh import BatchRenderer

    t = cell.traffic
    batch, live_n = int(t["batch"]), int(t["live"])
    if batch % live_n:
        raise ValueError(f"{live_n} live sessions do not tile a batch of {batch}")
    program = cell.config.build(cell.cfg, device)
    renderer = BatchRenderer(program, batch, device=device,
                             output_format=t["output_format"], lowering=t["lowering"])
    params = renderer.stack_params()      # one instance broadcast on the device
    state = renderer.init_state()
    values = cell.config.session_values(cell.cfg, batch, seed, device)
    live = torch.arange(batch, device=device) % (batch // live_n) == 0
    if live_n < batch:
        cell.config.vacate(cell.cfg, values, ~live)
    cell.config.apply(program, params, values)
    live_rows = torch.nonzero(live).flatten().tolist()
    compared = sample_sessions(live_rows, int(t["compare_sessions"]), seed)
    return Fleet(cell, program, renderer, params, state, values, live, compared)


def sample_sessions(rows: list, count: int, seed: int) -> list:
    """``count`` of ``rows`` drawn from ``seed``, one from each of ``count``
    equal stretches, so that every part of the batch is compared."""
    rng = random.Random(int(seed) * 7919 + 17)
    count = min(count, len(rows))
    edges = [round(i * len(rows) / count) for i in range(count + 1)]
    return [rows[rng.randrange(a, b)] for a, b in zip(edges, edges[1:])]


@dataclass
class Served:
    """What a stretch of serving delivered."""

    chunks: int = 0
    landings: list = field(default_factory=list)   # host clock, each chunk landed
    enqueue_s: list = field(default_factory=list)  # render_chunk call to return
    captured: list = field(default_factory=list)   # int16[S, K, F, No] a chunk
    started: float = 0.0
    prof: object = None
    traced_counts: dict = field(default_factory=dict)


def serve(fleet: Fleet, *, chunks: int, trace_chunks: int = 0, trace_at: int = 1,
          counters=None) -> Served:
    """Serve ``chunks`` chunks through the program's own serving loop,
    ``BatchRenderer.render_stream`` (render chunk t, start its copy to the
    host, wait for chunk t−1's copy, hand it on), with a consumer that
    stamps each landing and keeps the compared sessions' rows, read in
    place: no whole-chunk copy.  ``render_chunk`` is timed from its call to
    its return.  With ``trace_chunks``, the renders and copies of that many
    chunks run under ``torch.profiler``, from the landing of chunk
    ``trace_at`` on, the device drained before and after them so that the
    profile holds their work and nothing else; ``counters()`` (the
    program's own counters, a dict) is read at both ends of the traced
    stretch and ``Served.traced_counts`` holds the difference."""
    r = fleet.renderer
    k = int(fleet.cell.traffic["blocks"])
    if trace_chunks:
        chunks = max(chunks, trace_at + trace_chunks + 2)
    rows = torch.tensor(fleet.compared)
    cuda = r.device.type == "cuda"
    out = Served()
    tracing: list = []      # (profiler, window span, counters at its start)

    def span(name):
        return (torch.profiler.record_function(tracemod.SPAN_PREFIX + name)
                if tracing else contextlib.nullcontext())

    render = r.render_chunk

    def timed_render(*args, **kw):
        t0 = time.perf_counter()
        with span("render"):
            result = render(*args, **kw)
        if not tracing:
            out.enqueue_s.append(time.perf_counter() - t0)
        return result

    def on_chunk(host):
        out.landings.append(time.perf_counter())
        with span("consume"):
            out.captured.append(torch.from_numpy(host)[rows].clone())
        landed = len(out.landings) - 1
        if trace_chunks and landed == trace_at:
            if cuda:
                torch.cuda.synchronize(r.device)
            acts = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
            window = torch.profiler.record_function(tracemod.TRACE_SPAN)
            window.__enter__()
            tracing.append((prof, window, counters() if counters else {}))
        elif tracing and landed == trace_at + trace_chunks:
            if cuda:
                torch.cuda.synchronize(r.device)
            prof, window, counted = tracing.pop()
            window.__exit__(None, None, None)
            prof.__exit__(None, None, None)
            if counters:
                out.traced_counts = {n: v - counted[n] for n, v in counters().items()}
            out.prof = prof

    prior = vars(r).get("render_chunk")
    r.render_chunk = timed_render
    try:
        out.started = time.perf_counter()
        _, fleet.state, fleet.start_sample = r.render_stream(
            fleet.params, fleet.state, num_chunks=chunks, num_blocks=k,
            start_sample=fleet.start_sample, on_chunk=on_chunk)
    finally:
        if prior is None:
            del r.render_chunk
        else:
            r.render_chunk = prior
    out.chunks = chunks
    return out


def chunk_seconds(served: Served) -> float:
    """A chunk's wall in steady serving, from a stretch of three chunks or
    more: the least gap between landings but the last, whose chunk's copy
    overlaps nothing (the first chunks may load the program and allocate
    the egress's pinned buffers)."""
    gaps = [b - a for a, b in zip(served.landings, served.landings[1:])][:-1]
    if not gaps:
        raise ValueError(f"{len(served.landings)} chunks give no steady gap")
    return min(gaps)


def shipped(fleet: Fleet, served: Served) -> dict:
    """The window's end-to-end readings: the audio of the live sessions
    that landed in host memory over the window's wall, and the gaps between
    successive landings."""
    t = fleet.cell.traffic
    k, f = int(t["blocks"]), fleet.program.max_block_frames
    wall = served.landings[-1] - served.started
    audio = int(fleet.live.sum()) * served.chunks * k * f / fleet.program.sample_rate
    gaps = [b - a for a, b in zip(served.landings, served.landings[1:])]
    return {"shipped_rtf": audio / wall, "gaps_s": gaps, "wall_s": wall}


def p95(values: list) -> float | None:
    """The 95th percentile (``statistics.quantiles``, exclusive), or None
    with fewer than 20 values."""
    if len(values) < 20:
        return None
    return statistics.quantiles(values, n=20)[18]


def compare(fleet: Fleet, captured: list, dt=torch.float64) -> dict:
    """Render the compared sessions again by the plain reference, from the
    stream's start through every captured chunk, and compare → ``{"max_lsb_gap",
    "failed_chunks", "sessions", "frames"}``."""
    shipped_audio = torch.cat(captured, dim=1)             # [S, n·K, F, No]
    s, nk, f, no = shipped_audio.shape
    shipped_audio = shipped_audio.reshape(s, nk * f, no).to(torch.int32)
    values = fleet.cell.config.rows(fleet.values, fleet.compared)
    ref = fleet.cell.reference.render(fleet.cell.cfg, values, nk * f, dt).to(torch.int32)
    gap = (shipped_audio - ref).abs()
    k = int(fleet.cell.traffic["blocks"])
    limit = fleet.cell.cfg["correct"]["max_lsb_gap"]
    per_chunk = gap.reshape(s, nk // k, k * f * no).amax(dim=(0, 2))
    return {"max_lsb_gap": int(gap.max()), "limit": limit,
            "failed_chunks": int((per_chunk > limit).sum()),
            "sessions": s, "frames": nk * f}


@dataclass
class TraceRun:
    """What a per-layer metric reads from the traced run."""

    trace: tracemod.Trace
    chunks: int
    blocks: int
    frames: int
    batch: int
    card: str
    islands: list          # (node kinds, channels in, channels out) a K3 island
    node_specs: dict
    enqueue_s: list
    window_peak_bytes: int
    port_launches: dict    # the program's own counters over the traced chunks
    notes: list = field(default_factory=list)

    def note(self, text: str) -> None:
        self.notes.append(text)


def islands(fleet: Fleet) -> list:
    """The hybrid's K3 islands as ``(node kinds, channels in, channels
    out)``, the channels found from the graph's dataflow (which buffers the
    island's nodes read from, or give to, nodes outside it)."""
    k = int(fleet.cell.traffic["blocks"])
    hy = fleet.renderer._chunk_cache.get(("hybrid", k))
    if hy is None:
        return []
    sched = fleet.program.schedule.schedule
    out = []
    for kind, nodes in hy.segments:
        if kind != "mega":
            continue
        ids = {sn.id for sn in nodes}
        writer: dict = {}
        ins, outs = set(), set()
        for sn in sched:
            for ib in sn.input_buffers:
                if ib.should_clear:
                    continue
                w = writer.get(ib.buffer_index)
                if sn.id in ids and w not in ids:
                    ins.add((ib.buffer_index, w))
                if sn.id not in ids and w in ids:
                    outs.add((ib.buffer_index, w))
            for ob in sn.output_buffers:
                writer[ob.buffer_index] = sn.id
        out.append(([_kind(sn) for sn in nodes], len(ins), len(outs)))
    return out


def _kind(sn) -> str:
    """A scheduled node's kind, the first part of its key."""
    from firewheel_tpu_torch.executor import node_key

    return node_key(sn.id).split("-")[0]
