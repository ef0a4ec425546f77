"""One run of one cell → the result line.

``run_cell`` is the whole run after the look for a card: build, warm up,
serve for the window, read the metrics, free the program, compare with the
reference.  ``fwbench/run.py`` makes the look and prints the line.
"""

from __future__ import annotations

import gc
import math
import sys
import time

import torch

from . import cell as cellmod
from . import trace as tracemod

#: top-level modules that may not be loaded once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "firewheel_tpu")


def loaded_forbidden() -> list:
    """The forbidden top-level names that ``sys.modules`` holds, compared
    whole (``firewheel_tpu_torch`` is not ``firewheel_tpu``)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def _built_libraries() -> set:
    from firewheel_tpu_torch.ops import cuda_build

    d = cuda_build.BUILD_DIR
    return {p.name for p in d.glob("*.so")} if d.exists() else set()


def run_cell(bench: dict, workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", traffic: dict | None = None, t_start: float | None = None,
             fault=None, root=cellmod.ROOT, chunks: int = 0) -> dict:
    """Run ``workload`` once → the result dict (the keys of the line).
    ``traffic`` replaces the cell's traffic file (tests run small
    fleets); ``fault`` is called with the fleet before the window (tests
    break the timed path with it); ``root`` is the checkout whose
    ``fwbench/`` holds the cell's files.  The window renders as many
    chunks as fill ``seconds`` at the pace of the warm-up's steady chunks,
    and ``chunks`` at least."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = cellmod.Cell(bench, workload, traffic, root)
    device = torch.device(device)
    cuda = device.type == "cuda"
    t = cell.traffic
    k = int(t["blocks"])

    before = _built_libraries()
    fleet = cellmod.build_fleet(cell, seed, device)
    # warm up the cell's own shapes, on the fleet itself: the first chunk
    # loads (or builds) the port's libraries
    t0 = time.perf_counter()
    warm = cellmod.serve(fleet, chunks=int(t["warm_chunks"]))
    if cuda:
        torch.cuda.synchronize(device)
    built = sorted(_built_libraries() - before)
    chunk_s = cellmod.chunk_seconds(warm)
    log(f"fwbench: {workload} seed {seed}: warm-up {len(warm.landings)} chunks "
        f"{time.perf_counter() - t0:.3f} s, {1e3 * chunk_s:.3f} ms a chunk"
        + (f", built {', '.join(built)} in it" if built else ", nothing built"))
    hy = fleet.renderer._chunk_cache.get(("hybrid", k))
    if hy is not None:
        log("fwbench: partition " + " | ".join(
            f"{'K3' if kind == 'mega' else 'torch'}({len(nodes)} nodes: "
            f"{', '.join(sorted({cellmod._kind(sn) for sn in nodes}))})"
            for kind, nodes in hy.segments))
    if fault is not None:
        fault(fleet)
    process_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    # as many chunks as fill the window at the warm-up's pace
    served = cellmod.serve(fleet, chunks=max(chunks, math.ceil(seconds / chunk_s)),
                           trace_chunks=int(t["trace_chunks"]) if trace else 0,
                           counters=_program_counters)
    if cuda:
        torch.cuda.synchronize(device)
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    forbidden = loaded_forbidden()
    if forbidden:
        raise SystemExit(f"fwbench: the run loaded {', '.join(forbidden)}")

    e2e = cellmod.shipped(fleet, served)
    log(f"fwbench: window {e2e['wall_s']:.3f} s, {served.chunks} chunks, "
        f"render_chunk's host enqueue {1e3 * sum(served.enqueue_s) / max(1, len(served.enqueue_s)):.3f} ms a call")
    metrics: dict = {}
    device_info = {"platform": "gpu" if cuda else device.type,
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "count": cell.chips,
                   "memory_peak_bytes": int(max(process_peak, window_peak))}
    breakdown = None
    if trace:
        tr = tracemod.from_profile(served.prof)
        run = cellmod.TraceRun(
            trace=tr, chunks=int(t["trace_chunks"]), blocks=k,
            frames=fleet.program.max_block_frames, batch=int(t["batch"]),
            card=device_info["kind"],
            islands=cellmod.islands(fleet), node_specs=cell.config.node_kinds(cell.cfg),
            enqueue_s=served.enqueue_s, window_peak_bytes=int(window_peak),
            port_launches=served.traced_counts)
        for entry, reader in cell.per_layer:
            value = reader.read(run)
            if value is not None:
                metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
            else:
                log(f"fwbench: {entry['name']} left out")
        for text in run.notes:
            log(f"fwbench: {text}")
        device_info["busy_s"] = tr.busy_s()
        device_info["window_s"] = tr.window_s
        breakdown = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    else:
        for entry in cell.end_to_end:
            name = entry["name"]
            if name == "setup_s":
                value = setup_s
            elif name == "shipped_rtf":
                value = e2e["shipped_rtf"]
            elif name == "chunk_p95_ms":
                value = cellmod.p95(e2e["gaps_s"])
                value = None if value is None else 1e3 * value
            else:
                raise KeyError(f"fwbench has no reading for {name!r}")
            if value is None:
                raise RuntimeError(f"{name}: the window delivered {served.chunks} chunks, "
                                   "too few to read it")
            if name == "chunk_p95_ms" and len(e2e["gaps_s"]) < 200:
                log(f"fwbench: chunk_p95_ms from {len(e2e['gaps_s'])} gaps, fewer than 200")
            metrics[name] = {"value": value, "unit": entry["unit"]}

    # the program's state goes before the reference runs
    captured = warm.captured + served.captured
    fleet.params = fleet.state = fleet.renderer = fleet.program = None
    del warm, served
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    check = cellmod.compare(fleet, captured)
    correct = check["max_lsb_gap"] <= check["limit"]
    log(f"fwbench: reference over {check['sessions']} sessions x {check['frames']} frames "
        f"in {time.perf_counter() - t0:.3f} s")
    log(f"check: max_lsb_gap {check['max_lsb_gap']} limit {check['limit']}")
    result = {"correct": bool(correct), "attempted": len(captured),
              "failed": check["failed_chunks"], "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = {"max_lsb_gap": {"value": check["max_lsb_gap"],
                                       "limit": check["limit"]}}
    return result


def _program_counters() -> dict:
    """The program's own launch counters (the hybrid's island kernel)."""
    from firewheel_tpu_torch.executor_hybrid import HybridMegaRenderer

    return {"K3": HybridMegaRenderer.launches}
