"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

1. Prints the card's name and power limit.
2. Builds the sequential-biquad kernel (``firewheel_tpu_torch/csrc/
   biquad.cu``) with nvcc.
3. Holds the kernel against its plain PyTorch version on the card: at the
   main path's shape, at a ragged shape, with state carried across two
   calls and with a different filter per lane; prints both times.
4. Renders the 64-node mixer (filter on the kernel) with a BatchRenderer
   at B=8192 instances, K=32 blocks a chunk; checks finite outputs, the
   kernel's launch count (K per chunk) and the first instances against a
   CPU render of the same instances by the plain path; prints the
   realtime factor and the peak device memory.

The last line of standard output is one JSON object with ``"ok": true``;
the line before it lists each kernel with its launches, error and times.
Any failure raises and exits non-zero without that line.  Without a CUDA
device, or without the package beside this file, it exits non-zero too.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

B = 8192              # instances (the README's headline configuration)
K = 32                # blocks per chunk
TIMED_CHUNKS = 3
CHECK_INSTANCES = 2   # instances re-rendered on the CPU by the plain path
KERNEL_TOL = 1e-6     # kernel vs plain version on the card
SLICE_TOL = 1e-5      # card render vs CPU render of the same instances


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def check_kernel(seq_iir, iir):
    """Phase 3: the kernel against its plain version on the card."""
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(1234)

    def case(lanes, frames):
        x = torch.randn((lanes, frames), generator=gen).to(dev)
        z = tuple(0.1 * torch.randn((lanes,), generator=gen).to(dev)
                  for _ in range(2))
        # a different lowpass per lane: 200 Hz .. 20 kHz, Q 0.5 .. 4
        freq = 200.0 + 19800.0 * torch.rand((lanes,), generator=gen)
        q = 0.5 + 3.5 * torch.rand((lanes,), generator=gen)
        coeffs = iir.biquad_lowpass(freq.to(dev), q.to(dev), 48000)
        return x, z, coeffs

    def err(a, b):
        return float((a - b).abs().max())

    worst = 0.0
    # the main path's shape (B instances x 2 channels) and a ragged one
    for lanes, frames in ((2 * B, 128), (1000, 100)):
        x, z, c = case(lanes, frames)
        y, (z1, z2) = seq_iir.biquad_seq(x, z, c)
        yr, (r1, r2) = seq_iir.biquad_seq_reference(x, z, c)
        torch.cuda.synchronize()
        e = max(err(y, yr), err(z1, r1), err(z2, r2))
        log(f"K1 vs plain, lanes={lanes} F={frames}: max_abs_err={e:.3e}")
        if not e <= KERNEL_TOL:
            raise AssertionError(f"K1 disagrees with its plain version: {e}")
        worst = max(worst, e)

    # state carried across two calls == one call over both halves
    x, z, c = case(2 * B, 256)
    y1, zm = seq_iir.biquad_seq(x[:, :128].contiguous(), z, c)
    y2, (z1, z2) = seq_iir.biquad_seq(x[:, 128:].contiguous(), zm, c)
    yr, (r1, r2) = seq_iir.biquad_seq_reference(x, z, c)
    torch.cuda.synchronize()
    e = max(err(torch.cat([y1, y2], 1), yr), err(z1, r1), err(z2, r2))
    log(f"K1 vs plain, state carried over 2 calls: max_abs_err={e:.3e}")
    if not e <= KERNEL_TOL:
        raise AssertionError(f"K1 state carry disagrees: {e}")
    worst = max(worst, e)

    # times at the main path's shape
    x, z, c = case(2 * B, 128)
    ms = cuda_ms(lambda: seq_iir.biquad_seq(x, z, c), 200)
    plain_ms = cuda_ms(lambda: seq_iir.biquad_seq_reference(x, z, c), 10)
    log(f"K1 time at lanes={2 * B} F=128: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms")
    return worst, ms, plain_ms


def render_mixer(ft, seq_iir, card: str):
    """Phase 4: the 64-node mixer at B x K on the card."""
    from firewheel_tpu_torch.convert import tree_map

    prog = ft.mixer_graph(device="cuda")
    n_nodes = len(prog.schedule.schedule)
    if n_nodes != 64:
        raise AssertionError(f"mixer has {n_nodes} nodes, expected 64")
    br = ft.BatchRenderer(prog, B, device="cuda")
    params = br.stack_params()
    # a different cutoff per instance, so the kernel runs per-lane filters
    fkey = next(k for k in params if k.startswith("filter"))
    params[fkey]["freq"] = 8000.0 - 100.0 * (
        torch.arange(B, device="cuda") % 64
    ).to(torch.float32)
    state = br.init_state()

    cpu_prog = ft.mixer_graph(device="cpu")
    cpu_br = ft.BatchRenderer(cpu_prog, CHECK_INSTANCES, device="cpu")
    cpu_params = tree_map(lambda t: t[:CHECK_INSTANCES].cpu(), params)
    cpu_state = tree_map(lambda t: t[:CHECK_INSTANCES].cpu(), state)

    worst = 0.0

    def compare(tag, out, cpu_out):
        nonlocal worst
        e = float((out[:CHECK_INSTANCES].cpu() - cpu_out).abs().max())
        worst = max(worst, e)
        if not e <= SLICE_TOL:
            raise AssertionError(f"{tag}: card vs CPU max_abs_err {e}")

    sample = 0
    # warm-up chunk (allocator, kernel load), checked like the others
    out, om, state = br.render_chunk(params, state, start_sample=sample,
                                     num_blocks=K)
    cpu_out, cpu_om, cpu_state = cpu_br.render_chunk(
        cpu_params, cpu_state, start_sample=sample, num_blocks=K)
    compare("warm-up chunk", out, cpu_out)
    sample += K * prog.max_block_frames

    seq_iir.biquad_seq.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    outs = []
    t0 = time.perf_counter()
    for _ in range(TIMED_CHUNKS):
        out, om, state = br.render_chunk(params, state, start_sample=sample,
                                         num_blocks=K)
        outs.append((out, om, sample))
        sample += K * prog.max_block_frames
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / TIMED_CHUNKS
    launches = seq_iir.biquad_seq.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    if launches != K * TIMED_CHUNKS:
        raise AssertionError(
            f"K1 launched {launches} times in {TIMED_CHUNKS} chunks of K={K}"
        )
    for out, om, start in outs:
        if tuple(out.shape) != (B, K, prog.num_graph_outputs,
                                prog.max_block_frames):
            raise AssertionError(f"output shape {tuple(out.shape)}")
        if not bool(torch.isfinite(out).all()):
            raise AssertionError("non-finite output")
        cpu_out, cpu_om, cpu_state = cpu_br.render_chunk(
            cpu_params, cpu_state, start_sample=start, num_blocks=K)
        compare(f"chunk at sample {start}", out, cpu_out)
        if not torch.equal(om[:CHECK_INSTANCES].cpu(), cpu_om):
            raise AssertionError("silence masks differ between card and CPU")
    final = tree_map(lambda t: t[:CHECK_INSTANCES].cpu(), state)

    def state_err(a, b):
        if a.dtype.is_floating_point:
            return float((a - b).abs().max())
        return 0.0 if torch.equal(a, b) else float("inf")

    errs = []
    tree_map(lambda a, b: errs.append(state_err(a, b)), final, cpu_state)
    if not max(errs) <= SLICE_TOL:
        raise AssertionError(f"final state differs: {max(errs)}")
    peak = float(out.abs().max())
    if not 0.01 < peak <= 1.0:
        raise AssertionError(f"output peak {peak} outside (0.01, 1]")

    audio_secs = B * K * prog.max_block_frames / prog.sample_rate
    log(f"mixer: {n_nodes} nodes, B={B}, K={K}, {TIMED_CHUNKS} timed chunks "
        f"on {card}")
    log(f"mixer: card vs CPU plain path (first {CHECK_INSTANCES} instances, "
        f"{TIMED_CHUNKS + 1} chunks and final state): max_abs_err={worst:.3e}")
    log(f"mixer: wall per chunk {wall * 1e3:.3f} ms, realtime factor "
        f"{audio_secs / wall:.1f}, peak device memory {peak_gb:.3f} GB, "
        f"K1 launches {launches} ({launches // TIMED_CHUNKS} per chunk)")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import firewheel_tpu_torch as ft
    from firewheel_tpu_torch.ops import iir, seq_iir

    if not os.path.abspath(ft.__file__).startswith(here + os.sep):
        raise RuntimeError(f"firewheel_tpu_torch imported from {ft.__file__}")
    if "jax" in sys.modules or "firewheel_tpu" in sys.modules:
        raise RuntimeError("the port imported JAX")

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    seq_iir.build_biquad_kernel(verbose=True)
    log(f"K1 built in {time.perf_counter() - t0:.1f} s")

    err, ms, plain_ms = check_kernel(seq_iir, iir)
    launches = render_mixer(ft, seq_iir, card)
    if "jax" in sys.modules:
        raise RuntimeError("the port imported JAX")

    kernels = [{
        "name": "biquad_seq",
        "route": "cuda",
        "source": "firewheel_tpu_torch/csrc/biquad.cu",
        "replaces": "firewheel_tpu/ops/pallas_iir.py:50",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
