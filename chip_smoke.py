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
5. Renders the same mixer at B=8192, K=32 with the megakernel
   (``csrc/megakernel.cu``) and, from the same params and state, with the
   eager BatchRenderer on the card (its plain version at full size):
   outputs, masks and every state leaf must agree; the first instances
   must match the CPU plain version; the kernel must launch once a chunk
   and K1 never (the filter runs inside it); state handed from an eager
   chunk to a megakernel chunk must render what two eager chunks do.
   Prints both lowerings' wall per chunk and realtime factor.
6. Holds the megakernel against its plain version on the card on three
   seeded random graphs at B=64, K=4.

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
# megakernel vs eager on the card: masks and integer leaves exactly, floats
# to 1e-5 (the meter's mean sums in another order; sin/exp round alike)
MEGA_TOL = 1e-5
RANDOM_SEEDS = (0, 1, 2)
RANDOM_B, RANDOM_K = 64, 4


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


def tree_err(a: dict, b: dict) -> float:
    """Largest difference between two trees of tensors: float leaves by
    max abs difference, others (masks, int32/int64) inf unless equal."""
    errs = []

    def err(x, y):
        x, y = x.cpu(), y.cpu()
        if x.shape != y.shape:
            errs.append(float("inf"))
        elif x.dtype.is_floating_point:
            errs.append(float((x - y).abs().max()) if x.numel() else 0.0)
        else:
            errs.append(0.0 if torch.equal(x, y) else float("inf"))

    from firewheel_tpu_torch.convert import tree_map
    tree_map(err, a, b)
    return max(errs, default=0.0)


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
    # a different cutoff per instance, so the kernel runs per-lane filters
    params = mixer_params(br)
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

    e = tree_err(final, cpu_state)
    if not e <= SLICE_TOL:
        raise AssertionError(f"final state differs: {e}")
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


def mixer_params(renderer):
    """The mixer's params with a different cutoff per instance (phase 4's)."""
    params = renderer.stack_params()
    fkey = next(k for k in params if k.startswith("filter"))
    params[fkey]["freq"] = 8000.0 - 100.0 * (
        torch.arange(B, device="cuda") % 64
    ).to(torch.float32)
    return params


def render_mega(ft, seq_iir, em, card: str):
    """Phase 5: the megakernel on the mixer at B x K, against the eager
    BatchRenderer on the card and the CPU plain version."""
    from firewheel_tpu_torch.convert import tree_map

    prog = ft.mixer_graph(device="cuda")
    mega = em.MegaRenderer(prog, B, K, device="cuda")
    eager = ft.BatchRenderer(prog, B, device="cuda")
    params = mixer_params(mega)
    state0 = mega.init_state()
    frames = prog.max_block_frames
    log(f"megakernel: {len(mega.lowered.keys)} rows, {len(mega.lowered.leaves)} "
        f"leaves, {mega.lowered.num_buffers} buffers, "
        f"{em.shared_bytes(mega.lowered, mega.tile)} B shared memory per CTA")

    worst = 0.0

    def agree(tag, mo, mm, ms, eo, emk, es):
        nonlocal worst
        out_e, state_e = float((mo - eo).abs().max()), tree_err(ms, es)
        e = max(out_e, state_e)
        if not torch.equal(mm, emk):
            raise AssertionError(f"{tag}: masks differ between megakernel and eager")
        if not e <= MEGA_TOL:
            raise AssertionError(f"{tag}: megakernel vs eager max_abs_err {e}")
        log(f"megakernel vs eager, {tag}: outputs {out_e:.3e}, state {state_e:.3e}")
        worst = max(worst, e)

    # warm-up chunk (kernel load, allocator), checked like the others
    m_out, m_mask, m_state = mega.render_chunk(params, state0, 0)
    e_out, e_mask, e_state = eager.render_chunk(params, state0, start_sample=0,
                                                num_blocks=K)
    torch.cuda.synchronize()
    agree("warm-up chunk", m_out, m_mask, m_state, e_out, e_mask, e_state)
    warm = (m_out, m_mask, m_state)
    starts = [(c + 1) * K * frames for c in range(TIMED_CHUNKS)]

    # the main path: the megakernel only, counts set to 0 just before
    em.MegaRenderer.launches = 0
    seq_iir.biquad_seq.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m_runs = []
    for start in starts:
        m_out, m_mask, m_state = mega.render_chunk(params, m_state, start)
        m_runs.append((m_out, m_mask, m_state))
    torch.cuda.synchronize()
    mega_wall = (time.perf_counter() - t0) / TIMED_CHUNKS
    launches = em.MegaRenderer.launches
    k1_launches = seq_iir.biquad_seq.launches
    if launches != TIMED_CHUNKS:
        raise AssertionError(f"megakernel launched {launches} times in "
                             f"{TIMED_CHUNKS} chunks")
    if k1_launches != 0:
        raise AssertionError(f"K1 launched {k1_launches} times inside "
                             "megakernel chunks")

    # the plain version at full size: the eager BatchRenderer on the card
    t0 = time.perf_counter()
    e_runs = []
    for start in starts:
        e_out, e_mask, e_state = eager.render_chunk(
            params, e_state, start_sample=start, num_blocks=K)
        e_runs.append((e_out, e_mask, e_state))
    torch.cuda.synchronize()
    eager_wall = (time.perf_counter() - t0) / TIMED_CHUNKS
    for start, m, e in zip(starts, m_runs, e_runs):
        agree(f"chunk at sample {start}", *m, *e)
        if not bool(torch.isfinite(m[0]).all()):
            raise AssertionError("non-finite megakernel output")
    peak = float(m_runs[-1][0].abs().max())
    if not 0.01 < peak <= 1.0:
        raise AssertionError(f"megakernel output peak {peak} outside (0.01, 1]")

    # mid-stream handoff: eager chunk 1 → megakernel chunk 2 == eager, eager
    h_out, h_mask, h_state = mega.render_chunk(params, e_runs[0][2], starts[1])
    torch.cuda.synchronize()
    agree("handoff eager → megakernel", h_out, h_mask, h_state, *e_runs[1])
    log(f"megakernel: handoff eager chunk → megakernel chunk matches two "
        f"eager chunks")

    # the first instances against the CPU plain version
    cpu_prog = ft.mixer_graph(device="cpu")
    cpu_mega = em.MegaRenderer(cpu_prog, CHECK_INSTANCES, K, device="cpu")
    cpu_params = tree_map(lambda t: t[:CHECK_INSTANCES].cpu(), params)
    cpu_state = tree_map(lambda t: t[:CHECK_INSTANCES].cpu(), state0)
    cpu_worst = 0.0
    for start, (m_out, m_mask, m_state) in zip([0] + starts, [warm] + m_runs):
        c_out, c_mask, cpu_state = cpu_mega.render_chunk(cpu_params, cpu_state,
                                                         start)
        e = float((m_out[:CHECK_INSTANCES].cpu() - c_out).abs().max())
        if not e <= SLICE_TOL or not torch.equal(m_mask[:CHECK_INSTANCES].cpu(),
                                                 c_mask):
            raise AssertionError(f"megakernel vs CPU plain version at sample "
                                 f"{start}: max_abs_err {e} or masks differ")
        cpu_worst = max(cpu_worst, e)
    e = tree_err(tree_map(lambda t: t[:CHECK_INSTANCES], m_runs[-1][2]), cpu_state)
    if not e <= SLICE_TOL:
        raise AssertionError(f"megakernel final state vs CPU: {e}")
    cpu_worst = max(cpu_worst, e)

    audio_secs = B * K * frames / prog.sample_rate
    log(f"megakernel vs eager on the card ({TIMED_CHUNKS + 2} chunks, outputs, "
        f"masks and every state leaf): max_abs_err={worst:.3e}")
    log(f"megakernel vs CPU plain version (first {CHECK_INSTANCES} instances, "
        f"{TIMED_CHUNKS + 1} chunks and final state): max_abs_err={cpu_worst:.3e}")
    log(f"megakernel: launches {launches} in {TIMED_CHUNKS} chunks, K1 launches "
        f"{k1_launches}")
    log(f"mixer B={B} K={K} on {card}: megakernel wall per chunk "
        f"{mega_wall * 1e3:.3f} ms (realtime factor {audio_secs / mega_wall:.1f}); "
        f"eager {eager_wall * 1e3:.3f} ms (realtime factor "
        f"{audio_secs / eager_wall:.1f})")
    return launches, worst, mega_wall * 1e3, eager_wall * 1e3


def check_random_graphs(ft, em):
    """Phase 6: the megakernel against its plain version on the card, on
    seeded random graphs."""
    from firewheel_tpu_torch.mixer import random_graph, vary_params

    worst = 0.0
    for seed in RANDOM_SEEDS:
        prog = random_graph(seed, device="cuda")
        mega = em.MegaRenderer(prog, RANDOM_B, RANDOM_K, device="cuda")
        params = vary_params(mega.stack_params(), seed)
        ms = rs = mega.init_state()
        for c in range(2):
            start = c * RANDOM_K * prog.max_block_frames
            mo, mm, ms = mega.render_chunk(params, ms, start)
            ro, rm, rs = em.mega_chunk_reference(
                prog, mega.lowered, params, rs, start, RANDOM_K, RANDOM_B)
            torch.cuda.synchronize()
            out_e = float((mo - ro).abs().max())
            state_e = tree_err(ms, rs)
            e = max(out_e, state_e)
            if not torch.equal(mm, rm) or not e <= MEGA_TOL:
                raise AssertionError(
                    f"random graph {seed}, chunk {c}: megakernel vs plain "
                    f"max_abs_err {e}, masks equal {torch.equal(mm, rm)}")
            worst = max(worst, e)
        log(f"random graph {seed}: {len(prog.schedule.schedule)} nodes, "
            f"{prog.schedule.num_buffers} buffers, megakernel vs plain version "
            f"on the card: outputs {out_e:.3e}, state {state_e:.3e} "
            f"(last chunk), masks equal")
    log(f"random graphs {RANDOM_SEEDS} at B={RANDOM_B} K={RANDOM_K}: "
        f"max_abs_err={worst:.3e}")
    return worst


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import firewheel_tpu_torch as ft
    from firewheel_tpu_torch import executor_mega as em
    from firewheel_tpu_torch.ops import cuda_build, iir, seq_iir

    if not os.path.abspath(ft.__file__).startswith(here + os.sep):
        raise RuntimeError(f"firewheel_tpu_torch imported from {ft.__file__}")
    if "jax" in sys.modules or "firewheel_tpu" in sys.modules:
        raise RuntimeError("the port imported JAX")

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    cuda_build.build_all([seq_iir.LIBRARY, em.LIBRARY], verbose=True)
    log(f"K1 and the megakernel built in {time.perf_counter() - t0:.1f} s")

    err, ms, plain_ms = check_kernel(seq_iir, iir)
    launches = render_mixer(ft, seq_iir, card)
    m_launches, m_err, m_ms, m_plain_ms = render_mega(ft, seq_iir, em, card)
    r_err = check_random_graphs(ft, em)
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
    }, {
        "name": "megakernel",
        "route": "cuda",
        "source": "firewheel_tpu_torch/csrc/megakernel.cu",
        "replaces": "firewheel_tpu/executor_pallas.py:218",
        "launches": m_launches,
        "max_abs_err": max(m_err, r_err),
        "ms": m_ms,
        "plain_ms": m_plain_ms,
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
