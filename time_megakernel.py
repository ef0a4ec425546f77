"""Device time of the sequential biquad (K1), the megakernel (K2), the
island kernel (K3), the ADPCM encoder (K4), the sample scans (K5), the
noise draw (K6), the associative scans (K7) and their backwards (K8, K9) on
one NVIDIA GPU, for the port in a given checkout.

Run from the root of a checkout:

    python3 time_megakernel.py [--root DIR] [--kernels k1,k2,k2rows,k3,palette,k7,k4,k5,k6,k8,k9]

``--root`` names the checkout whose ``firewheel_tpu_torch`` is timed (this
one by default), so that two designs can be timed in one run on one card;
``--kernels`` the measurements below to take (all by default).
Each time is the kernel's device time per launch by ``torch.profiler`` over
10 launches after a warm-up, every launch from the same params and state:

* K1 at F=128 on 16 384 lanes (the eager mixer at B=8192) and 2 048 lanes
  (the effects chain at B=1024), with a lowpass per lane and with one per
  instance over its two channels (the filter node's call), beside a call's
  time with the wrapper's host work (CUDA events over 200 calls);
* K2 on the 64-node mixer at B=8192, K=32 with a cutoff per instance
  (``chip_smoke.py`` phase 5), with every pan and volume smoother at rest;
* the same chunk with every smoother ramping: each pan and volume moved by
  2e-3, so that it ramps for ~20 of the 32 blocks, settles and rests;
* (k2rows) K2 at rest with the rows of one kind replaced by the dummy device
  function, which writes zeros (not a valid render): what is saved is what
  that kind of row costs, and with every row a dummy what is left is the
  walk itself (tables, leaves, flags, outputs);
* (k2rows) K2 at rest on the same mixer compiled in blocks of 127 frames (K=32):
  the kernel's instantiation for any block length, with its padded arena
  rows (a checkout whose kernel refuses the block prints so);
* K3 on the effects chain's island (filter, echo, clip) inside the hybrid
  lowering at B=8192, K=32 and B=1024, K=8 (phase 7);
* the FX palette's lowerings at B=1024, K=8 (``chip_smoke.py`` 13(c), its
  checks included): K2 on the palette without the flanger, and K3 on the
  hybrid's two islands around it, the two islands' times summed (a
  checkout without the FX rows or without ``biquad_cascade`` skips this);
* K7 at ``chip_smoke.SCAN_TIMED``'s shapes: ``biquad_scan`` and
  ``one_pole_scan`` at f32[16384, 128] (the batched rows), the one-pole at
  f32[1048576, 128] (the spatial scene's pooled spatializers), both at
  [2, 128] and [2, 256] (the streams' rows), and ``biquad_cascade`` of 3
  and 2 sections (the EQ's bands, the meter's K-weighting) at the batched
  and the streams' rows, and both at f32[16384, 16384] (rows past shared
  memory), beside a call's time (CUDA events over 50 calls, 3 for the long
  rows) and the bound; a checkout without ``biquad_cascade`` runs the sections
  as that many ``biquad_scan`` calls, and its device time is their sum;
* (k4, k5, k6) as ``chip_smoke.py`` phase 3(b) times them: K4 at the
  adpcm4 fleet's int16[8192, 4096, 2], K5 each kind at ``K5_TIMED`` (the
  batched bus's lanes, the pink's 16 384, and the streams' [1, 256] and
  [2, 256]) with the coefficients per lane, K6 at ``K6_TIMED``'s
  f32[8192, 2, 128] and the stream's [1, 2, 256] and at ``K6_SWEEP``'s
  draws around its run lengths' thresholds; each beside a call's time
  (CUDA events over 50 calls, 20 for K4) and its bound; for K6 also
  ptxas's report of its entries (one a run length) and their SASS
  (``cuobjdump -sass``) counted by opcode, split at each entry's barrier:
  what comes before it hashes the CTA's lane keys, what comes after is a
  thread's run of elements;
* (k8, k9) as ``chip_smoke.py`` phases 17(a) and 17(b) time them: K8 (the
  backwards of K7's scans) at ``K8_TIMED``'s cases (the EQ's cascade of
  three sections, two and eight, one section and the one-pole at
  f32[16384, 128], the one-pole at the pooled spatializers' rows, one
  section at [2, 128]) and K9 (K5's backward) each kind at ``K5_TIMED``'s
  shapes, each beside a call's time (CUDA events over 50 calls) and its
  bound, and ptxas's report of their entries where this run built them.
  They are not in the default set: name them.

Prints the card's name, power limit and highest SM clock, then one JSON
object a measurement.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys

import torch

from chip_smoke import card_line, cuda_ms, device_ms

K1_LANES = (16384, 2048)
MIXER = (8192, 32)
EFFECTS = ((8192, 32), (1024, 8))
REPS = 10
#: K6's draws beside chip_smoke.K6_TIMED, (lanes, channels, frames): on
#: both sides of each threshold of ops/noise.py:RUNS (2^16 and 2^20
#: elements), the hybrid bus's at B=1024, and small ones
K6_SWEEP = ((2, 2, 256), (32, 2, 128), (255, 2, 128), (256, 2, 128), (1024, 2, 128),
            (4095, 2, 128), (4096, 2, 128))
RAMP_STEP = 2e-3
# op codes (csrc/megakernel.cu:OpCode) replaced by the dummy (0)
DUMMIES = {
    "beep": (1,), "volume": (2,), "pan": (3,), "sum": (4,), "filter": (5,),
    "echo": (6,), "clip+meter": (7, 8), "all": (1, 2, 3, 4, 5, 6, 7, 8),
}


def move_smoothed(params: dict) -> dict:
    """A copy of ``params`` with every pan and volume moved by ``RAMP_STEP``
    (a pan near +1 moves down)."""
    moved = {key: dict(p) for key, p in params.items()}
    for p in moved.values():
        if "pan" in p:
            p["pan"] = torch.where(p["pan"] > 0.5, p["pan"] - RAMP_STEP,
                                   p["pan"] + RAMP_STEP)
        if "raw_gain" in p:
            p["raw_gain"] = p["raw_gain"] * (1.0 + RAMP_STEP)
    return moved


def time_k7(iir, emit) -> None:
    """K7 at SCAN_TIMED's shapes (see the module's docstring)."""
    import types

    from chip_smoke import (K7_KERNEL, SCAN_TIMED, SCAN_TIMED_LONG, bound, k7_operands,
                            scan_work)

    chained = not hasattr(iir, "biquad_cascade")
    if chained:
        def chain(scan):
            def run(x, states, sections):
                out = []
                for z, c in zip(states, sections):
                    x, z = scan(x, z, c)
                    out.append(z)
                return x, tuple(out)
            return run
        iir = types.SimpleNamespace(**vars(iir), biquad_cascade=chain(iir.biquad_scan),
                                    biquad_cascade_reference=chain(
                                        iir.biquad_scan_reference))
    gen = torch.Generator().manual_seed(77)
    for kind, rows, n, sections in SCAN_TIMED + SCAN_TIMED_LONG:
        fn, _, args = k7_operands(iir, kind, rows, n, gen, sections)
        launches = sections if chained and kind == "cascade" else 1
        reps = 3 if n > 1024 else REPS
        ms = device_ms(lambda: fn(*args), K7_KERNEL[kind], reps, launches)
        call_ms = cuda_ms(lambda: fn(*args), reps if n > 1024 else 50)
        b_ms = bound(*scan_work(kind, rows, n, sections))[0]
        emit(kernel="K7", entry=kind, rows=rows, frames=n, sections=sections,
             launches=launches, device_ms=ms, call_ms=call_ms, bound_ms=b_ms,
             share=b_ms / ms)
        del args
        torch.cuda.empty_cache()


def sass_counts(library, kernel: str) -> dict:
    """The SASS of each entry of ``library`` (a built ``CudaLibrary``) whose
    name contains ``kernel``, by ``cuobjdump -sass``, by entry: instructions
    counted by opcode (with its modifiers), those up to the entry's first
    barrier (``BAR``) apart from those after it."""
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(library.path())], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    entries, parts, part = {}, None, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            parts = None
            if kernel in name:
                parts = entries[name] = {"up_to_barrier": collections.Counter(),
                                         "after_barrier": collections.Counter()}
                part = "up_to_barrier"
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if parts is not None and m:
            parts[part][m.group(1)] += 1
            if m.group(1).startswith("BAR"):
                part = "after_barrier"
    return {name: {where: {"total": sum(c.values()), "by_opcode": dict(c.most_common())}
                   for where, c in parts.items()}
            for name, parts in entries.items()}


def time_k456(ops, take, emit) -> None:
    """K4 at the adpcm4 fleet's chunk, K5 (each kind) at ``chip_smoke.
    K5_TIMED``'s shapes and K6 at ``K6_TIMED``'s, as phase 3(b) times them."""
    from chip_smoke import (B, K, K4_OPS, K5_KINDS, K5_OPS, K5_TIMED, K6_TIMED,
                            NOISE_SAMPLE, bound, k5_lanes, k5_work, k6_work,
                            scan_operands)

    gen = torch.Generator().manual_seed(4321)
    if "k4" in take:
        s = K * 128
        pcm = (torch.randn((B, s, 2), generator=gen) * 6000).clamp(-32768, 32767)
        pcm = pcm.to(torch.int16).to("cuda")
        fn = lambda: ops.adpcm_device.encode_ima_chunk(pcm)  # noqa: E731
        ms = device_ms(fn, "adpcm_encode", REPS)
        call_ms = cuda_ms(fn, 20)
        b_ms = bound(pcm.numel() * 2 + fn().numel(), K4_OPS * pcm.numel())[0]
        emit(kernel="K4", shape=list(pcm.shape), device_ms=ms, call_ms=call_ms,
             bound_ms=b_ms, share=b_ms / ms, ns_a_sample=ms / s * 1e6)
    if "k5" in take:
        dyn = ops.dynamics
        for kind in K5_KINDS:
            for lanes, n in K5_TIMED:
                lanes = k5_lanes(kind, lanes)
                code, x, carry, coefs = scan_operands(dyn, kind, lanes, gen, n)
                fn = lambda: dyn.scan_lanes(code, x, carry, coefs)  # noqa: E731
                ms = device_ms(fn, "sample_scan", REPS)
                call_ms = cuda_ms(fn, 50)
                b_ms = bound(k5_work(x, carry, coefs), K5_OPS[kind] * x.numel())[0]
                emit(kernel="K5", kind=kind, lanes=lanes, frames=n, device_ms=ms,
                     call_ms=call_ms, bound_ms=b_ms, share=b_ms / ms)
    if "k6" in take:
        from chip_smoke import ptxas_report
        from firewheel_tpu_torch.ops import cuda_build

        cuda_build.build_all([ops.noise.LIBRARY], verbose=True)
        emit(kernel="K6", ptxas=ptxas_report(ops.noise.LIBRARY.log, "noise_uniform")
             if ops.noise.LIBRARY.log else "built before this run",
             sass=sass_counts(ops.noise.LIBRARY, "noise_uniform"))
        at = torch.tensor(NOISE_SAMPLE, dtype=torch.int64, device="cuda")
        for lanes, ch, f in K6_TIMED + K6_SWEEP:
            seeds = torch.randint(0, 2**32, (lanes,), generator=gen,
                                  dtype=torch.int64).to("cuda")
            fn = lambda: ops.noise.noise_uniform(seeds, at, ch, f)  # noqa: E731
            ms = device_ms(fn, "noise_uniform", REPS)
            b_ms = bound(*k6_work(lanes, ch * f))[0]
            emit(kernel="K6", shape=[lanes, ch, f], device_ms=ms, call_ms=cuda_ms(fn, 50),
                 bound_ms=b_ms, share=b_ms / ms)


def time_k89(ops, take, emit) -> None:
    """K8 at ``chip_smoke.K8_TIMED``'s shapes and K9 (each kind) at
    ``K5_TIMED``'s, as phases 17(a) and 17(b) time them, with ptxas's
    report of the backward libraries' entries where this run built them."""
    from chip_smoke import (K5_KINDS, K5_TIMED, K8_KERNEL, K8_TIMED, K9_KERNEL, bound,
                            k5_lanes, k7_label, k8_case, k8_work, k9_work, ptxas_report,
                            scan_operands)
    from firewheel_tpu_torch.ops import cuda_build

    libs = [lib for key, lib in (("k8", ops.iir.BWD_LIBRARY), ("k9", ops.dynamics.BWD_LIBRARY))
            if key in take]
    cuda_build.build_all(libs, verbose=True)
    for lib in libs:
        emit(library=lib.name, ptxas=ptxas_report(lib.log, "bwd_kernel") if lib.log
             else "built before this run")
    if "k8" in take:
        gen = torch.Generator().manual_seed(1717)
        for kind, rows, n, s in K8_TIMED:
            fn, _ = k8_case(ops.iir, kind, rows, n, s, gen)
            ms = device_ms(fn, K8_KERNEL[kind], REPS)
            b_ms = bound(*k8_work(kind, rows, n, s))[0]
            emit(kernel="K8", case=k7_label(kind, rows, n, s), device_ms=ms,
                 call_ms=cuda_ms(fn, 50), bound_ms=b_ms, share=b_ms / ms)
            del fn
            torch.cuda.empty_cache()
    if "k9" in take:
        dyn = ops.dynamics
        gen = torch.Generator().manual_seed(1718)
        for kind in K5_KINDS:
            for lanes, n in K5_TIMED:
                lanes = k5_lanes(kind, lanes)
                code, x, carry, coefs = scan_operands(dyn, kind, lanes, gen, n)
                out, y = dyn.scan_lanes(code, x, carry, coefs)
                g_y = torch.randn(y.shape, generator=gen).to(y.device)
                g_out = tuple(torch.randn(o.shape, generator=gen).to(o.device) for o in out)
                call = (code, x, carry, coefs, y, g_y, g_out)
                fn = lambda: dyn.scan_lanes_backward(*call)  # noqa: E731
                ms = device_ms(fn, K9_KERNEL, REPS)
                b_ms = bound(*k9_work(x, carry, coefs, kind))[0]
                emit(kernel="K9", kind=kind, lanes=lanes, frames=n, device_ms=ms,
                     call_ms=cuda_ms(fn, 50), bound_ms=b_ms, share=b_ms / ms)


def time_k1(iir, seq_iir, emit) -> None:
    gen = torch.Generator().manual_seed(1234)
    for lanes in K1_LANES:
        x = torch.randn((lanes, 128), generator=gen).to("cuda")
        z = tuple((0.1 * torch.randn((lanes,), generator=gen)).to("cuda")
                  for _ in range(2))
        freq = 200.0 + 19800.0 * torch.rand((lanes,), generator=gen)
        q = 0.5 + 3.5 * torch.rand((lanes,), generator=gen)
        per_lane = iir.biquad_lowpass(freq.to("cuda"), q.to("cuda"), 48000)
        n = lanes // 2
        per_instance = iir.biquad_lowpass(freq[:n, None].to("cuda"),
                                          q[:n, None].to("cuda"), 48000)
        for filters, args in (
            ("per lane", (x, z, per_lane)),
            ("per instance", (x.view(n, 2, 128), tuple(t.view(n, 2) for t in z),
                              per_instance)),
        ):
            ms = device_ms(lambda: seq_iir.biquad_seq(*args), "biquad", REPS)
            call_ms = cuda_ms(lambda: seq_iir.biquad_seq(*args), 200)
            emit(kernel="K1", lanes=lanes, frames=128, filters=filters,
                 device_ms=ms, call_ms=call_ms)


def time_k2(ft, em, take, emit) -> None:
    """K2 on the mixer at rest and ramping (k2), and by kind of row and at
    127-frame blocks (k2rows)."""
    import firewheel_tpu_torch.mixer as fmixer

    b, k = MIXER
    prog = ft.mixer_graph(device="cuda")

    def mixer_renderer(prog=prog):
        mega = em.MegaRenderer(prog, b, k, device="cuda")
        params = mega.stack_params()
        fkey = next(key for key in params if key.startswith("filter"))
        params[fkey]["freq"] = 8000.0 - 100.0 * (
            torch.arange(b, device="cuda") % 64).to(torch.float32)
        return mega, params

    mega, params = mixer_renderer()
    # a chunk from the defaults leaves every smoother at rest
    _, _, rest = mega.render_chunk(params, mega.init_state(), 0)
    if "k2" in take:
        for smoothers, p in (("at rest", params), ("ramping", move_smoothed(params))):
            ms = device_ms(lambda: mega.render_chunk(p, rest, k * 128), "mega_kernel",
                           REPS)
            emit(kernel="K2", graph="mixer", batch=b, blocks=k, smoothers=smoothers,
                 rows="all", device_ms=ms)
    if "k2rows" not in take:
        return
    for kind, codes in DUMMIES.items():
        mega, _ = mixer_renderer()
        ops = mega.lowered.ops.copy()
        ops[[int(r[em.OP]) in codes for r in ops], em.OP] = 0
        mega.lowered = dataclasses.replace(mega.lowered, ops=ops)
        ms = device_ms(lambda: mega.render_chunk(params, rest, k * 128),
                       "mega_kernel", REPS)
        emit(kernel="K2", graph="mixer", batch=b, blocks=k, smoothers="at rest",
             rows=f"{kind} as dummies", device_ms=ms)

    # the mixer in blocks of 127 frames: mixer_graph compiles with the
    # module's BLOCK
    fmixer.BLOCK = 127
    try:
        prog127 = ft.mixer_graph(device="cuda")
    finally:
        fmixer.BLOCK = 128
    try:
        mega, params = mixer_renderer(prog127)
        _, _, rest127 = mega.render_chunk(params, mega.init_state(), 0)
        ms = device_ms(lambda: mega.render_chunk(params, rest127, k * 127),
                       "mega_kernel", REPS)
        emit(kernel="K2", graph="mixer", batch=b, blocks=k, frames=127,
             smoothers="at rest", rows="all", device_ms=ms)
    except ValueError as e:  # a kernel that takes only multiples of 4 frames
        emit(kernel="K2", graph="mixer", batch=b, blocks=k, frames=127,
             refused=str(e))


def time_k3(ft, emit) -> None:
    from firewheel_tpu_torch.mixer import vary_effects_params

    for b, k in EFFECTS:
        br = ft.BatchRenderer(ft.effects_chain_graph(device="cuda"), b,
                              device="cuda", lowering="hybrid")
        params = vary_effects_params(br.stack_params())
        state = br.init_state()
        ms = device_ms(lambda: br.render_chunk(params, state, num_blocks=k),
                       "island_kernel", REPS)
        emit(kernel="K3", graph="effects chain", batch=b, blocks=k, device_ms=ms)


def time_palette(ft, em, iir, emit) -> None:
    from chip_smoke import PALETTE_HYBRID, palette_lowerings
    from firewheel_tpu_torch import executor_hybrid as eh

    _, k2, k3 = palette_lowerings(ft, em, eh, iir, card_line())
    b, k = PALETTE_HYBRID
    emit(kernel="K2", graph="FX palette without the flanger", batch=b, blocks=k,
         device_ms=k2[2])
    emit(kernel="K3", graph="FX palette, both islands", batch=b, blocks=k,
         device_ms=k3[2])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--kernels", default="k1,k2,k2rows,k3,palette,k7")
    args = ap.parse_args()
    take = set(args.kernels.split(","))
    if not torch.cuda.is_available():
        print("time_megakernel: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import firewheel_tpu_torch as ft
    from firewheel_tpu_torch import executor_mega as em
    from firewheel_tpu_torch.ops import iir, seq_iir

    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card_line()}; highest SM clock {clock}; torch {torch.__version__}; "
          f"port from {ft.__file__}", flush=True)

    def emit(**kw):
        print(json.dumps({"root": root, **kw}), flush=True)

    if "k7" in take:
        time_k7(iir, emit)
    if take & {"k4", "k5", "k6", "k8", "k9"}:
        from firewheel_tpu_torch import ops
        from firewheel_tpu_torch.ops import adpcm_device, dynamics, noise  # noqa: F401

        if take & {"k4", "k5", "k6"}:
            time_k456(ops, take, emit)
        if take & {"k8", "k9"}:
            time_k89(ops, take, emit)
    if "k1" in take:
        time_k1(iir, seq_iir, emit)
    if take & {"k2", "k2rows"}:
        time_k2(ft, em, take, emit)
    if "k3" in take:
        time_k3(ft, emit)
    # the palette's checks count K7 through biquad_cascade
    if "palette" in take and hasattr(em, "FX_ROWS") and hasattr(iir, "biquad_cascade"):
        time_palette(ft, em, iir, emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
