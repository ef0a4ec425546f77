"""The port's entry point: the flagship step, and a dp × vp dry run.

PyTorch port of ``__graft_entry__.py``.  :func:`entry` returns the flagship
step, a K=4 chunk of the batched 64-node mixer for B=2 instances, with its
arguments.  :func:`dryrun_multichip` shards one step over an ``n``-rank
``dp × vp`` mesh of processes: instances over ``dp``, voices over ``vp``,
each ``dp`` row's mix one ``all_reduce`` a chunk over ``vp`` and its master
bus replicated along the row.  Each rank holds its rows against the
unsharded step, and then ``BatchRenderer``, ``VoiceParallelMixer`` and
``SessionServer`` run over meshes.

Torch runs one process per device where JAX meshes the devices of one
process.  When the process group already holds ``n`` ranks the dry run
runs in place; otherwise it starts ``n`` processes: NCCL when there is a
card for each rank, gloo with CUDA tensors when the ranks share fewer
cards (NCCL refuses two ranks on one device), gloo on CPU tensors with
``device="cpu"``.  It never moves to the CPU unless asked.

Run ``python -m firewheel_tpu_torch.entry [n]`` (``n`` ranks, 4 by
default) on the card, or with ``--device cpu`` on the CPU.
"""

from __future__ import annotations

import datetime
import socket
import sys
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.multiprocessing.spawn import ProcessException

from . import nodes as _NODES
from .convert import params_from_jax, tree_map
from .device import DEFAULT_DEVICE, resolve_device
from .executor import ScheduleProgram
from .graph import AudioGraph, AudioGraphConfig
from .mixer import add_mixer
from .ops.iir import biquad_cascade
from .parallel import distributed
from .parallel.mesh import BatchRenderer, VoiceParallelMixer, _shard, make_mesh
from .serving import SessionServer

__all__ = ["add_dryrun_master", "add_dryrun_voice", "chunk_step", "dryrun_multichip",
           "dryrun_programs", "dryrun_snapshots", "entry", "make_step"]

SR = 48000
#: the flagship step: blocks of 128 frames, K=4 of them for B=2 instances
BLOCK, BLOCKS, BATCH = 128, 4, 2
#: the dry run's step: blocks of 32 frames, K=2 of them
DRYRUN_BLOCK, DRYRUN_BLOCKS = 32, 2
#: each rank's rows against the unsharded step, and the mixer's mix (JAX's)
STEP_TOL = 1e-5
#: the sharded BatchRenderer against the unsharded one (JAX's)
BATCH_TOL = 1e-6
#: seconds a rank waits on the rendezvous or a collective; the started
#: ranks are given twice that to finish, then stopped
RANK_TIMEOUT = 300


def _mixer_graph(num_voices: int = 19, block: int = BLOCK, strip_masks: bool = False,
                 state_light: bool = False,
                 device: str | torch.device = DEFAULT_DEVICE) -> ScheduleProgram:
    """The benchmark graph, node for node ``__graft_entry__._mixer_graph``:
    19 voices × (beep → volume → pan) → sum → lowpass 8 kHz (the ``"auto"``
    backend: K7's scan on the card) → echo → clip → meter → out, 64 nodes
    with the sentinels (:func:`~firewheel_tpu_torch.mixer.add_mixer`).
    ``strip_masks``: the silence-mask ablation (``ScheduleProgram``);
    ``state_light``: the echo and the meter swapped for stateless clips."""
    g = AudioGraph(AudioGraphConfig(0, 2))
    add_mixer(g, num_voices, "auto", state_light=state_light)
    pkg = g.compile(SR, block)
    return ScheduleProgram(pkg.schedule, dict(pkg.new_node_processors), SR,
                           device=device, strip_masks=strip_masks)


def entry(device: str | torch.device = DEFAULT_DEVICE):
    """``(fn, example_args)``: ``fn(*example_args)`` renders a K=4 chunk of
    the mixer (:func:`_mixer_graph`) for B=2 instances → ``(out f32[2, 4,
    2, 128], out_mask bool[2, 4, 2], state')``.  On the card the filter
    launches K7 once a block."""
    return chunk_step(_mixer_graph(device=device))


def chunk_step(program: ScheduleProgram):
    """``(fn, example_args)`` of :func:`entry` for any ``program`` at its
    blocks (the mixer's ablations, say): ``fn`` is ``chunk_fn(4)`` over
    ``BatchRenderer``'s stacked params and state for B=2 instances, and
    ``example_args`` is ``(params, state, graph_in f32[2, 4, Ni, F],
    in_mask bool[2, 4, Ni], start_sample, status)``, the clocks int64
    masked to 32 bits."""
    dev = program.device
    br = BatchRenderer(program, batch=BATCH, device=dev)
    ni, f = program.num_graph_inputs, program.max_block_frames
    example_args = (
        br.stack_params(),
        br.init_state(),
        torch.zeros((BATCH, BLOCKS, ni, f), dtype=torch.float32, device=dev),
        torch.ones((BATCH, BLOCKS, ni), dtype=torch.bool, device=dev),
        torch.zeros((), dtype=torch.int64, device=dev),
        torch.zeros((), dtype=torch.int64, device=dev),
    )
    return program.chunk_fn(BLOCKS), example_args


# -- the dry run's graphs ------------------------------------------------------

def add_dryrun_voice(g, nodes=None) -> dict:
    """The dry run's voice, ``__graft_entry__._dryrun_impl``'s: BeepTest
    (440 Hz, -24 dB) → StereoPan (centre) → out.  ``nodes`` is the node
    module (the port's by default).  Returns the nodes (``"beep"``,
    ``"pan"``), whose setters give each voice its own snapshot
    (:func:`dryrun_snapshots`)."""
    n = nodes or _NODES
    v = {"beep": n.BeepTestNode(440.0, -24.0, True), "pan": n.StereoPanNode(0.0)}
    beep, pan = g.add_node(0, 2, v["beep"]), g.add_node(2, 2, v["pan"])
    for a, b in ((beep, pan), (pan, g.graph_out_node())):
        g.connect(a, 0, b, 0)
        g.connect(a, 1, b, 1)
    return v


def add_dryrun_master(g, nodes=None) -> None:
    """The dry run's master bus on the stereo mix at the graph's inputs:
    lowpass Filter 12 kHz → HardClip 0 dB → out."""
    n = nodes or _NODES
    chain = [g.graph_in_node(), g.add_node(2, 2, n.FilterNode(n.FilterType.LOWPASS, 12000.0)),
             g.add_node(2, 2, n.HardClipNode(0.0)), g.graph_out_node()]
    for a, b in zip(chain, chain[1:]):
        g.connect(a, 0, b, 0)
        g.connect(a, 1, b, 1)


def dryrun_programs(device: str | torch.device = DEFAULT_DEVICE):
    """``(voice_program, master_program, voice_nodes)`` at the dry run's
    32-frame blocks, on ``device``."""
    def compile_(g):
        pkg = g.compile(SR, DRYRUN_BLOCK)
        return ScheduleProgram(pkg.schedule, dict(pkg.new_node_processors), SR,
                               device=device)

    g = AudioGraph(AudioGraphConfig(0, 2))
    voice = add_dryrun_voice(g)
    vprog = compile_(g)
    g = AudioGraph(AudioGraphConfig(num_graph_inputs=2, num_graph_outputs=2))
    add_dryrun_master(g)
    return vprog, compile_(g), voice


def dryrun_snapshots(program, voice: dict, count: int) -> list:
    """``count`` param snapshots of the dry run's voice, each its own:
    voice ``i`` (its global index) at 110·(1 + i) Hz, panned across [-1,
    1], so that a rank that renders another's voices fails its check.
    ``voice``: the nodes :func:`add_dryrun_voice` returned for
    ``program``'s graph (either package's)."""
    snaps = []
    for i in range(count):
        voice["beep"].set_frequency(110.0 * (1 + i))
        voice["pan"].set_pan(2.0 * i / max(count - 1, 1) - 1.0)
        snaps.append(program.collect_params())
    return snaps


def _stack(snaps: list, device) -> dict:
    return params_from_jax(
        tree_map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *snaps), device)


def _leaf(tree):
    """The first tensor of a nested dict."""
    for v in tree.values():
        t = _leaf(v) if isinstance(v, dict) else v
        if t is not None:
            return t
    return None


def make_step(vprog: ScheduleProgram, mprog: ScheduleProgram, num_blocks: int = DRYRUN_BLOCKS,
              group=None):
    """The dry run's step, ``(vparams [b, v, ...], vstate [b, v, ...],
    mparams [b, ...], mstate [b, ...], start_sample) -> (out f32[b, K, 2,
    F], vstate', mstate')``: K blocks of every voice of every instance as
    one batched render, each instance's voices summed, then K blocks of
    its master bus on the mix.  ``group``: the process group of the voice
    axis, whose ranks hold the instance's other voices; the mix is then one
    ``all_reduce`` over it a chunk (no voice reads the mix).  ``None``
    builds the unsharded step."""
    voice_chunk, master_chunk = vprog.chunk_fn(num_blocks), mprog.chunk_fn(num_blocks)
    f, ni = vprog.max_block_frames, vprog.num_graph_inputs

    def step(vparams, vstate, mparams, mstate, start_sample):
        b, v = _leaf(vstate).shape[:2]
        dev = _leaf(vstate).device
        outs, _, vstate = voice_chunk(
            vparams, vstate,
            torch.zeros((b, v, num_blocks, ni, f), dtype=torch.float32, device=dev),
            torch.ones((b, v, num_blocks, ni), dtype=torch.bool, device=dev),
            start_sample, 0)
        mix = outs.sum(dim=1)  # [b, K, 2, F]
        if group is not None:
            dist.all_reduce(mix, op=dist.ReduceOp.SUM, group=group)
        not_silent = torch.zeros(mix.shape[:-1], dtype=torch.bool, device=dev)
        out, _, mstate = master_chunk(mparams, mstate, mix, not_silent, start_sample, 0)
        return out, vstate, mstate

    return step


def _max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"rank {distributed.process_index()}: {what}")


def _dryrun_impl(n: int, device: torch.device) -> dict:
    """One rank's dry run in a process group of ``n`` ranks → its numbers."""
    rank = distributed.process_index()
    lead = rank == 0
    print(f"dryrun_multichip rank {rank} of {n}: backend {dist.get_backend()}, "
          f"device {device}", flush=True)
    got = {"rank": rank, "backend": dist.get_backend(), "device": str(device)}
    vp = 2 if n % 2 == 0 and n >= 2 else 1
    dp = n // vp
    mesh = make_mesh({"dp": dp, "vp": vp}, device.type)
    batch, voices = 2 * dp, 2 * vp
    vprog, mprog, voice = dryrun_programs(device)
    snaps = dryrun_snapshots(vprog, voice, batch * voices)
    vparams = tree_map(lambda t: t.reshape((batch, voices) + t.shape[1:]),
                       _stack(snaps, device))
    vstate = tree_map(lambda t: t.expand((batch, voices) + t.shape).clone(),
                      vprog.init_state())
    mparams = tree_map(lambda t: t.expand((batch,) + t.shape).clone(),
                       params_from_jax(mprog.collect_params(), device))
    mstate = tree_map(lambda t: t.expand((batch,) + t.shape).clone(), mprog.init_state())

    # the 2-D step: this rank's instances and voices
    rows = _shard(batch, mesh, "dp", "batch")
    cols = _shard(voices, mesh, "vp", "voices")
    mine = (tree_map(lambda t: t[rows, cols].clone(), vparams),
            tree_map(lambda t: t[rows, cols].clone(), vstate),
            tree_map(lambda t: t[rows].clone(), mparams),
            tree_map(lambda t: t[rows].clone(), mstate))
    k7 = biquad_cascade.launches
    out, _, _ = make_step(vprog, mprog, group=mesh.get_group("vp"))(*mine, 0)
    got["step_k7"] = biquad_cascade.launches - k7
    ref, _, _ = make_step(vprog, mprog)(vparams, vstate, mparams, mstate, 0)
    got.update(rows=[rows.start, rows.stop], voices=[cols.start, cols.stop],
               step_err=_max_err(out, ref[rows]))
    _check(out.shape == (batch // dp, DRYRUN_BLOCKS, 2, DRYRUN_BLOCK),
           f"the step's output is {tuple(out.shape)}")
    _check(bool(torch.isfinite(out).all()) and float(ref.abs().max()) > 0.01,
           "the step's output is not finite, or silent")
    _check(got["step_err"] <= STEP_TOL,
           f"rows {rows} against the unsharded step: {got['step_err']:.3e}")
    if lead:
        print(f"dryrun_multichip OK: mesh dp={dp} vp={vp}, out {tuple(out.shape)} a "
              f"rank of {batch} instances, all_reduce mixdown verified", flush=True)

    # the public API over meshes, as the JAX dry run drives it
    k, b, nv = DRYRUN_BLOCKS, 2 * n, 2 * n
    mesh_dp = make_mesh({"dp": n}, device.type)
    snaps = dryrun_snapshots(vprog, voice, max(b, nv))
    sharded = BatchRenderer(vprog, b, device=device, mesh=mesh_dp, axis="dp")
    plain = BatchRenderer(vprog, b, device=device)
    out_s, _, _ = sharded.render_chunk(sharded.stack_params(snaps[:b]), sharded.init_state(),
                                       num_blocks=k)
    out_p, _, _ = plain.render_chunk(plain.stack_params(snaps[:b]), plain.init_state(),
                                     num_blocks=k)
    got["batch_err"] = _max_err(out_s, out_p[sharded.local_rows])
    _check(out_s.shape == (b // n, k, 2, DRYRUN_BLOCK) and got["batch_err"] <= BATCH_TOL,
           f"BatchRenderer over dp={n}: {tuple(out_s.shape)}, {got['batch_err']:.3e}")
    if lead:
        print(f"BatchRenderer OK: dp={n}, sharded == unsharded (B={b})", flush=True)

    mesh_vp = make_mesh({"vp": n}, device.type)
    mixers = (VoiceParallelMixer(vprog, nv, mprog, mesh=mesh_vp, axis="vp"),
              VoiceParallelMixer(vprog, nv, mprog))
    mixes = [m.render_chunk(m.stack_voice_params(snaps[:nv]), m.init_state(),
                            num_blocks=k)[0] for m in mixers]
    got.update(mix_err=_max_err(*mixes), collectives=mixers[0].collectives)
    _check(got["mix_err"] <= STEP_TOL and got["collectives"] == 1,
           f"VoiceParallelMixer over vp={n}: {got['mix_err']:.3e}, "
           f"{got['collectives']} collectives")
    if lead:
        print(f"VoiceParallelMixer OK: vp={n}, all_reduce mixdown == unsharded (V={nv})",
              flush=True)

    srv = SessionServer(vprog, capacity=b, chunk_blocks=k, device=device, mesh=mesh_dp,
                        axis="dp")
    handle = srv.connect()
    out = srv.render()
    _check(out.shape == (b // n, k, 2, DRYRUN_BLOCK) and bool(torch.isfinite(out).all()),
           f"SessionServer over dp={n}: {tuple(out.shape)}")
    _check(srv.poll_events() == {}, "SessionServer: events from a beep")
    handle.disconnect()
    if lead:
        print(f"SessionServer OK: dp={n}, capacity {b}", flush=True)
    dist.barrier(device_ids=[device.index] if got["backend"] == "nccl" else None)
    return got


def _rank_main(rank: int, n: int, port: int, backend: str, device_type: str,
               timeout: float, results) -> None:
    """A started rank: join the group, run the dry run, put its numbers."""
    torch.set_num_threads(1)
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    distributed.initialize_multihost(f"localhost:{port}", n, rank, backend=backend,
                                     timeout=datetime.timedelta(seconds=timeout))
    try:
        results.put(_dryrun_impl(n, device))
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device: str | torch.device = DEFAULT_DEVICE) -> list:
    """The 2-D sharded step on ``n_devices`` ranks, then the public API over
    meshes (module docstring) → each rank's numbers, in rank order
    (``step_k7``: K7's launches in the rank's sharded step, which the
    master's lowpass makes on the card).

    With a process group of ``n_devices`` ranks already joined, this rank
    runs in place.  Otherwise ``n_devices`` processes start, each a rank:
    gloo on ``device="cpu"``; on the card NCCL with a card a rank, or gloo
    with CUDA tensors when the ranks share fewer cards.  Raises if any rank
    fails, or if the started ranks outlast twice ``RANK_TIMEOUT``."""
    n = int(n_devices)
    device = resolve_device(device)
    if distributed._initialized():
        if distributed.process_count() != n:
            raise ValueError(f"the process group has {distributed.process_count()} "
                             f"ranks, not {n}")
        return [_dryrun_impl(n, device)]
    if device.type == "cuda":
        backend = "nccl" if torch.cuda.device_count() >= n else "gloo"
    else:
        backend = "gloo"
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = torch.multiprocessing.get_context("spawn")
    # a rank's numbers are a few hundred bytes: its put fits the pipe and
    # returns, so the ranks are joined before the results are read
    results = ctx.SimpleQueue()
    ranks = torch.multiprocessing.start_processes(
        _rank_main, args=(n, port, backend, device.type, RANK_TIMEOUT, results), nprocs=n,
        join=False, start_method="spawn")
    deadline = time.monotonic() + 2 * RANK_TIMEOUT
    try:
        while not ranks.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise RuntimeError(f"dryrun_multichip: {n} ranks still running after "
                                   f"{2 * RANK_TIMEOUT} s")
    except ProcessException as e:
        raise RuntimeError(f"dryrun_multichip: rank {e.error_index} of {n} failed") from e
    finally:
        for proc in ranks.processes:
            if proc.is_alive():
                proc.kill()
    return sorted((results.get() for _ in range(n)), key=lambda r: r["rank"])


def _main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    device = DEFAULT_DEVICE
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i:i + 2]
    n = int(argv[0]) if argv else 4
    fn, args = entry(device=device)
    out, _, _ = fn(*args)
    print("entry OK:", tuple(out.shape), flush=True)
    dryrun_multichip(n, device=device)


if __name__ == "__main__":
    _main()
