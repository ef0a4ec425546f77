"""The effects chain of BASELINE config 4 (``examples/effects_chain.py``):
a cubic sampler playing a 1.2 s Karplus-Strong pluck → lowpass 6 kHz, q
0.9 → echo 0.28 s, fb 0.35 → clip −3 dB → convolution reverb with a 0.6 s
stereo IR (28 800 taps, 225 partitions: the partitioned FFT engine), 48
kHz stereo, 128-frame blocks.

Built through the port's public builder (``mixer.add_effects_chain``, as
``mixer.effects_chain_config4_graph`` builds it) on the pluck and IR that
``effects4.json``'s recipes make; the built program is checked against the
file.  Each session gets its own playback rate, a loop over the whole
pluck from its own start frame, the lowpass cutoff and the reverb's wet,
drawn on the card from the seed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from fwbench.reference.effects4 import clip_and_ir


def _key(program, kind: str) -> str:
    (key,) = [k for k in program._procs if k.split("-")[0] == kind]
    return key


def build(cfg: dict, device):
    """The program the cell renders, on ``device``."""
    from firewheel_tpu_torch import mixer
    from firewheel_tpu_torch.executor import ScheduleProgram
    from firewheel_tpu_torch.graph import AudioGraph, AudioGraphConfig

    if cfg["sample_rate"] != mixer.SR or cfg["block_frames"] != mixer.BLOCK:
        raise ValueError("effects4.json's rate or block is not the builder's")
    clip, ir = clip_and_ir(cfg)
    g = AudioGraph(AudioGraphConfig(0, 2))
    mixer.add_effects_chain(g, clip, ir, cfg["echo"]["delay_secs"],
                            cfg["filter"]["backend"])
    pkg = g.compile(cfg["sample_rate"], cfg["block_frames"])
    program = ScheduleProgram(pkg.schedule, dict(pkg.new_node_processors),
                              cfg["sample_rate"], device=device)
    check(cfg, program)
    return program


def check(cfg: dict, program) -> None:
    """Raise unless the built program holds ``cfg``'s numbers."""
    p = program.collect_params()
    clip, ir = clip_and_ir(cfg)
    smp, filt, echo, hc, rev = (_key(program, k) for k in (
        "sampler", "filter", "echo", "hard_clip", "convolution_reverb"))
    if not np.array_equal(np.asarray(p[smp]["sample"]), clip):
        raise ValueError(f"{smp} does not hold the configured clip")
    proc = program._procs[smp]
    if proc._node.quality != cfg["sampler"]["quality"] or not math.isclose(
            float(p[smp]["raw_gain"]), (cfg["sampler"]["percent_volume"] / 100.0) ** 2):
        raise ValueError(f"{smp} is not {cfg['sampler']}")
    f = cfg["filter"]
    if not (math.isclose(float(p[filt]["freq"]), f["freq_hz"])
            and math.isclose(float(p[filt]["q"]), f["q"], rel_tol=1e-6)):
        raise ValueError(f"{filt} is not {f}")
    e = cfg["echo"]
    for name in ("feedback", "wet", "dry"):
        if not math.isclose(float(p[echo][name]), e[name], rel_tol=1e-6):
            raise ValueError(f"{echo}'s {name} is not {e[name]}")
    line = program.init_state()[echo]["line"].shape[-1]
    if line != int(round(e["delay_secs"] * cfg["sample_rate"])):
        raise ValueError(f"{echo}'s line is {line} frames")
    if not math.isclose(float(p[hc]["threshold"]), 10.0 ** (cfg["clip_db"] / 20.0),
                        rel_tol=1e-6):
        raise ValueError(f"{hc} is not at {cfg['clip_db']} dB")
    r = cfg["reverb"]
    proc = program._procs[rev]
    if (proc._method, proc._partitions) != (r["method"], r["partitions"]) or not (
            np.array_equal(np.asarray(proc._node._ir), ir)):
        raise ValueError(f"{rev} is not the {r['method']} engine on the configured IR")
    for name in ("wet", "dry"):
        if not math.isclose(float(p[rev][name]), r[name], rel_tol=1e-6):
            raise ValueError(f"{rev}'s {name} is not {r[name]}")


def session_values(cfg: dict, batch: int, seed: int, device) -> dict:
    """Each session's own values ``{name: [batch]}``, drawn on ``device``
    from ``seed`` in one call."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2 ** 64)
    u = torch.rand((batch, 4), generator=gen, device=device)
    s = cfg["sessions"]

    def span(x, lo_hi):
        lo, hi = lo_hi
        return lo + (hi - lo) * x

    lo, hi = s["start_frame"]
    return {
        "rate": span(u[:, 0], s["rate"]),
        "start_frame": (lo + (hi - lo) * u[:, 1]).floor().clamp(lo, hi - 1).to(torch.int64),
        "cutoff_hz": span(u[:, 2], s["cutoff_hz"]),
        "reverb_wet": span(u[:, 3], s["reverb_wet"]),
        "playing": torch.ones(batch, dtype=torch.bool, device=device),
    }


def vacate(cfg: dict, values: dict, vacant: torch.Tensor) -> None:
    """Stop the sampler of the sessions where ``vacant`` is set, in place."""
    values["playing"][vacant] = cfg["vacant"]["playing"]


def apply(program, params: dict, values: dict) -> None:
    """Write each session's values into the batched param tree, in place:
    the sampler loops the whole clip from the session's start frame."""
    smp = params[_key(program, "sampler")]
    smp["rate"].copy_(values["rate"])
    smp["playing"].copy_(values["playing"])
    smp["loop_on"].fill_(True)
    smp["loop_start"].zero_()
    smp["loop_end"].fill_(smp["sample"].shape[-1])
    smp["seek_pos"].copy_(values["start_frame"])
    params[_key(program, "filter")]["freq"].copy_(values["cutoff_hz"])
    params[_key(program, "convolution_reverb")]["wet"].copy_(values["reverb_wet"])


def rows(values: dict, index) -> dict:
    """The values of the sessions ``index`` as float64 numpy arrays, for the
    reference."""
    return {k: v[index].double().cpu().numpy() for k, v in values.items()
            if k != "playing"}


def node_kinds(cfg: dict) -> dict:
    """Each node kind of the graph with what the roofline count needs of it."""
    sr = cfg["sample_rate"]
    return {"filter": {}, "echo": {"delay_frames": int(round(cfg["echo"]["delay_secs"] * sr))},
            "hard_clip": {}}
