"""The 64-node mixer: 19 x (beep -> volume -> pan) -> sum -> lowpass 8 kHz ->
echo 0.25 s, fb 0.3 -> clip 0 dB -> meter, 48 kHz stereo, 128-frame blocks.

Built through the port's public builder (``mixer.mixer_graph(19,
"pallas")``); every number of ``mixer64.json`` is checked against the
built program, so the file is the configuration as it runs.  Each session
gets its own 19 volumes, 19 pans and lowpass cutoff, drawn on the card from
the seed.
"""

from __future__ import annotations

import math

import torch


def _keys(program, kind: str) -> list[str]:
    """The node keys of ``kind`` in the order the builder added them."""
    keys = [k for k in program._procs if k.split("-")[0] == kind]
    return sorted(keys, key=lambda k: int(k.split("-")[1]))


def build(cfg: dict, device):
    """The program the cell renders, on ``device``."""
    from firewheel_tpu_torch import mixer

    if cfg["sample_rate"] != mixer.SR or cfg["block_frames"] != mixer.BLOCK:
        raise ValueError("mixer64.json's rate or block is not the builder's")
    program = mixer.mixer_graph(cfg["voices"], cfg["filter"]["backend"], device=device)
    check(cfg, program)
    return program


def check(cfg: dict, program) -> None:
    """Raise unless the built program holds ``cfg``'s numbers."""
    p = program.collect_params()
    beeps = _keys(program, "beep_test")
    if len(beeps) != cfg["voices"]:
        raise ValueError(f"{len(beeps)} voices built, {cfg['voices']} configured")
    sr = cfg["sample_rate"]
    for key, hz in zip(beeps, cfg["voice_freq_hz"]):
        inc = int(round(hz / sr * 2.0 ** 32)) & 0xFFFFFFFF
        gain = 10.0 ** (cfg["voice_gain_db"] / 20.0)
        if int(p[key]["inc"]) != inc or not math.isclose(float(p[key]["gain"]), gain,
                                                          rel_tol=1e-6):
            raise ValueError(f"{key} is not {hz} Hz at {cfg['voice_gain_db']} dB")
    raw = (cfg["volume_percent"] / 100.0) ** 2
    for key in _keys(program, "volume"):
        if not math.isclose(float(p[key]["raw_gain"]), raw, rel_tol=1e-6):
            raise ValueError(f"{key} is not at {cfg['volume_percent']}%")
    (filt,), (echo,), (clip,) = (_keys(program, k) for k in ("filter", "echo", "hard_clip"))
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
    if not math.isclose(float(p[clip]["threshold"]), 10.0 ** (cfg["clip_db"] / 20.0),
                        rel_tol=1e-6):
        raise ValueError(f"{clip} is not at {cfg['clip_db']} dB")


def session_values(cfg: dict, batch: int, seed: int, device) -> dict:
    """Each session's own values ``{name: f32[batch, ...]}``, drawn on
    ``device`` from ``seed`` in one call."""
    v = cfg["voices"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2 ** 64)
    u = torch.rand((batch, 2 * v + 1), generator=gen, device=device)
    s = cfg["sessions"]

    def span(x, lo_hi):
        lo, hi = lo_hi
        return lo + (hi - lo) * x

    return {
        "raw_gain": span(u[:, :v], s["raw_gain"]),
        "pan": span(u[:, v:2 * v], s["pan"]),
        "cutoff_hz": span(u[:, 2 * v], s["cutoff_hz"]),
    }


def vacate(cfg: dict, values: dict, vacant: torch.Tensor) -> None:
    """Mute the sessions where ``vacant`` is set (every voice at the
    configuration's vacant gain), in place."""
    values["raw_gain"][vacant] = cfg["vacant"]["raw_gain"]


def apply(program, params: dict, values: dict) -> None:
    """Write each session's values into the batched param tree, in place."""
    for i, key in enumerate(_keys(program, "volume")):
        params[key]["raw_gain"].copy_(values["raw_gain"][:, i])
    for i, key in enumerate(_keys(program, "stereo_pan")):
        params[key]["pan"].copy_(values["pan"][:, i])
    (filt,) = _keys(program, "filter")
    params[filt]["freq"].copy_(values["cutoff_hz"])


def rows(values: dict, index) -> dict:
    """The values of the sessions ``index`` as float64 numpy arrays, for the
    reference."""
    return {k: v[index].double().cpu().numpy() for k, v in values.items()}


def node_kinds(cfg: dict) -> dict:
    """Each node kind of the graph with what the roofline count needs of it."""
    sr = cfg["sample_rate"]
    return {
        "beep_test": {}, "volume": {}, "stereo_pan": {"inputs": 2},
        "sum": {"inputs": 2 * cfg["voices"]},
        "filter": {}, "echo": {"delay_frames": int(round(cfg["echo"]["delay_secs"] * sr))},
        "hard_clip": {}, "db_meter": {},
    }
