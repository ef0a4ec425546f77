"""Plain reference of the effects chain (``configs/effects4.json``).

For each session: a cubic (Catmull-Rom) sampler looping the whole pluck
from the session's start frame at its playback rate → RBJ lowpass at the
session's cutoff → feedback echo (0.28 s) → hard clip at −3 dB →
convolution with the 0.6 s stereo IR (28 800 taps), ``dry·x + wet·(x *
ir)`` at the session's wet → int16 PCM.

The sampler's position is an integer playhead and a fractional carry that
the node keeps in float32 from block to block: the block's positions are
``playhead + frac + k·rate``, and the carry moves by ``frames·rate``,
rounded once to float32.  The reference keeps that carry as the node's
state is defined; the positions inside a block it computes in ``dt``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from fwbench.reference import common


@functools.lru_cache(maxsize=4)
def _pluck(freq_hz: float, secs: float, seed: int, decay: float, sr: int) -> np.ndarray:
    """Karplus-Strong: a burst of seeded uniform noise one period long
    through a feedback comb, ``y[i] = decay·(y[i−P] + y[i−P+1])/2``, stereo."""
    rng = np.random.default_rng(seed)
    period = int(round(sr / freq_hz))
    n = int(secs * sr)
    buf = np.zeros(n, np.float32)
    buf[:period] = rng.uniform(-1.0, 1.0, period).astype(np.float32)
    for i in range(period, n):
        buf[i] = decay * 0.5 * (buf[i - period] + buf[i - period + 1])
    return np.stack([buf, buf])


@functools.lru_cache(maxsize=4)
def _room(secs: float, t60_secs: float, seed: int, sr: int) -> np.ndarray:
    """Decorrelated seeded noise under an envelope that falls 60 dB in
    ``t60_secs``, each channel normalised by its absolute sum."""
    rng = np.random.default_rng(seed)
    n = int(secs * sr)
    t = np.arange(n, dtype=np.float32) / sr
    env = np.exp(-6.91 * t / t60_secs)
    ir = rng.standard_normal((2, n)).astype(np.float32) * env
    return ir / np.abs(ir).sum(axis=-1, keepdims=True)


def clip_and_ir(cfg: dict):
    """The clip ``f32[2, frames]`` and the IR ``f32[2, taps]`` from the
    configuration's recipes (``examples/effects_chain.py``'s)."""
    c, r, sr = cfg["clip"], cfg["ir"], cfg["sample_rate"]
    clip = _pluck(c["freq_hz"], c["secs"], c["seed"], c["decay"], sr)
    ir = _room(r["secs"], r["t60_secs"], r["seed"], sr)
    return clip.copy(), ir.copy()


def sampler(cfg: dict, rate, start, frames: int, dt):
    """The looping cubic sampler → ``[S, 2, frames]`` in ``dt``."""
    clip, _ = clip_and_ir(cfg)
    f = cfg["block_frames"]
    length = clip.shape[-1]
    data = torch.as_tensor(clip, dtype=dt)
    rate = torch.as_tensor(rate, dtype=dt)
    s = rate.shape[0]
    blocks = -(-frames // f)
    # the carry, block by block
    playhead = torch.as_tensor(start, dtype=torch.float64).to(torch.int64) % length
    frac = torch.zeros(s, dtype=dt)
    heads, fracs = [], []
    for _ in range(blocks):
        heads.append(playhead)
        fracs.append(frac)
        adv = (f * rate + frac).to(torch.float32).to(dt)
        whole = torch.floor(adv)
        playhead = (playhead + whole.to(torch.int64)) % length
        frac = adv - whole
    heads = torch.stack(heads, 1)                   # [S, blocks]
    fracs = torch.stack(fracs, 1)
    k = torch.arange(f, dtype=dt)
    off = fracs[..., None] + k * rate[:, None, None]    # [S, blocks, F]
    whole = torch.floor(off)
    w = (off - whole).reshape(s, -1)[:, :frames]
    idx0 = ((heads[..., None] + whole.to(torch.int64)) % length).reshape(s, -1)[:, :frames]
    weights = (
        ((-0.5 * w + 1.0) * w - 0.5) * w,
        (1.5 * w - 2.5) * w * w + 1.0,
        ((-1.5 * w + 2.0) * w + 0.5) * w,
        (0.5 * w - 0.5) * w * w,
    )
    out = torch.zeros((s, 2, frames), dtype=dt)
    for d, wt in zip((-1, 0, 1, 2), weights):
        taps = data[:, (idx0 + d) % length]         # [2, S, frames]
        out += taps.transpose(0, 1) * wt[:, None, :]
    return out


def render(cfg: dict, values: dict, frames: int, dt=torch.float64) -> torch.Tensor:
    """The first ``frames`` frames of the sessions whose values are
    ``values`` (``{"rate", "start_frame", "cutoff_hz", "reverb_wet"}``, each
    ``[S]``) → ``int16[S, frames, 2]``, computed in ``dt``."""
    sr = cfg["sample_rate"]
    x = sampler(cfg, values["rate"], values["start_frame"], frames, dt)
    s = x.shape[0]
    x = x.reshape(s * 2, frames)
    cut = torch.as_tensor(values["cutoff_hz"], dtype=dt).repeat_interleave(2)
    x = common.biquad(x, common.lowpass_coeffs(cut, cfg["filter"]["q"], sr, dt), dt)
    e = cfg["echo"]
    x = common.echo(x, int(round(e["delay_secs"] * sr)), e["feedback"], e["wet"],
                    e["dry"], dt)
    x = common.clip(x, cfg["clip_db"])
    _, ir = clip_and_ir(cfg)
    taps = torch.as_tensor(ir, dtype=dt).repeat(s, 1)    # [S·2, taps]
    wet = torch.as_tensor(values["reverb_wet"], dtype=dt).repeat_interleave(2)
    x = cfg["reverb"]["dry"] * x + wet[:, None] * common.fir(x, taps, dt)
    return common.pcm16(x).reshape(s, 2, frames).transpose(1, 2)
