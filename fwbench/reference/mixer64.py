"""Plain reference of the 64-node mixer (``configs/mixer64.json``).

For each session: 19 beeps (a uint32 fixed-point phasor, 2^32 a cycle,
``sin(2π·phase)·gain``) → volume (the smoothed raw gain) → equal-power pan
(the smoothed pan, ``cos``/``sin`` of ``(pan + 1)·π/4`` on the mid) → sum
→ RBJ lowpass at the session's cutoff → feedback echo → hard clip →
int16 PCM.  The meter passes audio through.  Volumes and pans ramp from
the template's values (80%, the builder's pan spread) toward the
session's, as a session that joined from the template does.
"""

from __future__ import annotations

import math

import torch

from fwbench.reference import common


def render(cfg: dict, values: dict, frames: int, dt=torch.float64) -> torch.Tensor:
    """The first ``frames`` frames of the sessions whose values are
    ``values`` (``{"raw_gain": [S, V], "pan": [S, V], "cutoff_hz": [S]}``)
    → ``int16[S, frames, 2]``, computed in ``dt``."""
    sr, f = cfg["sample_rate"], cfg["block_frames"]
    v = cfg["voices"]
    gains = torch.as_tensor(values["raw_gain"], dtype=dt)
    pans = torch.as_tensor(values["pan"], dtype=dt)
    s = gains.shape[0]

    # the beeps: one phasor a voice, the same in every session
    n = torch.arange(frames, dtype=torch.int64)
    tones = torch.empty((v, frames), dtype=dt)
    amp = 10.0 ** (cfg["voice_gain_db"] / 20.0)
    for i, hz in enumerate(cfg["voice_freq_hz"]):
        inc = int(round(hz / sr * 2.0 ** 32)) & 0xFFFFFFFF
        q = (n * inc) & 0xFFFFFFFF
        signed = torch.where(q >= 2 ** 31, q - 2 ** 32, q)
        tones[i] = torch.sin(signed.to(dt) * (2.0 * math.pi / 2.0 ** 32)) * amp

    # volume and pan smoothers, from the template toward each session's
    vol0 = torch.full_like(gains, (cfg["volume_percent"] / 100.0) ** 2)
    pan0 = torch.tensor([2.0 * i / (v - 1) - 1.0 for i in range(v)], dtype=dt).expand(s, v)
    nblocks = -(-frames // f)
    vol_ramp, mv = common.smoother_ramps(vol0, gains, f, sr, dt, nblocks)
    pan_ramp, mp = common.smoother_ramps(pan0, pans, f, sr, dt, nblocks)
    ramp_frames = min(max(mv, mp) * f, frames)

    def per_frame(ramp, target):
        """[S, V, ramp_frames]: the ramp, then the target held."""
        held = target[..., None].expand(s, v, ramp_frames).clone()
        m = min(ramp.shape[-1], ramp_frames)
        held[..., :m] = ramp[..., :m]
        return held

    # the pan's mid, (L + R) / 2 of a mono voice, is the voice itself
    mix = torch.empty((s, 2, frames), dtype=dt)
    if ramp_frames:
        vol, theta = per_frame(vol_ramp, gains), per_frame(pan_ramp, pans)
        theta = (theta + 1.0) * (math.pi / 4.0)
        mid = tones[None, :, :ramp_frames] * vol
        mix[:, 0, :ramp_frames] = (mid * torch.cos(theta)).sum(1)
        mix[:, 1, :ramp_frames] = (mid * torch.sin(theta)).sum(1)
    theta = (pans + 1.0) * (math.pi / 4.0)
    for ch, law in enumerate((torch.cos, torch.sin)):
        mix[:, ch, ramp_frames:] = (gains * law(theta)) @ tones[:, ramp_frames:]

    x = mix.reshape(s * 2, frames)
    cut = torch.as_tensor(values["cutoff_hz"], dtype=dt).repeat_interleave(2)
    x = common.biquad(x, common.lowpass_coeffs(cut, cfg["filter"]["q"], sr, dt), dt)
    e = cfg["echo"]
    x = common.echo(x, int(round(e["delay_secs"] * sr)), e["feedback"], e["wet"],
                    e["dry"], dt)
    x = common.clip(x, cfg["clip_db"])
    return common.pcm16(x).reshape(s, 2, frames).transpose(1, 2)
