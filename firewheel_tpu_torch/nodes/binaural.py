"""Binaural 3D spatializer: structural HRTF (ITD + head shadow), no data.

PyTorch port of ``firewheel_tpu/nodes/binaural.py``.  Where
``Spatializer3DNode`` renders for speakers (equal-power panning), this node
renders for headphones with the Brown–Duda structural model:

* ITD (interaural time difference), Woodworth's spherical-head ray model,
  offset by ``a/c`` to stay causal, applied per ear as a per-sample
  fractional delay (linear interpolation on a short carried line), the
  delay riding a 10 ms smoother;
* head shadow, the Brown–Duda one-pole/one-zero section
  ``H(s) = (1 + α·s/(2ω₀)) / (1 + s/(2ω₀))``, ``α(θ) = 1 + cos θ``,
  discretized by the bilinear transform per block on the host;
* distance gain and air absorption as in ``Spatializer3DNode``.

Every cue is computed on the host in numpy from the emitter position (a
live param).  The interpolation and the shadow section's input sum are
written as the fused multiply-adds XLA makes of them on the CPU: the
section's pole (up to ~0.85) amplifies their rounding.  The
fractional-delay gathers have no device function in the megakernel
(``supports_megakernel = False``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.node import (
    gate,
    AudioNode,
    AudioNodeInfo,
    NodeActivationError,
    NodeProcessor,
)
from ..core.smoother import (
    SmootherConfig,
    smoother_coeffs,
    smoother_init,
    smoother_set_and_process,
)
from ..ops.iir import _fma, one_pole_scan
from ..ops.pan import spatial_params

__all__ = ["BinauralSpatializerNode", "BinauralSpatializerProcessor"]

_SPEED_OF_SOUND = 343.0  # m/s
_QUIET_F32 = float(np.float32(1e-10))
_LINE_QUIET_F32 = float(np.float32(1e-12))


def _itd_seconds(cos_theta: float, head_radius: float) -> float:
    """Woodworth ray-traced delay for incidence angle θ from the ear axis,
    shifted by +a/c so every delay is causal (0 at the facing pole)."""
    a_c = head_radius / _SPEED_OF_SOUND
    theta = math.acos(max(-1.0, min(1.0, cos_theta)))
    if theta < math.pi / 2:
        tau = -a_c * math.cos(theta)
    else:
        tau = a_c * (theta - math.pi / 2)
    return a_c + tau


def _shadow_coeffs(cos_theta: float, head_radius: float, sample_rate: float):
    """Bilinear transform of the Brown–Duda head-shadow section:
    ``y[n] = b0·x[n] + b1·x[n−1] − a1·y[n−1]`` with ``g = sr/ω₀``,
    b0 = (1+αg)/(1+g), b1 = (1−αg)/(1+g), a1 = (1−g)/(1+g)."""
    alpha = 1.0 + max(-1.0, min(1.0, cos_theta))
    omega0 = _SPEED_OF_SOUND / head_radius
    g = sample_rate / omega0
    inv = 1.0 / (1.0 + g)
    return (
        (1.0 + alpha * g) * inv,
        (1.0 - alpha * g) * inv,
        (1.0 - g) * inv,
    )


class BinauralSpatializerProcessor(NodeProcessor):
    supports_megakernel = False  # per-sample fractional-delay gathers

    def __init__(self, node, sample_rate, max_block_frames, num_inputs, num_outputs):
        super().__init__(sample_rate, max_block_frames, num_inputs, num_outputs)
        self._node = node
        self._coeffs = smoother_coeffs(sample_rate, SmootherConfig())
        # causal delay span: a/c·(1 + π/2), plus interpolation headroom
        max_delay = node.head_radius / _SPEED_OF_SOUND * (1.0 + math.pi / 2.0)
        self._dline = int(math.ceil(max_delay * sample_rate)) + 2

    def group_key(self):
        # the delay line's span is the only static difference
        return (self._dline,)

    def init_state(self):
        gain, dl, dr, *_ = self._host_params()
        return {
            "gain": smoother_init(np.float32(gain)),
            "del_l": smoother_init(np.float32(dl)),
            "del_r": smoother_init(np.float32(dr)),
            "dline": torch.zeros((self._dline,), dtype=torch.float32),
            "xprev": torch.zeros((2,), dtype=torch.float32),
            "yprev": torch.zeros((2,), dtype=torch.float32),
            "lp": torch.zeros((), dtype=torch.float32),
        }

    def _host_params(self):
        """Position → every per-block scalar, in host numpy."""
        n = self._node
        gain, _, dist = spatial_params(
            np.asarray(n._position, np.float32),
            ref_distance=n.ref_distance,
            rolloff=n.rolloff,
        )
        gain = float(gain) * n.volume_gain
        p = np.asarray(n._position, np.float64)
        d = float(np.sqrt(np.sum(p * p)))
        ux = p[0] / d if d > 1e-9 else 0.0
        # incidence angle from each ear's axis (right ear axis = +x)
        cos_r, cos_l = ux, -ux
        sr = self.sample_rate
        dl = _itd_seconds(cos_l, n.head_radius) * sr
        dr = _itd_seconds(cos_r, n.head_radius) * sr
        bl = _shadow_coeffs(cos_l, n.head_radius, sr)
        br = _shadow_coeffs(cos_r, n.head_radius, sr)
        # air absorption: the speaker spatializer's law and coefficient
        # (float32 here: dist is a numpy float32, as in the JAX package)
        cutoff = 20000.0 / (1.0 + 0.5 * max(dist - n.ref_distance, 0.0))
        lp_b = math.exp(-2.0 * math.pi * cutoff / sr)
        return gain, dl, dr, bl, br, lp_b

    def collect_params(self):
        gain, dl, dr, bl, br, lp_b = self._host_params()
        return {
            "gain": np.float32(gain),
            "del_l": np.float32(dl),
            "del_r": np.float32(dr),
            # [ear, (b0, b1, a1)]: left = row 0, right = row 1
            "shadow": np.asarray([bl, br], np.float32),
            "lp_b": np.float32(lp_b),
        }

    def kernel(self, params, state, inputs, in_mask, info):
        frames = inputs.shape[-1]
        d = self._dline

        gain_ramp, gain_state, _ = smoother_set_and_process(
            state["gain"], params["gain"], frames, self._coeffs
        )
        dl_ramp, dl_state, _ = smoother_set_and_process(
            state["del_l"], params["del_l"], frames, self._coeffs
        )
        dr_ramp, dr_state, _ = smoother_set_and_process(
            state["del_r"], params["del_r"], frames, self._coeffs
        )

        x = inputs[..., 0, :] * gain_ramp
        b = params["lp_b"]
        x, lp_last = one_pole_scan(x, state["lp"], (1.0 - b)[..., None], b[..., None])

        # fractional ITD: the mono line gathered at per-sample delayed
        # positions (linear interpolation); the positions stay in
        # [0, D+F-1] by construction (delay <= D-2), clipped for safety
        buf = torch.cat([state["dline"], x], dim=-1)  # [..., D + F]
        t = torch.arange(frames, dtype=torch.float32, device=x.device)

        def ear(delay_ramp):
            pos = torch.clamp(float(d) + t - delay_ramp, 0.0, float(d + frames - 1))
            i0 = torch.floor(pos)
            w = pos - i0
            i0 = i0.to(torch.int64)
            i1 = torch.clamp_max(i0 + 1, d + frames - 1)
            s0 = torch.gather(buf, -1, i0)
            s1 = torch.gather(buf, -1, i1)
            return _fma(s1 - s0, w, s0)  # s0 + (s1 - s0)·w, fused as XLA fuses it

        xe = torch.stack([ear(dl_ramp), ear(dr_ramp)], dim=-2)  # [..., 2, F]

        # head shadow: y[n] = b0 x[n] + b1 x[n-1] - a1 y[n-1] per ear
        sh = params["shadow"]  # [..., 2, 3]
        b0 = sh[..., 0:1]
        b1 = sh[..., 1:2]
        a1 = sh[..., 2:3]
        xe_prev = torch.cat([state["xprev"][..., None], xe[..., :-1]], dim=-1)
        w = _fma(b0.expand_as(xe), xe, b1 * xe_prev)  # b0·xe + b1·xe_prev, fused
        # -a1 keeps its [..., 2, 1] shape, one pole per ear
        y, yprev = one_pole_scan(w, state["yprev"], 1.0, -a1)

        line_quiet = (
            (torch.abs(state["dline"]) < _LINE_QUIET_F32).all(dim=-1)
            & (torch.abs(state["lp"]) < _QUIET_F32)
            & (torch.abs(state["yprev"]) < _LINE_QUIET_F32).all(dim=-1)
        )
        all_silent = in_mask.all(dim=-1) & line_quiet
        y = gate(y, all_silent)
        out_mask = all_silent[..., None].expand(*all_silent.shape, 2)

        def sel(reset, processed):
            return {k: torch.where(all_silent, reset[k], processed[k])
                    for k in processed}

        def zero_if_silent(v):
            return v.masked_fill(all_silent.reshape(
                all_silent.shape + (1,) * (v.ndim - all_silent.ndim)), 0.0)

        new_state = {
            "gain": sel(smoother_init(params["gain"]), gain_state),
            "del_l": sel(smoother_init(params["del_l"]), dl_state),
            "del_r": sel(smoother_init(params["del_r"]), dr_state),
            "dline": zero_if_silent(buf[..., frames:]),
            "xprev": zero_if_silent(xe[..., -1]),
            "yprev": zero_if_silent(yprev),
            "lp": zero_if_silent(lp_last),
        }
        return y, new_state, out_mask


class BinauralSpatializerNode(AudioNode):
    debug_name = "binaural_spatializer"

    def __init__(
        self,
        position=(0.0, 0.0, -1.0),
        volume_gain: float = 1.0,
        ref_distance: float = 1.0,
        rolloff: float = 1.0,
        head_radius: float = 0.0875,
    ):
        """``position``: emitter position relative to the listener
        (listener frame: +x right, +y up, −z forward).  ``head_radius``:
        meters (8.75 cm is the standard spherical-head fit); structural."""
        self._position = tuple(float(v) for v in position)
        self.volume_gain = float(volume_gain)
        self.ref_distance = float(ref_distance)
        self.rolloff = float(rolloff)
        self.head_radius = float(head_radius)

    def position(self):
        return self._position

    def set_position(self, position):
        """Live emitter move; staged into the next dispatch."""
        self._position = tuple(float(v) for v in position)

    def set_volume_gain(self, gain: float):
        self.volume_gain = max(float(gain), 0.0)

    def info(self) -> AudioNodeInfo:
        return AudioNodeInfo(
            num_min_supported_inputs=1,
            num_max_supported_inputs=1,
            num_min_supported_outputs=2,
            num_max_supported_outputs=2,
        )

    def activate(self, sample_rate, max_block_frames, num_inputs, num_outputs):
        if num_inputs != 1 or num_outputs != 2:
            raise NodeActivationError(
                "BinauralSpatializerNode takes 1 (mono) input and 2 "
                f"outputs; got {num_inputs} in, {num_outputs} out"
            )
        return BinauralSpatializerProcessor(
            self, sample_rate, max_block_frames, num_inputs, num_outputs
        )
