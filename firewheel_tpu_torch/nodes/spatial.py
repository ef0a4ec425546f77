"""3D spatializer node: position a mono emitter in the listener's space.

PyTorch port of ``firewheel_tpu/nodes/spatial.py``.  Signal chain::

    mono in → distance gain → air-absorption lowpass → equal-power pan → L/R

* distance gain: inverse-distance rolloff (``ops/pan.spatial_params``);
* air absorption: a one-pole lowpass whose cutoff falls with distance
  (20 kHz at the reference distance down to ~1.2 kHz far away);
* occlusion (``set_occlusion``, 0..1): the obstructed direct path loses up
  to ``occlusion_db`` of level and its cutoff glides geometrically toward
  ``occlusion_cutoff_hz``; pure param shaping on the host;
* panning: equal-power from the horizontal azimuth.

Gain and pan ride 10 ms smoothers.  The params are staged on the host in
numpy (:meth:`Spatializer3DProcessor.stage`), bit for bit the JAX
package's.

``doppler=True`` prepends physical propagation: the mono signal runs
through a power-of-two ring whose fractional tap sits ``distance/c``
seconds back, with the distance ramped per sample, so a moving emitter's
Doppler shift falls out of the time-varying delay.  The tap is gathered per
sample, which the megakernel has no device function for, so the doppler
variant opts out of it (``supports_megakernel = False``) and renders as a
torch stage on the hybrid lowering.

The one-pole runs as the associative scan in :meth:`kernel` (the JAX
package's op order) and as the sequential recurrence of the megakernel's
spatializer row in :meth:`sequential_kernel`, which K2's and K3's plain
versions call.
"""

from __future__ import annotations

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
from ..ops.iir import BiquadCoeffs, _fma, one_pole_scan
from ..ops.pan import equal_power_gains, spatial_params
from ..ops.seq_iir import biquad_seq

__all__ = ["Spatializer3DNode", "Spatializer3DProcessor", "one_pole_seq"]

_QUIET_F32 = float(np.float32(1e-10))


def one_pole_seq(x: torch.Tensor, y_prev: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor):
    """``y[n] = a·x[n] + b·y[n-1]`` as the sequential recurrence, through
    the sequential biquad (K1 on a CUDA tensor, its plain version on the
    CPU) with ``(b0, b1, b2, a1, a2) = (a, 0, 0, -b, 0)`` and ``z1 = b·y_prev``:
    each step is ``y = fma(a, x, b·y_prev)``, the rounding of the
    megakernel's spatializer row (``csrc/megakernel.cu:op_spatial``).
    ``a``, ``b`` and ``y_prev`` are ``f32[...]`` over ``x f32[..., n]``.
    Returns ``(y, y_last)``."""
    zero = torch.zeros_like(b)
    y, _ = biquad_seq(x.contiguous(), (b * y_prev, torch.zeros_like(y_prev)),
                      BiquadCoeffs(a, zero, zero, -b, zero))
    return y, y[..., x.shape[-1] - 1]


class Spatializer3DProcessor(NodeProcessor):
    def __init__(self, node, sample_rate, max_block_frames, num_inputs, num_outputs):
        super().__init__(sample_rate, max_block_frames, num_inputs, num_outputs)
        self._node = node
        self._coeffs = smoother_coeffs(sample_rate, SmootherConfig())
        self._doppler = bool(node.doppler)
        if self._doppler:
            # the per-sample fractional tap has no device function
            self.supports_megakernel = False
            self._motion_coeffs = smoother_coeffs(
                sample_rate, SmootherConfig(smooth_secs=node.motion_smooth_secs)
            )
            max_tau = node.max_distance_m / node.speed_of_sound * sample_rate
            need = int(np.ceil(max_tau)) + max_block_frames + 4
            self._ring_len = 1 << int(need - 1).bit_length()
            self._tau_per_m = float(np.float32(sample_rate / node.speed_of_sound))

    def init_state(self):
        # the smoothers start at the targets collect_params gives (volume
        # and occlusion included), so a fresh node does not ramp in
        p = self.collect_params()
        st = {
            "gain": smoother_init(np.float32(p["gain"])),
            "pan": smoother_init(np.float32(p["pan"])),
            "lp": torch.zeros((), dtype=torch.float32),
        }
        if self._doppler:
            st["dist"] = smoother_init(np.float32(p["dist"]))
            st["ring"] = torch.zeros((self._ring_len,), dtype=torch.float32)
        return st

    def stage(self, position, volume_gain, occlusion) -> dict:
        """The params for emitter ``position`` (``[..., 3]``, listener
        frame), ``volume_gain`` and ``occlusion`` (``[...]``), as numpy
        float32 arrays ``[...]``: the JAX package's ``collect_params``
        arithmetic (float32 distance law, float64 cutoff and occlusion
        shaping), elementwise, so a batch of instances stages at once."""
        n = self._node
        gain, pan, dist = spatial_params(
            np.asarray(position, np.float32),
            ref_distance=n.ref_distance,
            rolloff=n.rolloff,
        )
        dist = dist.astype(np.float64)
        # air absorption: cutoff shrinks with distance
        cutoff = 20000.0 / (1.0 + 0.5 * np.maximum(dist - n.ref_distance, 0.0))
        # occlusion: the level drops linearly in dB, the cutoff glides
        # geometrically toward occlusion_cutoff_hz
        occ = np.asarray(occlusion, np.float64)
        occluded = occ > 0.0
        gain = gain.astype(np.float64) * np.where(
            occluded, 10.0 ** (-n.occlusion_db * occ / 20.0), 1.0)
        occ_cut = 20000.0 * (n.occlusion_cutoff_hz / 20000.0) ** occ
        cutoff = np.where(occluded, np.minimum(cutoff, occ_cut), cutoff)
        b = np.exp(np.float32(-2.0 * np.pi) * cutoff.astype(np.float32)
                   / np.float32(self.sample_rate)).astype(np.float32)
        out = {
            "gain": (gain * np.asarray(volume_gain, np.float64)).astype(np.float32),
            "pan": pan.astype(np.float32),
            "lp_b": b,
        }
        if self._doppler:
            out["dist"] = np.minimum(np.maximum(dist, 0.0),
                                     n.max_distance_m).astype(np.float32)
        return out

    def collect_params(self):
        n = self._node
        return {k: np.float32(v) for k, v in self.stage(
            n._position, n.volume_gain, n._occlusion).items()}

    def group_key(self):
        n = self._node
        key = (n.ref_distance, n.rolloff, self._doppler)
        if self._doppler:
            key += (self._ring_len, n.motion_smooth_secs, n.speed_of_sound)
        return key

    def kernel(self, params, state, inputs, in_mask, info):
        def scan(x, y_prev, b):
            return one_pole_scan(x, y_prev, (1.0 - b)[..., None], b[..., None])

        return self._kernel(params, state, inputs, in_mask, scan)

    def sequential_kernel(self, params, state, inputs, in_mask, info):
        """The kernel with the one-pole as the sequential recurrence: what
        the megakernel (K2, K3) computes for this node."""
        return self._kernel(params, state, inputs, in_mask,
                            lambda x, y_prev, b: one_pole_seq(x, y_prev, 1.0 - b, b))

    def _kernel(self, params, state, inputs, in_mask, one_pole):
        frames = inputs.shape[-1]
        gain_ramp, gain_state, _ = smoother_set_and_process(
            state["gain"], params["gain"], frames, self._coeffs
        )
        pan_ramp, pan_state, _ = smoother_set_and_process(
            state["pan"], params["pan"], frames, self._coeffs
        )

        x = inputs[..., 0, :]
        new_state = {}
        tail_live = torch.abs(state["lp"]) >= _QUIET_F32
        if self._doppler:
            # physical propagation: write this block, read distance/c back
            # with a per-sample-ramped fractional tap
            dist_ramp, dist_state, _ = smoother_set_and_process(
                state["dist"], params["dist"], frames, self._motion_coeffs
            )
            ring = torch.cat([state["ring"][..., frames:], x], dim=-1)
            r = self._ring_len
            tau = dist_ramp * self._tau_per_m
            base = torch.arange(frames, dtype=torch.float32, device=x.device)
            pos = torch.clamp(float(r - frames) + base - tau, 0.0, float(r - 2))
            i0 = torch.floor(pos)
            w = pos - i0
            i0 = i0.to(torch.int64)
            # ring[i0]·(1 - w) + ring[i0 + 1]·w, fused as XLA fuses it
            x = _fma(torch.gather(ring, -1, i0 + 1), w,
                     torch.gather(ring, -1, i0) * (1.0 - w))
            new_state["dist"] = dist_state
            new_state["ring"] = ring
            # the line holds sound in flight: audible until it drains
            tail_live = tail_live | (
                torch.amax(torch.abs(state["ring"]), dim=-1) >= _QUIET_F32)

        x = x * gain_ramp
        x, lp_last = one_pole(x, state["lp"], params["lp_b"])

        gl, gr = equal_power_gains(pan_ramp)
        all_silent = in_mask.all(dim=-1) & ~tail_live
        out = gate(torch.stack([x * gl, x * gr], dim=-2), all_silent)
        out_mask = all_silent[..., None].expand(*all_silent.shape, 2)

        def sel(reset, processed):
            return {k: torch.where(all_silent, reset[k], processed[k])
                    for k in processed}

        new_state.update(
            gain=sel(smoother_init(params["gain"]), gain_state),
            pan=sel(smoother_init(params["pan"]), pan_state),
            lp=torch.where(all_silent, torch.zeros_like(lp_last), lp_last),
        )
        if self._doppler:
            new_state["dist"] = sel(smoother_init(params["dist"]), new_state["dist"])
        return out, new_state, out_mask


class Spatializer3DNode(AudioNode):
    debug_name = "spatializer_3d"

    def __init__(
        self,
        position=(0.0, 0.0, -1.0),
        volume_gain: float = 1.0,
        ref_distance: float = 1.0,
        rolloff: float = 1.0,
        doppler: bool = False,
        speed_of_sound: float = 343.0,
        max_distance_m: float = 100.0,
        motion_smooth_secs: float = 0.05,
        occlusion_db: float = 18.0,
        occlusion_cutoff_hz: float = 350.0,
    ):
        """``position``: emitter position relative to the listener
        (listener frame: +x right, +y up, −z forward).

        ``doppler``: physical propagation delay + Doppler via a moving
        fractional tap (see the module docstring); structural.
        ``max_distance_m`` bounds the delay line (distances clamp to it);
        ``motion_smooth_secs`` is the one-pole time constant position
        changes ramp with."""
        self._position = tuple(float(v) for v in position)
        self.volume_gain = float(volume_gain)
        self.ref_distance = float(ref_distance)
        self.rolloff = float(rolloff)
        self.doppler = bool(doppler)
        self.speed_of_sound = max(float(speed_of_sound), 1.0)
        self.max_distance_m = max(float(max_distance_m), 1.0)
        self.motion_smooth_secs = max(float(motion_smooth_secs), 1e-4)
        self.occlusion_db = max(float(occlusion_db), 0.0)
        self.occlusion_cutoff_hz = min(
            max(float(occlusion_cutoff_hz), 20.0), 20000.0
        )
        self._occlusion = 0.0

    def position(self):
        return self._position

    def set_position(self, position):
        """Live emitter move; staged into the next dispatch."""
        self._position = tuple(float(v) for v in position)

    def set_volume_gain(self, gain: float):
        self.volume_gain = max(float(gain), 0.0)

    def set_occlusion(self, occlusion: float):
        """Obstruction amount in [0, 1] from the game's geometry query
        (0 = clear line of sight, 1 = fully occluded).  Live param: the
        gain change rides the 10 ms smoother, the cutoff applies next
        block."""
        self._occlusion = min(max(float(occlusion), 0.0), 1.0)

    def occlusion(self) -> float:
        return self._occlusion

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
                "Spatializer3DNode takes 1 (mono) input and 2 outputs; "
                f"got {num_inputs} in, {num_outputs} out"
            )
        return Spatializer3DProcessor(
            self, sample_rate, max_block_frames, num_inputs, num_outputs
        )
