"""Parameter smoothing: a one-pole lowpass ramp toward a target value.

PyTorch port of ``firewheel_tpu/core/smoother.py`` (the device kernel
only).  Reference semantics: ``param/smoother.rs:72-226`` — recurrence
``y[i] = a*x + b*y[i-1]`` with ``b = exp(-1/(smooth_secs*sr))``, ``a = 1-b``,
default 10 ms / settle epsilon 1e-5, and an Inactive/Active/Deactivating
status machine.  The ramp is evaluated in closed form::

    y[i] = x_eff + (y0 - x_eff) * b^(i+1),   x_eff = (x*a)/a

The state is a dict ``{"target", "last", "status"}`` of tensors with any
leading batch shape: the fields of :class:`SmootherState`, which
``convert.as_dicts`` turns into that dict.  :class:`ParamSmoother` is the
host-side smoother with the reference's imperative API, in numpy.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "SmootherConfig",
    "SmootherState",
    "ParamSmoother",
    "SMOOTHER_INACTIVE",
    "SMOOTHER_ACTIVE",
    "SMOOTHER_DEACTIVATING",
    "smoother_coeffs",
    "smoother_init",
    "smoother_reset",
    "smoother_set_and_process",
]

# Status encoding (smoother.rs:29-39).
SMOOTHER_INACTIVE = 0
SMOOTHER_ACTIVE = 1
SMOOTHER_DEACTIVATING = 2


@dataclasses.dataclass(frozen=True)
class SmootherConfig:
    """Smoothing time and settle threshold (smoother.rs:7-25)."""

    smooth_secs: float = 10.0 / 1000.0
    settle_epsilon: float = 0.00001


class SmootherState(NamedTuple):
    """The smoother's recurrent carry, as the JAX package names it.

    ``target``: the value being smoothed toward (smoother.rs ``input``).
    ``last``:   the most recent output sample (smoother.rs ``last_output``).
    ``status``: int32 status machine value.

    The kernels carry it as a dict of these fields (:func:`smoother_init`);
    ``SmootherState(**state)`` and ``state._asdict()`` convert.
    """

    target: torch.Tensor
    last: torch.Tensor
    status: torch.Tensor


def smoother_coeffs(sample_rate: int, config: SmootherConfig = SmootherConfig()):
    """Precompute ``(b, a, log_b)`` in float32 (smoother.rs:99-100).

    ``log_b`` is computed in float64 for ramp-power accuracy, then truncated.
    """
    b = np.float32(np.exp(np.float32(-1.0 / (config.smooth_secs * sample_rate))))
    a = np.float32(np.float32(1.0) - b)
    log_b = np.float32(math.log(float(b)))
    return b, a, log_b


def smoother_init(val) -> dict:
    """Fresh state holding ``val`` (smoother.rs:93-112)."""
    v = torch.as_tensor(val, dtype=torch.float32)
    return {
        "target": v,
        "last": v,
        "status": torch.full(v.shape, SMOOTHER_INACTIVE, dtype=torch.int32,
                             device=v.device),
    }


def smoother_reset(state: dict, val) -> dict:
    """Reset to a flat value, deactivating (smoother.rs:115-129)."""
    return smoother_init(val)


def smoother_set_and_process(
    state: dict,
    val: torch.Tensor,
    frames: int,
    coeffs,
    settle_epsilon: float = 0.00001,
):
    """Set a new target and produce the smoothed ramp for one block
    (``ParamSmoother::set_and_process``, smoother.rs:202-205 → 133-140,
    159-194).

    ``state`` leaves and ``val`` share a leading shape ``S``.  Returns
    ``(values f32[*S, frames], new_state, is_smoothing bool[*S])``.
    """
    b, a, log_b = coeffs
    a = float(a)
    val = val.to(torch.float32)

    # set() — begin smoothing iff the target changed (smoother.rs:133-140).
    changed = val != state["target"]
    status = torch.where(
        changed, torch.full_like(state["status"], SMOOTHER_ACTIVE),
        state["status"],
    )
    target = val
    is_active = status == SMOOTHER_ACTIVE

    # Closed-form ramp of the float32 recurrence (smoother.rs:169-177).
    inp = target * a
    x_eff = inp / a
    k = torch.arange(1, frames + 1, dtype=torch.float32, device=val.device)
    b_pow = torch.exp(k * float(log_b))
    last = state["last"]
    ramp = x_eff[..., None] + (last - x_eff)[..., None] * b_pow

    # Settle check uses the *first* ramp sample (smoother.rs:180-184); on
    # settle the reference refills the block with the flat target.
    settled = is_active & (
        torch.abs(target - ramp[..., 0]) < float(np.float32(settle_epsilon))
    )

    values = torch.where(
        settled[..., None],
        target[..., None],
        torch.where(is_active[..., None], ramp, last[..., None]),
    )
    new_last = torch.where(
        settled, target, torch.where(is_active, ramp[..., frames - 1], last)
    )
    new_status = torch.where(
        settled,
        torch.full_like(status, SMOOTHER_DEACTIVATING),
        torch.where(
            is_active,
            torch.full_like(status, SMOOTHER_ACTIVE),
            # Deactivating -> Inactive on the next cycle (smoother.rs:36-38).
            torch.where(
                status == SMOOTHER_DEACTIVATING,
                torch.full_like(status, SMOOTHER_INACTIVE),
                status,
            ),
        ),
    )
    new_state = {"target": target, "last": new_last, "status": new_status}
    return values, new_state, new_status != SMOOTHER_INACTIVE


class ParamSmoother:
    """Host-side smoother with the reference's imperative API.

    Useful for host-driven control paths and as an executable spec; the
    compiled graph path uses :func:`smoother_set_and_process` directly.
    """

    def __init__(
        self,
        val: float,
        sample_rate: int,
        max_block_frames: int,
        config: SmootherConfig = SmootherConfig(),
    ):
        self._coeffs = smoother_coeffs(sample_rate, config)
        self._eps = config.settle_epsilon
        self._max_block_frames = max_block_frames
        self._target = np.float32(val)
        self._last = np.float32(val)
        self._status = SMOOTHER_INACTIVE

    # -- queries (smoother.rs:143-153, 208-226) -----------------------------
    def dest(self) -> float:
        return float(self._target)

    def current_value(self):
        return float(self._last), self._status

    def is_active(self) -> bool:
        return self._status != SMOOTHER_INACTIVE

    def constant_value(self):
        return None if self.is_active() else float(self._target)

    def max_block_frames(self) -> int:
        return self._max_block_frames

    # -- mutation ------------------------------------------------------------
    def reset(self, val: float):
        self._target = np.float32(val)
        self._last = np.float32(val)
        self._status = SMOOTHER_INACTIVE

    def set(self, val: float):
        val = np.float32(val)
        if val != self._target:
            self._target = val
            self._status = SMOOTHER_ACTIVE

    def process(self, frames: int) -> tuple[np.ndarray, int]:
        frames = min(frames, self._max_block_frames)
        b, a, log_b = self._coeffs
        if self._status != SMOOTHER_ACTIVE or frames == 0:
            if self._status == SMOOTHER_DEACTIVATING:
                self._status = SMOOTHER_INACTIVE
                return np.full(frames, self._last, np.float32), SMOOTHER_DEACTIVATING
            return np.full(frames, self._last, np.float32), self._status

        # Float64-exact closed form, truncated to f32 (the golden semantics).
        inp = np.float32(self._target * a)
        x_eff = np.float64(inp) / np.float64(a)
        kpow = np.exp(
            np.arange(1, frames + 1, dtype=np.float64) * math.log(float(b))
        )
        ramp = (x_eff + (np.float64(self._last) - x_eff) * kpow).astype(np.float32)

        if abs(float(self._target) - float(ramp[0])) < self._eps:
            out = np.full(frames, self._target, np.float32)
            self._last = np.float32(self._target)
            self._status = SMOOTHER_DEACTIVATING
            return out, SMOOTHER_DEACTIVATING

        self._last = np.float32(ramp[-1])
        return ramp, SMOOTHER_ACTIVE

    def set_and_process(self, val: float, frames: int):
        self.set(val)
        return self.process(frames)
