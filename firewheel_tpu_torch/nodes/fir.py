"""FIR filter node: arbitrary taps, linear-phase filtering.

PyTorch port of ``firewheel_tpu/nodes/fir.py``.  Where ``FilterNode`` gives
IIR biquads (cheap, phase-warping), this node runs an arbitrary FIR through
the direct convolution (``ops/direct_conv.py:direct_conv_step``, a
depthwise ``conv1d`` with TF32 off), one filter per instance: the tool for
linear-phase EQ, matched or inverse filters, or measured corrections.

Taps are a live param (same length, same channel layout).  Linear-phase
designs delay by ``(N-1)/2`` samples; pair with ``DelayCompNode`` on
parallel paths.  :func:`design_windowed_sinc` builds the windowed
lowpass/highpass/bandpass/bandstop kernels on the host.
"""

from __future__ import annotations

import numpy as np

from ..core.node import (
    gate,
    AudioNode,
    AudioNodeInfo,
    NodeActivationError,
    NodeProcessor,
    MAX_PORTS,
)
from ..ops.direct_conv import direct_conv_step, direct_hist_init

__all__ = ["FirFilterNode", "FirFilterProcessor", "design_windowed_sinc"]


def design_windowed_sinc(
    kind: str,
    num_taps: int,
    sample_rate: float,
    cutoff_hz,
    window: str = "hamming",
):
    """Host-side windowed-sinc FIR design → ``f32[num_taps]`` taps (unit
    passband gain).

    ``kind``: ``"lowpass"``, ``"highpass"``, ``"bandpass"`` or
    ``"bandstop"`` (odd ``num_taps`` for highpass and bandstop: a type-I
    linear-phase filter needs a center tap); ``cutoff_hz``: one corner, or
    ``(lo, hi)`` for the band kinds; ``window``: ``"hamming"``,
    ``"blackman"`` or ``"rect"``."""
    n = int(num_taps)
    if n < 3:
        raise ValueError("num_taps must be >= 3")
    if kind in ("highpass", "bandstop") and n % 2 == 0:
        raise ValueError(f"{kind} needs an odd num_taps (type-I symmetry)")
    m = np.arange(n, dtype=np.float64) - (n - 1) / 2.0

    def sinc_lp(fc):
        return 2.0 * fc / sample_rate * np.sinc(2.0 * fc / sample_rate * m)

    if kind == "lowpass":
        h = sinc_lp(float(cutoff_hz))
    elif kind == "highpass":
        h = -sinc_lp(float(cutoff_hz))
        h[(n - 1) // 2] += 1.0
    elif kind == "bandpass":
        lo, hi = cutoff_hz
        h = sinc_lp(float(hi)) - sinc_lp(float(lo))
    elif kind == "bandstop":
        lo, hi = cutoff_hz
        h = sinc_lp(float(lo)) - sinc_lp(float(hi))
        h[(n - 1) // 2] += 1.0
    else:
        raise ValueError(f"unknown design kind {kind!r}")

    if window == "hamming":
        w = np.hamming(n)
    elif window == "blackman":
        w = np.blackman(n)
    elif window == "rect":
        w = np.ones(n)
    else:
        raise ValueError(f"unknown window {window!r}")
    h = h * w
    # passband gain 1: at DC for lowpass and bandstop, Nyquist for
    # highpass, the band's center for bandpass
    if kind in ("lowpass", "bandstop"):
        h /= np.sum(h)
    elif kind == "highpass":
        h /= np.sum(h * np.cos(np.pi * m))
    else:
        lo, hi = cutoff_hz
        fc = 0.5 * (float(lo) + float(hi))
        h /= np.abs(np.sum(h * np.exp(-2j * np.pi * fc / sample_rate * m)))
    return h.astype(np.float32)


class FirFilterProcessor(NodeProcessor):
    supports_megakernel = False  # no row in K2/K3 (nor in the JAX package's)

    def __init__(self, node, sample_rate, max_block_frames, num_inputs, num_outputs):
        super().__init__(sample_rate, max_block_frames, num_inputs, num_outputs)
        self._node = node
        self._num_taps = node.num_taps()
        self._tap_channels = node._taps.shape[0]

    def group_key(self):
        return (self._num_taps, self._node._taps.shape[0])

    def init_state(self):
        return {"hist": direct_hist_init(self.num_inputs, self._num_taps)}

    def collect_params(self):
        node = self._node
        taps = np.atleast_2d(np.asarray(node._taps, np.float32))
        if taps.shape[-1] != self._num_taps:
            raise ValueError(
                f"taps length changed ({taps.shape[-1]} != activated "
                f"{self._num_taps}); pad to the activated length or re-add "
                "the node"
            )
        if taps.shape[0] != self._tap_channels:
            # a layout change after activation would mis-stack pooled nodes
            raise ValueError(
                f"taps channel count changed ({taps.shape[0]} != activated "
                f"{self._tap_channels}); re-add the node to change the "
                "per-channel/shared layout"
            )
        return {"taps": taps, "gain": np.float32(node._gain)}

    def kernel(self, params, state, inputs, in_mask, info):
        y, hist = direct_conv_step(inputs, state["hist"], params["taps"])
        y = y * params["gain"][..., None, None]
        line_quiet = (state["hist"].abs() < 1e-12).all(dim=-1)
        out_mask = in_mask & line_quiet
        return gate(y, out_mask), {"hist": hist}, out_mask


class FirFilterNode(AudioNode):
    debug_name = "fir_filter"

    def __init__(self, taps, gain: float = 1.0, report_latency: bool = False):
        """``taps``: ``f32[N]`` (shared across channels) or ``f32[ch, N]``,
        e.g. from :func:`design_windowed_sinc` or a measured IR.  ``gain``:
        post-filter linear gain (live).  ``report_latency``: declare the
        linear-phase group delay ``(N-1)//2`` to latency compensation
        (``AudioNode.latency_frames``); only meaningful for (near-)linear-
        phase taps, so off by default."""
        self._taps = np.atleast_2d(np.array(taps, np.float32, copy=True))
        self._gain = float(gain)
        self._report_latency = bool(report_latency)

    def latency_frames(self, sample_rate: int) -> int:
        if self._report_latency:
            return (self._taps.shape[-1] - 1) // 2
        return 0

    def num_taps(self) -> int:
        return self._taps.shape[-1]

    def set_taps(self, taps):
        """Swap taps live (same length and layout); the array is copied."""
        self._taps = np.atleast_2d(np.array(taps, np.float32, copy=True))

    def set_gain(self, gain: float):
        self._gain = float(gain)

    def info(self) -> AudioNodeInfo:
        return AudioNodeInfo(
            num_min_supported_inputs=1,
            num_max_supported_inputs=MAX_PORTS,
            num_min_supported_outputs=1,
            num_max_supported_outputs=MAX_PORTS,
        )

    def activate(self, sample_rate, max_block_frames, num_inputs, num_outputs):
        if num_inputs != num_outputs:
            raise NodeActivationError(
                "FirFilterNode requires num_inputs == num_outputs; "
                f"got {num_inputs} in, {num_outputs} out"
            )
        tch = self._taps.shape[0]
        if tch not in (1, num_inputs):
            raise NodeActivationError(
                f"taps have {tch} channels; expected 1 or {num_inputs}"
            )
        return FirFilterProcessor(
            self, sample_rate, max_block_frames, num_inputs, num_outputs
        )
