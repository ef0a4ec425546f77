"""Filter node: biquad lowpass/highpass/bandpass/notch/peak/shelf sections.

PyTorch port of ``firewheel_tpu/nodes/filter.py``.  Each channel runs one
biquad section, through the associative scan
(:func:`~firewheel_tpu_torch.ops.iir.biquad_scan`, backends ``"auto"`` and
``"scan"``, the JAX package's default) or through the sequential kernel
(:func:`~firewheel_tpu_torch.ops.seq_iir.biquad_seq`, backend
``"pallas"``, the port of the JAX package's Pallas kernel).  The two round
differently.  Cutoff/Q/gain are live params and the coefficients are
rebuilt in float32 every block, per instance.
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
    MAX_PORTS,
)
from ..ops.iir import (
    BiquadCoeffs,
    biquad_allpass,
    biquad_bandpass,
    biquad_high_shelf,
    biquad_highpass,
    biquad_low_shelf,
    biquad_lowpass,
    biquad_notch,
    biquad_peaking,
    biquad_scan,
)
from ..ops.seq_iir import biquad_seq

__all__ = ["FilterType", "FilterNode", "FilterProcessor"]


class FilterType:
    LOWPASS = "lowpass"
    HIGHPASS = "highpass"
    BANDPASS = "bandpass"
    NOTCH = "notch"
    ALLPASS = "allpass"
    PEAKING = "peaking"
    LOW_SHELF = "low_shelf"
    HIGH_SHELF = "high_shelf"


_DESIGNS = {
    FilterType.LOWPASS: lambda f, q, g, sr: biquad_lowpass(f, q, sr),
    FilterType.HIGHPASS: lambda f, q, g, sr: biquad_highpass(f, q, sr),
    FilterType.BANDPASS: lambda f, q, g, sr: biquad_bandpass(f, q, sr),
    FilterType.NOTCH: lambda f, q, g, sr: biquad_notch(f, q, sr),
    FilterType.ALLPASS: lambda f, q, g, sr: biquad_allpass(f, q, sr),
    FilterType.PEAKING: biquad_peaking,
    FilterType.LOW_SHELF: biquad_low_shelf,
    FilterType.HIGH_SHELF: biquad_high_shelf,
}

_QUIET_F32 = float(np.float32(1e-10))


class FilterProcessor(NodeProcessor):
    def __init__(self, node, sample_rate, max_block_frames, num_inputs, num_outputs):
        super().__init__(sample_rate, max_block_frames, num_inputs, num_outputs)
        self._node = node
        self._design = _DESIGNS[node.filter_type]
        # "auto" is the associative scan, as in the JAX package
        self._backend = "scan" if node.backend == "auto" else node.backend

    def init_state(self):
        ch = self.num_inputs
        return {
            "z1": torch.zeros((ch,), dtype=torch.float32),
            "z2": torch.zeros((ch,), dtype=torch.float32),
        }

    def collect_params(self):
        n = self._node
        return {
            "freq": np.float32(n.frequency()),
            "q": np.float32(n.q()),
            "gain_db": np.float32(n.gain_db()),
        }

    def group_key(self):
        return (self._node.filter_type, self._backend)

    def kernel(self, params, state, inputs, in_mask, info):
        run = biquad_seq if self._backend == "pallas" else biquad_scan
        return self._kernel(params, state, inputs, in_mask, run)

    def sequential_kernel(self, params, state, inputs, in_mask, info):
        """The kernel on the sequential recurrence whatever the backend:
        what the megakernel (K2, K3) computes for this node."""
        return self._kernel(params, state, inputs, in_mask, biquad_seq)

    def _kernel(self, params, state, inputs, in_mask, run):
        # per-instance coefficients [...] → one per lane [..., ch]
        coeffs = BiquadCoeffs(*(
            c[..., None]
            for c in self._design(
                params["freq"], params["q"], params["gain_db"],
                self.sample_rate,
            )
        ))
        y, (z1, z2) = run(inputs.contiguous(), (state["z1"], state["z2"]), coeffs)

        # All-silent input with settled (zero) filter state stays silent;
        # with ringing state the filter tail is real audio — only flag
        # channels whose input AND state are quiet.
        state_quiet = (torch.abs(state["z1"]) < _QUIET_F32) & (
            torch.abs(state["z2"]) < _QUIET_F32
        )
        out_mask = in_mask & state_quiet
        return gate(y, out_mask), {"z1": z1, "z2": z2}, out_mask


class FilterNode(AudioNode):
    debug_name = "filter"

    def __init__(
        self,
        filter_type: str = FilterType.LOWPASS,
        frequency_hz: float = 1000.0,
        q: float = 0.7071,
        gain_db: float = 0.0,
        backend: str = "auto",
    ):
        """``backend``: ``"auto"`` or ``"scan"`` (the associative scan) or
        ``"pallas"`` (the sequential biquad, kernel K1 on the card)."""
        assert filter_type in _DESIGNS, f"unknown filter type {filter_type!r}"
        assert backend in ("auto", "scan", "pallas"), backend
        self.filter_type = filter_type
        self.backend = backend
        self._freq = float(np.clip(frequency_hz, 1.0, 20_000.0))
        self._q = max(float(q), 1e-3)
        self._gain_db = float(gain_db)

    def frequency(self) -> float:
        return self._freq

    def set_frequency(self, hz: float):
        self._freq = float(np.clip(hz, 1.0, 20_000.0))

    def q(self) -> float:
        return self._q

    def set_q(self, q: float):
        self._q = max(float(q), 1e-3)

    def gain_db(self) -> float:
        return self._gain_db

    def set_gain_db(self, db: float):
        self._gain_db = float(db)

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
                "FilterNode requires num_inputs == num_outputs; "
                f"got {num_inputs} in, {num_outputs} out"
            )
        return FilterProcessor(
            self, sample_rate, max_block_frames, num_inputs, num_outputs
        )
