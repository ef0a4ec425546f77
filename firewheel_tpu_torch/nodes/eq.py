"""Parametric EQ node: a cascade of RBJ biquad bands with live controls.

PyTorch port of ``firewheel_tpu/nodes/eq.py``.  Each band is one RBJ
section; the bands run in series through
:func:`~firewheel_tpu_torch.ops.iir.biquad_cascade`, bit for bit the JAX
package's ``biquad_scan`` a band (one launch of K7 a block on the card; in
K2/K3 the EQ's row runs the same scan).
The band types and count are structural;
every frequency, Q, gain and a per-band ``enabled`` bypass are live params,
staged on the host as float32 coefficients by the filter node's designs
(in numpy float32 for host numbers, bit for bit the JAX package's staging).  A
disabled band is the identity section ``(1, 0, 0, 0, 0)``, so its state
keeps flowing and re-enabling it replays no stale tail.

State: the TDF-II pair of each band per channel, under the JAX package's
flat keys ``z1_{i}``/``z2_{i}``.  Params: ``{"bands": {"0": {"b0", "b1",
"b2", "a1", "a2"}, ...}}``, the JAX package's tuple of band dicts keyed by
position (``convert.as_dicts``).
"""

from __future__ import annotations

import dataclasses

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
from ..ops.iir import BiquadCoeffs, biquad_cascade
from .filter import FilterType, _DESIGNS, _QUIET_F32

__all__ = ["EQBand", "ParametricEQNode", "ParametricEQProcessor"]

_IDENTITY = (1.0, 0.0, 0.0, 0.0, 0.0)


@dataclasses.dataclass
class EQBand:
    """One EQ band. ``band_type`` is structural; the rest are live."""

    band_type: str = FilterType.PEAKING
    frequency_hz: float = 1000.0
    q: float = 0.7071
    gain_db: float = 0.0
    enabled: bool = True

    def __post_init__(self):
        assert self.band_type in _DESIGNS, f"unknown band type {self.band_type!r}"
        self.frequency_hz = float(np.clip(self.frequency_hz, 1.0, 20_000.0))
        self.q = max(float(self.q), 1e-3)
        self.gain_db = float(self.gain_db)
        self.enabled = bool(self.enabled)


class ParametricEQProcessor(NodeProcessor):
    def __init__(self, node, sample_rate, max_block_frames, num_inputs, num_outputs):
        super().__init__(sample_rate, max_block_frames, num_inputs, num_outputs)
        self._node = node
        self._types = tuple(b.band_type for b in node._bands)

    def group_key(self):
        return (self._types,)

    def init_state(self):
        ch = self.num_inputs
        st = {}
        for i in range(len(self._types)):
            st[f"z1_{i}"] = torch.zeros((ch,), dtype=torch.float32)
            st[f"z2_{i}"] = torch.zeros((ch,), dtype=torch.float32)
        return st

    def collect_params(self):
        bands = {}
        for i, (b, band_type) in enumerate(zip(self._node._bands, self._types)):
            if b.enabled:
                # host numbers: the designs run in numpy float32, as the
                # JAX package stages them, bit for bit
                c = _DESIGNS[band_type](b.frequency_hz, b.q, b.gain_db,
                                        self.sample_rate)
                cs = tuple(np.float32(v) for v in c)
            else:
                cs = tuple(np.float32(v) for v in _IDENTITY)
            bands[str(i)] = dict(zip(BiquadCoeffs._fields, cs))
        return {"bands": bands}

    def kernel(self, params, state, inputs, in_mask, info):
        # per-channel quietness, so one ringing channel does not mark its
        # silent sibling audible
        quiet = torch.ones(in_mask.shape, dtype=torch.bool, device=in_mask.device)
        sections, states = [], []
        for i in range(len(self._types)):
            band = params["bands"][str(i)]
            # per-instance coefficients [...] → one per channel [..., 1]
            sections.append(BiquadCoeffs(*(band[k][..., None]
                                           for k in BiquadCoeffs._fields)))
            z1, z2 = state[f"z1_{i}"], state[f"z2_{i}"]
            quiet = quiet & (torch.abs(z1) < _QUIET_F32) & (torch.abs(z2) < _QUIET_F32)
            states.append((z1, z2))
        y, states = biquad_cascade(inputs, states, sections)
        new_state = {}
        for i, (z1, z2) in enumerate(states):
            new_state[f"z1_{i}"] = z1
            new_state[f"z2_{i}"] = z2

        out_mask = in_mask & quiet
        return gate(y, out_mask), new_state, out_mask


class ParametricEQNode(AudioNode):
    """Multi-band parametric EQ (see module docstring).

    ``bands`` fixes the band types and count at construction (structural);
    use :meth:`set_band` / :meth:`set_enabled` for live control.  The
    default is the classic 4-band channel strip: low shelf, two peaks, high
    shelf.
    """

    debug_name = "parametric_eq"

    def __init__(self, bands: list[EQBand] | None = None):
        if bands is None:
            bands = [
                EQBand(FilterType.LOW_SHELF, 120.0),
                EQBand(FilterType.PEAKING, 400.0),
                EQBand(FilterType.PEAKING, 2500.0),
                EQBand(FilterType.HIGH_SHELF, 8000.0),
            ]
        assert len(bands) >= 1, "ParametricEQNode needs at least one band"
        self._bands = [b if isinstance(b, EQBand) else EQBand(**b) for b in bands]

    def num_bands(self) -> int:
        return len(self._bands)

    def band(self, i: int) -> EQBand:
        return self._bands[i]

    def set_band(self, i: int, frequency_hz: float | None = None,
                 q: float | None = None, gain_db: float | None = None):
        b = self._bands[i]
        if frequency_hz is not None:
            b.frequency_hz = float(np.clip(frequency_hz, 1.0, 20_000.0))
        if q is not None:
            b.q = max(float(q), 1e-3)
        if gain_db is not None:
            b.gain_db = float(gain_db)

    def set_enabled(self, i: int, enabled: bool):
        self._bands[i].enabled = bool(enabled)

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
                "ParametricEQNode requires num_inputs == num_outputs; "
                f"got {num_inputs} in, {num_outputs} out"
            )
        return ParametricEQProcessor(
            self, sample_rate, max_block_frames, num_inputs, num_outputs
        )
