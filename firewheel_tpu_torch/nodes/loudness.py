"""EBU R128 / ITU-R BS.1770 loudness meter node.

PyTorch port of ``firewheel_tpu/nodes/loudness.py``.  The kernel runs the
K-weighting pre-filter (two biquads through the associative scan, as the
JAX package does, in series as one ``ops/iir.py:biquad_cascade``: one
launch of K7 a block on the card) and integrates the
channel-weighted mean square into a ring of 100 ms gating blocks.  On the
host, :meth:`LoudnessMeterNode.read` turns the ring into momentary (400 ms)
and short-term (3 s) loudness, and :class:`IntegratedLoudness` applies the
R128 two-stage gate to a stream of gating-block readings.

The ring's uint32 leaves (``counts``, ``pos``, ``idx``) ride as int64
masked to 32 bits.  A block touches at most ``ceil(F/hop) + 1`` hops; each
hop's energy is summed by a reduction and added to its slot by a select,
never by a scatter-add (whose float atomics sum in no fixed order on the
card).

Passthrough like ``DbMeterNode``: wire it in line (outputs mirror inputs)
or as a pure sink (0 outputs).  It has a row in the megakernels (K2, K3;
``executor_mega.OPS``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.node import (
    AudioNode,
    AudioNodeInfo,
    NodeActivationError,
    NodeProcessor,
    MAX_PORTS,
)
from ..ops.iir import BiquadCoeffs, biquad_cascade
from ..ops.loudness import k_weighting_coeffs, lufs_from_mean_square

__all__ = ["LoudnessMeterNode", "LoudnessMeterProcessor", "IntegratedLoudness"]

# R128 gating blocks: 400 ms windows with 75% overlap, one block per 100 ms
_GATE_HOP_SECS = 0.1
_MOMENTARY_BLOCKS = 4   # 400 ms
_SHORT_TERM_BLOCKS = 30  # 3 s


class LoudnessMeterProcessor(NodeProcessor):
    def __init__(self, node, sample_rate, max_block_frames, num_inputs, num_outputs):
        super().__init__(sample_rate, max_block_frames, num_inputs, num_outputs)
        self._node = node
        self.hop_frames = max(1, int(round(_GATE_HOP_SECS * sample_rate)))
        shelf, hp = k_weighting_coeffs(sample_rate)
        self._shelf = BiquadCoeffs(*(float(c) for c in shelf))
        self._hp = BiquadCoeffs(*(float(c) for c in hp))
        # BS.1770 channel weights: 1.0 for L/R/C, 1.41 for the surrounds;
        # without layout metadata every channel weighs 1.0
        if node._channel_weights is not None:
            w = np.asarray(node._channel_weights, np.float32)
            if w.shape != (num_inputs,):
                raise NodeActivationError(
                    f"channel_weights has {w.shape[0] if w.ndim else 0} "
                    f"entries but the node was activated with {num_inputs} "
                    "inputs"
                )
            self._weights = w
        else:
            self._weights = np.ones((num_inputs,), np.float32)
        self._weights_on: dict = {}  # device -> the weights as a tensor there

    def group_key(self):
        # the weights are constants: only identically weighted meters pool
        return (tuple(float(w) for w in self._weights),)

    def init_state(self):
        ch = self.num_inputs
        ring_len = _SHORT_TERM_BLOCKS + 1
        return {
            "shelf_z": torch.zeros((ch, 2), dtype=torch.float32),
            "hp_z": torch.zeros((ch, 2), dtype=torch.float32),
            # per-hop energy sums (weighted, channel-summed) and sample
            # counts; the write index advances every hop_frames samples
            "ring": torch.zeros((ring_len,), dtype=torch.float32),
            "counts": torch.zeros((ring_len,), dtype=torch.int64),
            "pos": torch.zeros((), dtype=torch.int64),  # sample position in the hop
            "idx": torch.zeros((), dtype=torch.int64),  # ring write index
        }

    def collect_params(self):
        return {}

    def _weights_tensor(self, device) -> torch.Tensor:
        w = self._weights_on.get(device)
        if w is None:
            w = torch.from_numpy(self._weights).to(device)
            self._weights_on[device] = w
        return w

    def kernel(self, params, state, inputs, in_mask, info):
        frames = inputs.shape[-1]
        hop = self.hop_frames
        # K-weighting
        sz, hz = state["shelf_z"], state["hp_z"]
        y, (z1, z2) = biquad_cascade(
            inputs, ((sz[..., 0], sz[..., 1]), (hz[..., 0], hz[..., 1])),
            (self._shelf, self._hp))

        # the weighted, channel-summed instantaneous power [..., F]
        w = self._weights_tensor(inputs.device)
        power = (w[:, None] * y * y).sum(dim=-2)

        # sample-exact gating hops: sample k falls in hop (pos + k) // hop,
        # relative to the write index.  Slots entered for the first time
        # this block are cleared first (they hold data from ring_len hops
        # ago), and so is the slot the write head lands on after it
        ring, counts = state["ring"], state["counts"]
        pos, idx = state["pos"], state["idx"]
        ring_len = ring.shape[-1]
        device = inputs.device
        total = pos + frames
        hops_advanced = total // hop
        slots = torch.arange(ring_len, dtype=torch.int64, device=device)
        fresh = (slots - idx[..., None] - 1) % ring_len < hops_advanced[..., None]
        ring = ring.masked_fill(fresh, 0.0)
        counts = counts.masked_fill(fresh, 0)

        hop_of = (pos[..., None] + torch.arange(frames, dtype=torch.int64,
                                                device=device)) // hop
        for r in range((hop - 1 + frames - 1) // hop + 1):
            in_hop = hop_of == r
            hit = slots == ((idx + r) % ring_len)[..., None]
            energy = torch.where(in_hop, power, 0.0).sum(dim=-1)
            ring = torch.where(hit, ring + energy[..., None], ring)
            counts = torch.where(hit, counts + in_hop.sum(dim=-1)[..., None], counts)

        if self.num_outputs:
            out, out_mask = inputs, in_mask
        else:
            lead = inputs.shape[:-2]
            out = inputs.new_zeros(lead + (0, frames))
            out_mask = in_mask.new_zeros(lead + (0,))
        return (
            out,
            {
                "shelf_z": torch.stack(z1, dim=-1),
                "hp_z": torch.stack(z2, dim=-1),
                "ring": ring,
                "counts": counts,
                "pos": total % hop,
                "idx": (idx + hops_advanced) % ring_len,
            },
            out_mask,
        )


def _window_lufs(ring, counts, idx, blocks):
    ring = np.asarray(ring, np.float64)
    counts = np.asarray(counts, np.float64)
    n = ring.shape[0]
    take = [(int(idx) - d) % n for d in range(blocks)]
    e, c = ring[take].sum(), counts[take].sum()
    if c < 1:
        return -np.inf
    return lufs_from_mean_square(e / c)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class LoudnessMeterNode(AudioNode):
    debug_name = "loudness_meter"

    def __init__(self, channel_weights=None):
        """``channel_weights``: optional per-input BS.1770 weights (e.g.
        ``[1, 1, 1, 1, 1.41, 1.41]``; the standard omits the LFE: wire it
        past the meter or weigh it 0.0).  ``None`` weighs every channel
        1.0."""
        self._channel_weights = (
            None if channel_weights is None else list(channel_weights)
        )

    def info(self) -> AudioNodeInfo:
        return AudioNodeInfo(1, MAX_PORTS, 0, MAX_PORTS)

    def activate(self, sample_rate, max_block_frames, num_inputs, num_outputs):
        if num_outputs not in (0, num_inputs):
            raise NodeActivationError(
                "LoudnessMeterNode passes audio through: outputs must be 0 "
                f"or equal inputs ({num_inputs}); got {num_outputs}"
            )
        return LoudnessMeterProcessor(
            self, sample_rate, max_block_frames, num_inputs, num_outputs
        )

    @staticmethod
    def read(meter_state) -> dict:
        """One meter's state (tensors or arrays, e.g. ``FirewheelCtx.
        node_state``) → momentary (400 ms) and short-term (3 s) loudness in
        LUFS, and the newest complete 100 ms gating block for
        :class:`IntegratedLoudness`."""
        idx = int(_host(meter_state["idx"]))
        ring, counts = _host(meter_state["ring"]), _host(meter_state["counts"])
        # the idx slot is the hop in progress; completed hops end at idx-1
        return {
            "momentary_lufs": _window_lufs(ring, counts, idx - 1, _MOMENTARY_BLOCKS),
            "short_term_lufs": _window_lufs(ring, counts, idx - 1, _SHORT_TERM_BLOCKS),
            "gating_block_lufs": _window_lufs(ring, counts, idx - 1, _MOMENTARY_BLOCKS),
        }


class IntegratedLoudness:
    """Host-side R128 integrated loudness with the two-stage gate.  Feed it
    one ``gating_block_lufs`` reading per 100 ms (from
    :meth:`LoudnessMeterNode.read`); :meth:`value` applies the −70 LUFS
    absolute and −10 LU relative gates."""

    def __init__(self):
        self._blocks: list[float] = []

    def push(self, gating_block_lufs: float):
        if np.isfinite(gating_block_lufs):
            self._blocks.append(float(gating_block_lufs))

    def value(self) -> float:
        if not self._blocks:
            return -np.inf
        lk = np.asarray(self._blocks)
        power = 10.0 ** ((lk + 0.691) / 10.0)
        mask = lk > -70.0
        if not mask.any():
            return -np.inf
        ungated = -0.691 + 10.0 * np.log10(power[mask].mean())
        mask &= lk > ungated - 10.0
        if not mask.any():
            return -np.inf
        return float(-0.691 + 10.0 * np.log10(power[mask].mean()))
