"""Granular sampler: independent time-stretch and pitch-shift playback.

PyTorch port of ``firewheel_tpu/nodes/granular.py``.  Tempo without pitch
(stretch a music bed, keep the key) and pitch without tempo (a granular
transpose of a clip the node owns, with zero latency and an exact identity
at neutral settings).

Grains start every ``P = L/overlap`` output frames, so a block of ``F``
frames overlaps a fixed set of ``G = overlap + S`` grains: the ``overlap``
still-ringing ones (an anchor ring in the node's state) and the ``S``
spawned inside the block.  Their ages are a ``[G, F]`` grid; playback is
one gather of ``anchor + age·pitch`` taps, a periodic-Hann window over the
age, and a sum over the grains.  With ``align`` each spawn's anchor moves
by a bounded lag onto the previous grain's phase-continuation point: the
lag with the largest normalized cross-correlation, ties to the first in
the order ``0, −1, +1, −2, +2, …`` (SOLA).

The kernel takes any leading batch dimensions, as the port's sampler
does.  torch has no uint32 arithmetic on the CPU, so the uint32 leaves
(the source cursor, the ring's anchors, the slot, the phase, the sequence
numbers and the finish counter) ride as int64 masked to 32 bits; the JAX
package's int32 positions ride as int64 holding the int32 value, wrapped
to 32 bits after each sum (``core.node.wrap_int32``), so a cursor past
2^31 wraps as it does there.  The lag search gathers only the ``[ch, 2D+C]`` window of
the clip that its ``2D+1`` candidates cover and takes the candidates as
``unfold`` views of it, where the JAX package averages the whole clip's
channels every block; each element's arithmetic is the same.  The spawn
anchors and the position sum are fused multiply-adds where XLA contracts
them on the CPU, so that the anchors (whose ``floor`` picks a sample) are
the JAX package's bit for bit.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.node import (
    gate,
    AudioNode,
    AudioNodeInfo,
    NodeProcessor,
    MAX_PORTS,
    UINT32_MASK,
    wrap_int32,
)
from ..core.sample_resource import SampleResource
from ..core.smoother import (
    SmootherConfig,
    smoother_coeffs,
    smoother_init,
    smoother_set_and_process,
)
from ..core.units import percent_volume_to_raw_gain
from ..ops.seq_iir import _fma
from .sampler import _take

__all__ = ["GranularSamplerNode", "GranularSamplerProcessor"]

_MUTE_F32 = float(np.float32(0.00001))


def _u32(x) -> int:
    return min(max(int(x), 0), 0xFFFFFFFF)


class GranularSamplerNode(AudioNode):
    debug_name = "granular_sampler"

    def __init__(
        self,
        percent_volume: float = 100.0,
        grain_frames: int = 2048,
        overlap: int = 4,
        align: bool = True,
    ):
        """``grain_frames``: grain length L in output frames.
        ``overlap``: simultaneous grains (hop = L/overlap); L must divide
        by it, and the stream's ``max_block_frames`` must be at most
        ``(overlap-1)·hop`` (checked at activate), so that at most one
        grain spawns per ring slot a block.  ``align``: SOLA grain
        alignment."""
        if overlap < 2:
            raise ValueError(f"overlap must be >= 2, got {overlap}")
        if grain_frames % overlap != 0:
            raise ValueError(
                f"grain_frames ({grain_frames}) must be a multiple of "
                f"overlap ({overlap})")
        self.grain_frames = int(grain_frames)
        self.overlap = int(overlap)
        self.align = bool(align)
        self._percent_volume = max(float(percent_volume), 0.0)
        self._raw_gain = float(
            percent_volume_to_raw_gain(np.float32(percent_volume))
        )
        self._playing = False
        self._tempo = 1.0
        self._pitch_rate = 1.0
        self._sample: Optional[SampleResource] = None
        self._seek_seq = 0
        self._seek_secs = 0.0
        self._play_seq = 0
        self._sample_rate = 48000

    # -- control API ---------------------------------------------------------
    def set_sample(self, sample: SampleResource, stop_playback: bool = True):
        self._sample = sample
        if stop_playback:
            self._seek_seq += 1
            self._seek_secs = 0.0
            self._playing = False

    def play(self):
        """Start playback (a message: re-playing a finished voice
        re-triggers from the current seek position)."""
        self._playing = True
        self._play_seq += 1

    def pause(self):
        self._playing = False

    def stop(self):
        """Stop and rewind.  No-op while not playing (pause() then
        stop() keeps the paused playhead, like the sampler)."""
        if not self._playing:
            return
        self._playing = False
        self._seek_seq += 1
        self._seek_secs = 0.0

    def set_playhead(self, playhead_secs: float):
        """Seek in CLIP seconds (grain machinery restarts there)."""
        self._seek_seq += 1
        self._seek_secs = float(playhead_secs)

    def set_tempo(self, tempo: float):
        """Playback speed WITHOUT pitch change: 1.0 native, 0.5 half
        speed (twice as long), 2.0 double."""
        self._tempo = max(float(tempo), 0.0)

    def set_pitch_semitones(self, semitones: float):
        """Transpose WITHOUT tempo change (±24 st useful range; larger
        shifts granulate audibly)."""
        self._pitch_rate = float(2.0 ** (float(semitones) / 12.0))

    def is_playing(self) -> bool:
        return self._playing

    def percent_volume(self) -> float:
        return self._percent_volume

    def set_percent_volume(self, percent_volume: float):
        self._raw_gain = float(
            percent_volume_to_raw_gain(np.float32(percent_volume))
        )
        self._percent_volume = max(float(percent_volume), 0.0)

    def raw_gain(self) -> float:
        return self._raw_gain

    # -- node plumbing ---------------------------------------------------------
    def info(self) -> AudioNodeInfo:
        return AudioNodeInfo(
            num_min_supported_outputs=1,
            num_max_supported_outputs=MAX_PORTS,
        )

    def activate(self, sample_rate, max_block_frames, num_inputs, num_outputs):
        self._sample_rate = int(sample_rate)
        hop = self.grain_frames // self.overlap
        if int(max_block_frames) > (self.overlap - 1) * hop:
            raise ValueError(
                f"GranularSamplerNode(grain_frames={self.grain_frames}, "
                f"overlap={self.overlap}) needs max_block_frames <= "
                f"{(self.overlap - 1) * hop}, got {max_block_frames} — "
                "use a longer grain or a smaller block size")
        return GranularSamplerProcessor(
            self, sample_rate, max_block_frames, num_inputs, num_outputs
        )


class GranularSamplerProcessor(NodeProcessor):
    supports_megakernel = False  # data-dependent playback gathers

    def __init__(self, node, sample_rate, max_block_frames,
                 num_inputs, num_outputs):
        super().__init__(sample_rate, max_block_frames,
                         num_inputs, num_outputs)
        self._node = node
        self._coeffs = smoother_coeffs(sample_rate, SmootherConfig())
        self._eps = SmootherConfig().settle_epsilon
        self._sample_cache = None
        self._sample_cache_src = None

    def init_state(self):
        A = self._node.overlap
        L = self._node.grain_frames
        u32 = lambda shape=(): torch.zeros(shape, dtype=torch.int64)  # noqa: E731
        return {
            "gain": smoother_init(np.float32(self._node.raw_gain())),
            # source cursor (fixed point, like the sampler's playhead)
            "src_int": u32(),
            "src_frac": torch.zeros((), dtype=torch.float32),
            # grain ring: age (output frames; >= L means dead) and source
            # anchor per slot
            "ages": torch.full((A,), L, dtype=torch.int32),
            "ring_int": u32((A,)),
            "ring_frac": torch.zeros((A,), dtype=torch.float32),
            "slot": u32(),  # next spawn's ring slot
            "phase": u32(),  # frames since last spawn
            "ended": torch.zeros((), dtype=torch.bool),
            "seek_seq": u32(),
            "play_seq": u32(),
            "finish_count": u32(),
        }

    def event_counters(self):
        """``finished``: the one-shot's grain tail fully rang out."""
        return {"finished": "finish_count"}

    def collect_params(self, blocks=1, start_sample=None, frames=None,
                       consume=True):
        node = self._node
        if node._sample is not None:
            if self._sample_cache_src is not node._sample:
                self._sample_cache = torch.as_tensor(node._sample.data)
                self._sample_cache_src = node._sample
            data = self._sample_cache
            has_sample = True
        else:
            data = torch.zeros((1, 1), dtype=torch.float32)
            has_sample = False
        sr = self.sample_rate
        clip_sr = (
            node._sample.sample_rate
            if has_sample and node._sample.sample_rate
            else sr
        )
        # clip-rate conversion rides both cursors: a 44.1 kHz clip at
        # tempo 1 / pitch 0 plays at its speed and pitch in a 48 kHz stream
        scale = clip_sr / sr
        return {
            "raw_gain": np.float32(node.raw_gain()),
            "playing": np.asarray(node._playing and has_sample, bool),
            "tempo": np.float32(node._tempo * scale),
            "pitch": np.float32(node._pitch_rate * scale),
            "seek_seq": np.uint32(node._seek_seq),
            "seek_pos": np.uint32(_u32(round(node._seek_secs * clip_sr))),
            "play_seq": np.uint32(node._play_seq & 0xFFFFFFFF),
            "sample": data,
        }

    def _sola(self, sample, sb, rel_at_t, spawned, state, pitch, scores=None):
        """Each spawn's anchor relative to ``sb`` after the lag search:
        ``f32[..., S]``.  With a list ``scores``, appends each spawn's
        ``(use bool[...], scores f32[..., 2D+1])``: whether its lag moves
        the anchor, and the normalized correlations in candidate order."""
        node = self._node
        L, A = node.grain_frames, node.overlap
        P = L // A
        S = rel_at_t.shape[-1]
        n = sample.shape[-1]
        dev = sample.device
        D = min(P // 2, 96)  # lag search radius (source frames)
        C = min(L // 2, 256)  # correlation window
        lag_order = np.zeros(2 * D + 1, np.int64)
        lag_order[1::2] = -np.arange(1, D + 1)
        lag_order[2::2] = np.arange(1, D + 1)
        # the scores come in lag order -D..D; this reorders them as the
        # candidates are ordered, so argmax breaks ties the same way
        by_order = torch.as_tensor(lag_order + D, device=dev)
        lags = torch.as_tensor(lag_order, dtype=torch.float32, device=dev)
        ci = torch.arange(C, dtype=torch.int64, device=dev)
        wi = torch.arange(2 * D + C, dtype=torch.int64, device=dev)
        ch = sample.shape[-2]
        ch_f = torch.tensor(float(ch), dtype=torch.float32, device=dev)

        def mono_at(idx):
            # the channel mean at clip indices ``idx``, summed in channel
            # order, divided by a tensor (the card divides by a Python
            # number as a product with its reciprocal)
            taps = _take(sample, idx.clamp(0, n - 1))  # [..., ch, *I]
            acc = taps[..., 0, :]
            for c in range(1, ch):
                acc = acc + taps[..., c, :]
            return acc / ch_f

        prev_slot = (state["slot"] + (A - 1)) % A
        pick = lambda t: t.gather(-1, prev_slot[..., None])[..., 0]  # noqa: E731
        prev_base = wrap_int32(pick(state["ring_int"]))
        prev_rel = pick(state["ring_frac"])
        prev_alive = pick(state["ages"]) < L
        anchors = []
        for j in range(S):
            naive_rel = rel_at_t[..., j]
            target_rel = _fma(torch.full_like(pitch, float(P)), pitch, prev_rel)
            ti = wrap_int32(prev_base + torch.floor(target_rel).to(torch.int64))
            ni = wrap_int32(sb + torch.floor(naive_rel).to(torch.int64))
            seg_t = mono_at(wrap_int32(ti[..., None] + ci))  # [..., C]
            win = mono_at(wrap_int32(ni[..., None] - D + wi))  # [..., 2D+C]
            cand = win.unfold(-1, C, 1)  # [..., 2D+1, C]: lag r-D in row r
            dots = (cand * seg_t[..., None, :]).sum(-1)
            energy = (cand * cand).sum(-1)
            score = dots * torch.rsqrt(energy + 1e-12)
            ordered = score[..., by_order]
            best = lags[torch.argmax(ordered, dim=-1)]
            spawned_j = spawned[..., j]
            use = prev_alive & spawned_j
            if scores is not None:
                scores.append((use, ordered))
            # clamp the absolute anchor at 0: −sb as f32 is exact whenever
            # the clamp can bind
            anchor = torch.maximum(
                naive_rel + torch.where(use, best, torch.zeros_like(best)),
                (-sb).to(torch.float32),
            )
            anchors.append(anchor)
            a_off = torch.floor(anchor)
            prev_base = torch.where(
                spawned_j, wrap_int32(sb + a_off.to(torch.int64)), prev_base)
            prev_rel = torch.where(spawned_j, anchor - a_off, prev_rel)
            prev_alive = prev_alive | spawned_j
        return torch.stack(anchors, dim=-1)

    def sola_scores(self, params, state, frames: int) -> list:
        """The lag search of the block :meth:`kernel` would render next:
        for each possible spawn, ``(use bool[...], scores f32[..., 2D+1])``
        in the search's candidate order (``[]`` without ``align``).  A
        diagnostic: two devices may round a score apart by an ulp, and
        where the best two lie that close, pick different lags."""
        if not self._node.align:
            return []
        b = self._prelude(params, state, frames)
        scores = []
        self._sola(params["sample"], b["sb"], b["rel_at_t"], b["spawned"],
                   {**state, "ages": b["ages"]}, params["pitch"], scores)
        return scores

    def _prelude(self, params, state, F: int) -> dict:
        """The block's control edges, gain ramp and spawn schedule."""
        node = self._node
        L = node.grain_frames
        P = L // node.overlap
        sample = params["sample"]
        sample_len = sample.shape[-1]
        dev = sample.device
        f32 = torch.float32

        # ---- queued control state (sequence-numbered messages)
        seek_new = params["seek_seq"] != state["seek_seq"]
        trigger = params["play_seq"] != state["play_seq"]
        reset = seek_new | trigger
        src_int = torch.where(seek_new, params["seek_pos"], state["src_int"])
        src_frac = state["src_frac"].masked_fill(seek_new, 0.0)
        # a seek or re-trigger restarts the grain machinery: kill the
        # ring, spawn fresh at the block start (phase 0: a spawn is due)
        ages = state["ages"].masked_fill(reset[..., None], L)
        phase = state["phase"].masked_fill(reset, 0)
        ended = state["ended"] & ~reset
        playing = params["playing"] & ~ended

        # ---- gain smoother + mute (a muted voice freezes instead of
        # consuming its clip inaudibly)
        snap = smoother_init(params["raw_gain"])
        gain_prev = {k: torch.where(seek_new, snap[k], v)
                     for k, v in state["gain"].items()}
        ramp, gain_processed, smoothing = smoother_set_and_process(
            gain_prev, params["raw_gain"], F, self._coeffs, self._eps
        )
        muted = ~smoothing & (ramp[..., 0] < _MUTE_F32)
        tail_live = (ages < L).any(-1)
        advancing = (playing | tail_live) & ~muted & ~ended
        gain_state = {k: torch.where(advancing, gain_processed[k], gain_prev[k])
                      for k in gain_prev}

        tempo = params["tempo"]
        # positions are (int32 base, small f32 offset) pairs, never an
        # absolute f32: past 2^24 frames an absolute f32 position would
        # step by two samples
        sb = wrap_int32(src_int)

        # ---- spawn schedule: new grains where (phase + k) ≡ 0 (mod P)
        S = max(F // P + 1 if F % P else F // P, 1)
        t0 = torch.where(phase == 0, torch.zeros_like(phase), P - phase)
        t_j = t0[..., None] + P * torch.arange(S, dtype=torch.int64, device=dev)
        # spawn anchors relative to sb
        rel_at_t = _fma(t_j.to(f32), tempo[..., None], src_frac[..., None])
        room = wrap_int32(sample_len - sb).to(f32)
        spawned = (
            (t_j < F)
            & (playing & ~muted)[..., None]
            & (rel_at_t < room[..., None])
        )  # [..., S]
        return {
            "src_int": src_int, "src_frac": src_frac,
            "ages": ages, "phase": phase, "ended": ended, "playing": playing,
            "ramp": ramp, "gain_state": gain_state, "advancing": advancing,
            "sb": sb, "t_j": t_j, "rel_at_t": rel_at_t, "spawned": spawned,
        }

    def kernel(self, params, state, inputs, in_mask, info):
        F = inputs.shape[-1]
        node = self._node
        L = node.grain_frames
        A = node.overlap
        P = L // A
        n_out = self.num_outputs
        sample = params["sample"]
        sample_channels, sample_len = sample.shape[-2:]
        dev = sample.device
        f32 = torch.float32
        b = self._prelude(params, state, F)
        src_int, src_frac, ages, phase = b["src_int"], b["src_frac"], b["ages"], b["phase"]
        ended, playing, ramp = b["ended"], b["playing"], b["ramp"]
        advancing, sb, t_j = b["advancing"], b["sb"], b["t_j"]
        rel_at_t, spawned = b["rel_at_t"], b["spawned"]
        pitch = params["pitch"]
        tempo = params["tempo"]
        k = torch.arange(F, dtype=torch.int64, device=dev)

        # ---- SOLA: nudge each spawn's anchor by a bounded lag onto the
        # previous grain's phase-continuation point.  The spawn gate and
        # the tempo cursor stay on the unaligned anchor.
        if node.align:
            spawn_rel = self._sola(sample, sb, rel_at_t, spawned,
                                   {**state, "ages": ages}, pitch)
        else:
            spawn_rel = rel_at_t

        # ---- grain grid: ring grains (ages advance with k) + spawns
        ring_age = ages.to(torch.int64)[..., None] + k  # [..., A, F]
        spawn_age = k - t_j[..., None]  # [..., S, F]
        age = torch.cat([ring_age, spawn_age], dim=-2)  # [..., G, F]
        # spawns take the (int base, frac in [0, 1)) decomposition their
        # ring slot will carry, so a grain's position arithmetic is the
        # same in its spawn block and every later one
        spawn_off = torch.floor(spawn_rel)
        spawn_base = wrap_int32(sb[..., None] + spawn_off.to(torch.int64))
        spawn_frac = spawn_rel - spawn_off
        base = torch.cat([wrap_int32(state["ring_int"]), spawn_base], dim=-1)  # [..., G]
        rel = torch.cat([state["ring_frac"], spawn_frac], dim=-1)
        grain_on = torch.cat([torch.ones_like(spawned[..., :1]).expand(
            spawned.shape[:-1] + (A,)), spawned], dim=-1)
        live = grain_on[..., None] & (age >= 0) & (age < L)

        agef = age.to(f32)
        # periodic Hann over grain age: COLA with constant A/2 at hop P
        w = 0.5 * (1.0 - torch.cos(agef * float(np.float32(2.0 * np.pi / L))))
        pos_rel = _fma(agef, pitch[..., None, None], rel[..., None])  # [..., G, F]
        off = torch.floor(pos_rel)
        frac = pos_rel - off
        idx = wrap_int32(base[..., None] + off.to(torch.int64))
        in_range = (idx >= 0) & (idx < sample_len)
        idx0 = idx.clamp(0, sample_len - 1)
        idx1 = wrap_int32(idx + 1).clamp(0, sample_len - 1)
        weight = torch.where(live & in_range, w, torch.zeros_like(w))
        # [..., ch, G, F]
        s0, s1 = (_take(sample, i.flatten(-2)).unflatten(-1, i.shape[-2:])
                  for i in (idx0, idx1))
        taps = s0 + (s1 - s0) * frac[..., None, :, :]
        mix = (taps * weight[..., None, :, :]).sum(-2) * float(np.float32(2.0 / A))

        # ---- end-of-block state: age the ring, install spawns in their
        # slots (at most one a slot a block), advance the cursors
        new_ages = torch.clamp_max(ages + F, L)
        new_ring_int = state["ring_int"]
        new_ring_frac = state["ring_frac"]
        arange_a = torch.arange(A, dtype=torch.int64, device=dev)
        slot = state["slot"]
        for j in range(t_j.shape[-1]):
            s_j = (slot + j) % A
            hit = (arange_a == s_j[..., None]) & spawned[..., j, None]
            new_ages = torch.where(hit, (F - t_j[..., j, None]).to(torch.int32),
                                   new_ages)
            a_off = torch.floor(spawn_rel[..., j])
            a_int = wrap_int32(sb + a_off.to(torch.int64))  # exact absolute anchor
            new_ring_int = torch.where(hit, a_int.clamp_min(0)[..., None],
                                       new_ring_int)
            new_ring_frac = torch.where(hit, (spawn_rel[..., j] - a_off)[..., None],
                                        new_ring_frac)
        n_spawned = spawned.sum(-1)
        new_slot = (slot + n_spawned) % A
        # phase counts from the last spawn opportunity (spawned or not), so
        # the grid stays locked to the output clock
        new_phase = (phase + F) % P

        adv = _fma(torch.full_like(tempo, float(F)), tempo, src_frac)
        adv_int = torch.floor(adv)
        new_src_int = (src_int + adv_int.to(torch.int64)) & UINT32_MASK
        new_src_frac = adv - adv_int

        # one-shot finish: the cursor passed the clip AND the grain tail
        # has rung out (an integer compare)
        src_past = new_src_int >= sample_len
        finished = playing & src_past & (new_ages >= L).all(-1)
        fire = advancing & finished

        def frz(new, old):
            return torch.where(
                advancing.reshape(advancing.shape + (1,) * (new.ndim - advancing.ndim)),
                new, old)

        # a paused voice rings its grain tail out, but the source cursor
        # freezes with the pause
        move_src = advancing & playing

        silent = ~advancing
        gained = mix * ramp[..., None, :]
        zeros = torch.zeros_like(gained[..., 0, :])
        rows, mask_rows = [], []
        for ch in range(n_out):
            if ch < sample_channels:
                rows.append(gained[..., ch, :])
                mask_rows.append(silent)
            elif n_out == 2 and sample_channels == 1:
                rows.append(gained[..., 0, :])  # mono → stereo duplicate
                mask_rows.append(silent)
            else:
                rows.append(zeros)
                mask_rows.append(torch.ones_like(silent))
        out = gate(torch.stack(rows, dim=-2), silent)

        new_state = {
            "gain": b["gain_state"],
            "src_int": torch.where(move_src, new_src_int, src_int),
            "src_frac": torch.where(move_src, new_src_frac, src_frac),
            "ages": frz(new_ages, ages),
            "ring_int": frz(new_ring_int, state["ring_int"]),
            "ring_frac": frz(new_ring_frac, state["ring_frac"]),
            "slot": frz(new_slot, slot),
            "phase": frz(new_phase, phase),
            "ended": ended | fire,
            "seek_seq": params["seek_seq"],
            "play_seq": params["play_seq"],
            "finish_count": (state["finish_count"] + fire.to(torch.int64))
            & UINT32_MASK,
        }
        return out, new_state, torch.stack(mask_rows, dim=-1)
