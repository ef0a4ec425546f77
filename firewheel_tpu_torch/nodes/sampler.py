"""Sampler node: PCM sample playback with loop ranges, gain smoothing and
resampling.

PyTorch port of ``firewheel_tpu/nodes/sampler.py`` (reference:
``basic_nodes/sampler.rs``).  Playback is a gather: the block's sample
positions are ``playhead + frac + k·rate`` (an integer playhead and an f32
fractional carry, so nothing drifts across blocks); a loop wraps positions
with a modulo, a one-shot masks positions past the end.  Commands
(play/pause/stop/seek/loop range) are sequence-numbered params: the kernel
applies a seek or a loop change once, when the number differs from the one
in its state.

torch has no uint32 arithmetic on the CPU, so every uint32 leaf (the
playhead, the sequence numbers, the event counters, the loop bounds) rides
as int64 holding the same value, and every sum or difference that wraps in
uint32 is masked back to 32 bits.  ``jax.lax.rem``/``div`` on those values
become ``%``/``//`` on non-negative operands, and ``torch.fmod`` (which
truncates toward zero, as ``lax.rem`` does) where an operand may be
negative.  The two position sums whose ``floor`` picks a sample are fused
multiply-adds, as XLA contracts them on the CPU: one ulp at an integer
boundary would move a tap by a whole sample.

Commands given ``at_sample=`` (play, pause, stop, seek) ride per-block
param timelines (``executor.PerBlock``): with a ``start_sample``,
``collect_params`` folds the commands due in the dispatch into five
timelines (playing, seek sequence and position, play sequence, and the
sub-block start offset of a scheduled play), so each lands on its block,
and a play on its exact sample.
"""

from __future__ import annotations

import dataclasses
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

__all__ = ["LoopRange", "SamplerNode", "SamplerProcessor"]

_MUTE_F32 = float(np.float32(0.00001))


def _u32(x) -> int:
    """Clamp a host integer into the uint32 range."""
    return min(max(int(x), 0), 0xFFFFFFFF)


@dataclasses.dataclass(frozen=True)
class LoopRange:
    """``Full`` or a seconds range (sampler.rs:16-19)."""

    start_secs: float = 0.0
    end_secs: Optional[float] = None  # None in full-range mode
    full: bool = False

    FULL = None  # assigned below

    @staticmethod
    def range_secs(start: float, end: float) -> "LoopRange":
        return LoopRange(start_secs=start, end_secs=end, full=False)


LoopRange.FULL = LoopRange(full=True)


class SamplerNode(AudioNode):
    debug_name = "sampler"

    def __init__(
        self,
        percent_volume: float = 100.0,
        poolable: bool = False,
        quality: str = "linear",
    ):
        """``poolable``: let the executor pool samplers (the caller promises
        every pooled sampler keeps a clip of one shape).  ``quality``: the
        resampling interpolator, ``"linear"`` (2 taps, bit-exact at rate
        1.0), ``"cubic"`` (4-tap Catmull-Rom) or ``"sinc8"`` (8-tap
        Lanczos-4); loop-mode taps wrap inside the loop, one-shot taps clamp
        to the clip."""
        assert quality in ("linear", "cubic", "sinc8"), quality
        self.quality = quality
        self.poolable = bool(poolable)
        self._percent_volume = max(float(percent_volume), 0.0)
        self._raw_gain = float(
            percent_volume_to_raw_gain(np.float32(percent_volume))
        )
        self._playing = False
        self._rate = 1.0
        self._attack_secs = 0.0
        self._release_secs = 0.0
        self._sample: Optional[SampleResource] = None
        self._loop: Optional[LoopRange] = None
        # control-plane sequence numbers; seeks are kept in seconds (or as a
        # rewind to the loop start) and converted with the stream rate
        self._seek_seq = 0
        self._seek: tuple = ("secs", 0.0)
        self._loop_seq = 0
        # play() is a message: each call bumps this, and the kernel clears
        # the one-shot `ended` latch on the edge
        self._play_seq = 0
        self._sample_rate = 48000  # set at activate
        #: (at_sample, kind, payload) commands awaiting their block
        self._scheduled: list[tuple] = []

    # -- control API (sampler.rs:67-181) --------------------------------------
    def set_sample(self, sample: SampleResource, stop_playback: bool = True):
        self._sample = sample
        if stop_playback:
            self._seek_seq += 1
            self._seek = ("loop_start",)
            self._playing = False

    def _schedule(self, at_sample: int, kind: str, payload=None):
        self._scheduled.append((int(at_sample), kind, payload))
        self._scheduled.sort(key=lambda e: e[0])

    def play(self, at_sample: int | None = None):
        """Start playback; with ``at_sample``, on that exact stream sample
        (a retrigger of a playing voice cuts it to silence for the trigger
        block's samples before it)."""
        if at_sample is None:
            self._playing = True
            self._play_seq += 1
        else:
            self._schedule(at_sample, "play")

    def pause(self, at_sample: int | None = None):
        if at_sample is None:
            self._playing = False
        else:
            self._schedule(at_sample, "pause")

    def stop(self, at_sample: int | None = None):
        """Stop playback and rewind to the loop start; a no-op while not
        playing (sampler.rs:118-119)."""
        if at_sample is not None:
            self._schedule(at_sample, "stop")
            return
        if not self._playing:
            return
        self._playing = False
        self._seek_seq += 1
        self._seek = ("loop_start",)

    def set_playhead(self, playhead_secs: float, at_sample: int | None = None):
        if at_sample is None:
            self._seek_seq += 1
            self._seek = ("secs", float(playhead_secs))
        else:
            self._schedule(at_sample, "seek", float(playhead_secs))

    def cancel_scheduled(self) -> None:
        """Drop every ``at_sample=`` command not yet consumed by a dispatch."""
        self._scheduled.clear()

    def set_loop_range(self, loop_range: Optional[LoopRange]):
        self._loop = loop_range
        self._loop_seq += 1

    def set_playback_rate(self, rate: float):
        """Resampling / doppler pitch; 1.0 = native speed."""
        self._rate = max(float(rate), 0.0)

    def set_envelope(self, attack_secs: float, release_secs: float):
        """Gain envelope / declick fade times (0 = instant)."""
        self._attack_secs = max(float(attack_secs), 0.0)
        self._release_secs = max(float(release_secs), 0.0)

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

    def _loop_params(self, sample_rate: float):
        """(loop_on, start_frame, end_frame) honoring full-range mode
        (sampler.rs:240-277)."""
        n = self._sample.len_frames if self._sample is not None else 0
        if self._loop is None:
            return False, 0, n
        if self._loop.full:
            return True, 0, n
        return (
            True,
            _u32(round(self._loop.start_secs * sample_rate)),
            _u32(round(self._loop.end_secs * sample_rate)),
        )

    def _seek_frame(self, sample_rate: float) -> int:
        """The pending seek target as a frame at ``sample_rate``."""
        if self._seek[0] == "loop_start":
            return self._loop_params(sample_rate)[1]
        return _u32(round(self._seek[1] * sample_rate))

    # -- node plumbing --------------------------------------------------------
    def info(self) -> AudioNodeInfo:
        return AudioNodeInfo(
            num_min_supported_outputs=1,
            num_max_supported_outputs=MAX_PORTS,
            updates=True,
        )

    def activate(self, sample_rate, max_block_frames, num_inputs, num_outputs):
        self._sample_rate = int(sample_rate)
        return SamplerProcessor(
            self, sample_rate, max_block_frames, num_inputs, num_outputs
        )


def _take(sample: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``sample[..., :, idx]`` per instance: ``sample [..., C, L]``, ``idx
    [..., F]`` → ``[..., C, F]``."""
    return torch.gather(sample, -1, idx[..., None, :].expand(
        *sample.shape[:-1], idx.shape[-1]))


class SamplerProcessor(NodeProcessor):
    supports_megakernel = False  # data-dependent playback gathers

    def __init__(self, node: SamplerNode, sample_rate, max_block_frames, num_inputs, num_outputs):
        super().__init__(sample_rate, max_block_frames, num_inputs, num_outputs)
        self._node = node
        self._coeffs = smoother_coeffs(sample_rate, SmootherConfig())
        self._eps = SmootherConfig().settle_epsilon
        self._sample_cache = None
        self._sample_cache_src = None

    def init_state(self):
        u32 = lambda: torch.zeros((), dtype=torch.int64)  # noqa: E731
        return {
            "gain": smoother_init(np.float32(self._node.raw_gain())),
            "playhead": u32(),
            "frac": torch.zeros((), dtype=torch.float32),
            "ended": torch.zeros((), dtype=torch.bool),
            "prev_playing": torch.zeros((), dtype=torch.bool),
            "seek_seq": u32(),
            "loop_seq": u32(),
            "play_seq": u32(),
            "env": torch.zeros((), dtype=torch.float32),
            # event counters: one-shot completions and loop-join crossings
            "finish_count": u32(),
            "loop_count": u32(),
        }

    def event_counters(self):
        """``finished``: a one-shot reached its end; ``loop``: playback
        crossed the loop join (once per complete traversal)."""
        return {"finished": "finish_count", "loop": "loop_count"}

    def group_key(self):
        node = self._node
        if not node.poolable:
            return None
        shape = (
            tuple(np.shape(node._sample.data)) if node._sample is not None
            else (1, 1)
        )
        return (shape, node.quality)

    #: scheduled play/pause/stop/seek ride per-block param timelines
    collect_timeline = True

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
        # clip-native rate: seconds address clip time, and playback scales
        # so a 44.1 kHz clip plays at its pitch in a 48 kHz stream
        clip_sr = (
            node._sample.sample_rate
            if has_sample and node._sample.sample_rate
            else sr
        )
        loop_on, loop_start, loop_end = node._loop_params(clip_sr)
        # per-sample envelope steps; 0-second times jump in one sample
        attack_step = (
            1.0 / (node._attack_secs * sr) if node._attack_secs > 0 else 2.0
        )
        release_step = (
            1.0 / (node._release_secs * sr) if node._release_secs > 0 else 2.0
        )
        out = {
            "attack_step": np.float32(attack_step),
            "release_step": np.float32(release_step),
            "raw_gain": np.float32(node.raw_gain()),
            "playing": np.asarray(node._playing and has_sample, bool),
            "rate": np.float32(node._rate * clip_sr / sr),
            "seek_seq": np.uint32(node._seek_seq),
            "seek_pos": np.uint32(node._seek_frame(clip_sr)),
            "play_seq": np.uint32(node._play_seq & 0xFFFFFFFF),
            "start_offset": np.uint32(0),
            "loop_on": np.asarray(loop_on, bool),
            "loop_seq": np.uint32(node._loop_seq & 0xFFFFFFFF),
            "loop_start": np.uint32(_u32(loop_start)),
            "loop_end": np.uint32(_u32(loop_end)),
            "sample": data,
        }
        if start_sample is None:
            # batched paths: immediate values; scheduled commands stay queued
            return out

        # -- per-block command timelines --------------------------------------
        from ..executor import PerBlock

        k = max(1, int(blocks))
        f = int(frames or self.max_block_frames)
        start = int(start_sample)
        playing_tl = np.full(k, bool(node._playing and has_sample))
        seq_tl = np.full(k, np.uint32(node._seek_seq), np.uint32)
        pos_tl = np.full(k, np.uint32(node._seek_frame(clip_sr)), np.uint32)
        play_seq_tl = np.full(k, np.uint32(node._play_seq & 0xFFFFFFFF), np.uint32)
        # a scheduled play's offset into its block: the trigger is sample
        # accurate, applied at the trigger block only
        offset_tl = np.zeros(k, np.uint32)
        if consume and node._scheduled:
            end = start + k * f
            cur_playing, cur_seq = node._playing, node._seek_seq
            cur_play_seq, cur_seek = node._play_seq, node._seek
            remaining = []
            for at, kind, payload in node._scheduled:
                if at >= end:
                    remaining.append((at, kind, payload))
                    continue
                b = max(0, (at - start) // f)
                if kind == "play":
                    cur_playing = True
                    cur_play_seq += 1
                    play_seq_tl[b:] = np.uint32(cur_play_seq & 0xFFFFFFFF)
                    offset_tl[b] = np.uint32(min(max(0, at - (start + b * f)), f - 1))
                elif kind == "pause":
                    cur_playing = False
                elif kind == "stop":
                    # as the immediate stop: a no-op while not playing
                    if cur_playing:
                        cur_playing = False
                        cur_seq += 1
                        cur_seek = ("loop_start",)
                        pos_tl[b:] = np.uint32(loop_start)
                elif kind == "seek":
                    cur_seq += 1
                    cur_seek = ("secs", float(payload))
                    pos_tl[b:] = np.uint32(_u32(round(payload * clip_sr)))
                playing_tl[b:] = cur_playing and has_sample
                seq_tl[b:] = np.uint32(cur_seq & 0xFFFFFFFF)
            node._playing, node._seek_seq = cur_playing, cur_seq
            node._play_seq, node._seek = cur_play_seq, cur_seek
            node._scheduled = remaining
        out["playing"] = PerBlock(playing_tl)
        out["seek_seq"] = PerBlock(seq_tl)
        out["seek_pos"] = PerBlock(pos_tl)
        out["play_seq"] = PerBlock(play_seq_tl)
        out["start_offset"] = PerBlock(offset_tl)
        return out

    def resync_from_state(self, state) -> None:
        """Adopt restored device sequence numbers, so the first block after
        a restore sees no spurious seek or trigger edge."""
        node = self._node
        for name in ("seek_seq", "loop_seq", "play_seq"):
            setattr(node, f"_{name}", int(torch.as_tensor(state[name]).max()))

    def kernel(self, params, state, inputs, in_mask, info):
        frames = inputs.shape[-1]
        n_out = self.num_outputs
        sample = params["sample"]
        sample_channels, sample_len = sample.shape[-2:]
        f32 = torch.float32

        # ---- apply queued control state (sampler.rs:331-414)
        playhead = state["playhead"]
        frac = state["frac"]
        seek_new = params["seek_seq"] != state["seek_seq"]
        playhead = torch.where(seek_new, params["seek_pos"], playhead)
        frac = frac.masked_fill(seek_new, 0.0)
        ended = state["ended"] & ~seek_new

        loop_new = params["loop_seq"] != state["loop_seq"]
        in_range = (playhead >= params["loop_start"]) & (
            playhead < params["loop_end"]
        )
        playhead = torch.where(
            loop_new & params["loop_on"] & in_range, params["loop_start"],
            playhead,
        )

        # a rising play edge or a new play() clears the one-shot latch
        rising = params["playing"] & ~state["prev_playing"]
        trigger = params["play_seq"] != state["play_seq"]
        ended = ended & ~(rising | trigger)
        playing = params["playing"] & ~ended

        # ---- gain envelope: a linear ramp toward the playing state
        slope = torch.where(playing, params["attack_step"], -params["release_step"])
        k1 = torch.arange(1, frames + 1, dtype=f32, device=sample.device)
        env_k = torch.clamp(state["env"][..., None] + k1 * slope[..., None],
                            0.0, 1.0)
        active = playing | (env_k[..., 0] > 0.0)

        # ---- gain ramp + mute; a seek snaps the smoother to its target
        snap = smoother_init(params["raw_gain"])
        gain_prev = {k: torch.where(seek_new, snap[k], v)
                     for k, v in state["gain"].items()}
        ramp, gain_processed, smoothing = smoother_set_and_process(
            gain_prev, params["raw_gain"], frames, self._coeffs, self._eps
        )
        gain_state = {k: torch.where(active, gain_processed[k], gain_prev[k])
                      for k in gain_prev}
        muted = ~smoothing & (ramp[..., 0] < _MUTE_F32)

        # ---- playback positions (integer playhead + f32 frac carry)
        start_off = torch.where(
            trigger, params["start_offset"], torch.zeros_like(params["start_offset"])
        ).to(f32)
        rate = params["rate"]
        k = torch.arange(frames, dtype=f32, device=sample.device)
        off = torch.clamp_min(
            _fma(k - start_off[..., None], rate[..., None], frac[..., None]), 0.0
        )
        off_floor = torch.floor(off)
        off_int = off_floor.to(torch.int64)
        interp_w = off - off_floor

        loop_on = params["loop_on"]
        # clamp the loop to the clip and keep it non-empty
        lstart = params["loop_start"].clamp_max(sample_len - 1)
        lend = torch.maximum(params["loop_end"], lstart + 1).clamp_max(sample_len)
        lend = torch.maximum(lend, lstart + 1)
        llen = lend - lstart
        # an out-of-range playhead returns to the loop start
        playhead_eff = torch.where(loop_on & (playhead >= lend), lstart, playhead)

        lo, le, ll, lon = (t[..., None] for t in (lstart, lend, llen, loop_on))
        pos = (playhead_eff[..., None] + off_int) & UINT32_MASK
        # a playhead below the range plays through to the loop end first
        wrapped = lo + (torch.maximum(pos, lo) - lo) % ll
        last = sample_len - 1
        pos_loop = torch.where(pos < le, pos.clamp_max(last), wrapped)
        idx0 = torch.where(lon, pos_loop, pos.clamp_max(last))
        idx1 = (idx0 + 1).clamp_max(last)
        idx1 = torch.where(lon & (idx0 + 1 >= le), lo, idx1)
        # a finished one-shot is silent; so are the samples before a
        # mid-block start
        valid = ((lon | (pos < sample_len)) & ~ended[..., None]
                 & (k >= start_off[..., None]))

        quality = self._node.quality
        t = interp_w[..., None, :]
        if quality == "linear":
            s0 = _take(sample, idx0)
            frames_out = s0 + (_take(sample, idx1) - s0) * t
        else:
            in_loop = lon & (idx0 >= lo)

            def tap_index(d: int):
                t_i = idx0 + d
                wrapped_i = lo + torch.fmod(torch.fmod(t_i - lo, ll) + ll, ll)
                return torch.where(in_loop, wrapped_i, t_i.clamp(0, last))

            if quality == "cubic":
                # Catmull-Rom weights; exact (0, 1, 0, 0) at t == 0.  The
                # fused multiply-adds are the ones XLA makes of JAX's
                # polynomials and of the taps' sum on the CPU
                weights = [
                    _fma(_fma(t, -0.5, 1.0), t, -0.5) * t,
                    _fma(_fma(t, 1.5, -2.5) * t, t, 1.0),
                    _fma(_fma(t, -1.5, 2.0), t, 0.5) * t,
                    _fma(t, 0.5, -0.5) * t * t,
                ]
                x = [_take(sample, tap_index(d)) for d in (-1, 0, 1, 2)]
                frames_out = _fma(x[0], weights[0], x[1] * weights[1])
                frames_out = _fma(x[3], weights[3], _fma(x[2], weights[2], frames_out))
            else:  # sinc8: Lanczos a=4
                taps = tuple(range(-3, 5))
                weights = [torch.sinc(t - d) * torch.sinc((t - d) / 4.0)
                           for d in taps]
                wsum = sum(weights)
                weights = [w / wsum for w in weights]
                frames_out = torch.zeros(
                    sample.shape[:-1] + (frames,), dtype=f32, device=sample.device)
                for d, w in zip(taps, weights):
                    frames_out = frames_out + _take(sample, tap_index(d)) * w
        frames_out = frames_out.masked_fill(~valid[..., None, :], 0.0)

        # ---- advance the carry (minus a mid-block start's masked samples)
        adv = _fma(float(frames) - start_off, rate, frac)
        adv_int = torch.floor(adv)
        new_playhead = (playhead_eff + adv_int.to(torch.int64)) & UINT32_MASK
        new_frac = adv - adv_int
        # loop: fold the playhead back into range, counting the traversals
        np_rel = (new_playhead - lstart) & UINT32_MASK
        wrap = loop_on & (new_playhead >= lend)
        wraps = torch.where(wrap, np_rel // llen, torch.zeros_like(np_rel))
        new_playhead = torch.where(wrap, lstart + np_rel % llen, new_playhead)
        finished = ~loop_on & (new_playhead >= sample_len)
        # a one-shot finish rewinds to 0 and latches ended
        new_playhead = new_playhead.masked_fill(finished, 0)
        new_frac = new_frac.masked_fill(finished, 0.0)

        silent = ~active | muted
        # muted or ended freezes playback (sampler.rs:436-443)
        advancing = active & ~muted & ~ended
        done = advancing & finished
        new_state = {
            "gain": gain_state,
            "playhead": torch.where(advancing, new_playhead, playhead),
            "frac": torch.where(advancing, new_frac, frac),
            "ended": ended | done,
            "prev_playing": params["playing"],
            "seek_seq": params["seek_seq"],
            "loop_seq": params["loop_seq"],
            "play_seq": params["play_seq"],
            "env": env_k[..., frames - 1],
            "finish_count": (state["finish_count"] + done.to(torch.int64))
            & UINT32_MASK,
            "loop_count": (state["loop_count"]
                           + torch.where(advancing, wraps, torch.zeros_like(wraps)))
            & UINT32_MASK,
        }

        # ---- gain, shaped by the envelope; channel layout (sampler.rs:521-558)
        gained = frames_out * (ramp * env_k)[..., None, :]
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
        return out, new_state, torch.stack(mask_rows, dim=-1)
