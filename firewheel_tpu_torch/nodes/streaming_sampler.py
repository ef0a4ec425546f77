"""Streaming sampler: play audio longer than device memory wants resident.

PyTorch port of ``firewheel_tpu/nodes/streaming_sampler.py`` (the
reference's "disk and network streaming" sampler scope).  The device holds
only a sliding window of the clip (``f32[ch, W]``, a param like the
in-memory sampler's clip); the host prefetches ahead of the playhead from a
stream reader, any object with ``num_channels / len_frames / sample_rate /
read(start, n)``:

* :class:`~firewheel_tpu_torch.utils.wav.WavStreamReader` (memory-mapped
  disk streaming), and the other readers of ``core/formats.py``;
* :class:`CallbackStreamReader` (a closure: a network fetch, a decoder, a
  generator).

The host keeps a shadow playhead: the executor passes each dispatch's
block count into ``collect_params(blocks=...)``, the estimate advances by
``blocks × block × rate`` frames, and the window refills (growing once if a
chunked dispatch outspans it) when the lookahead margin shrinks.  The
kernel gathers ``positions − window_start`` and masks samples outside the
window, so a starved window degrades to silence, never garbage.

Each refill reads into a fresh host array, marked read-only, that is never
written again: a pipelined dispatch still in flight keeps reading the
window it was handed.  The JAX package refills one buffer in place and
wraps it with ``jnp.asarray``, which on the CPU aliases the numpy buffer,
so a refill for the next dispatch could rewrite the window under one still
rendering.  The window is a numpy param, so it crosses to the device inside
each dispatch's one staged copy (``processor._Stager``).

The host half (the shadow clock, the per-block transport timelines) is the
JAX package's; the kernel takes any leading batch dimensions, with the
uint32 leaves (playhead, sequence numbers, window start, clip length, start
offset, finish counter) as int64 masked to 32 bits and the position sums as
the fused multiply-adds XLA makes of them on the CPU (as the port's
sampler does).

Playback is sequential (play/pause/stop/seek; no loop ranges: loop a
window-sized clip with the in-memory :class:`SamplerNode` instead).
"""

from __future__ import annotations

from typing import Callable

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
from ..core.smoother import (
    SmootherConfig,
    smoother_coeffs,
    smoother_init,
    smoother_set_and_process,
)
from ..core.units import percent_volume_to_raw_gain
from ..ops.seq_iir import _fma
from .sampler import _take

__all__ = ["CallbackStreamReader", "StreamingSamplerNode"]

_MUTE_F32 = float(np.float32(0.00001))


def _frozen(a: np.ndarray) -> np.ndarray:
    """``a``, read-only from here on (the window contract above)."""
    a.setflags(write=False)
    return a


class CallbackStreamReader:
    """Adapt a ``read(start, n) -> f32[ch, n]`` closure to the stream-reader
    protocol (the "network streaming" hook).

    The closure must tolerate windows extending past ``len_frames`` (return
    zero-padded frames there, like :class:`~firewheel_tpu_torch.utils.wav.
    WavStreamReader` does): the prefetch window is read in fixed-size spans
    and the final span reaches past the clip end.
    """

    def __init__(self, read_fn: Callable, num_channels: int, len_frames: int,
                 sample_rate: "int | None" = None):
        """``sample_rate``: the produced audio's native rate, if known —
        a rated reader auto-converts in non-matching streams (see the
        processor).  ``None`` (default) means "produces at the stream
        rate": frames map 1:1 at playback rate 1.0 whatever the stream
        runs at (the pre-rate-conversion behavior — procedural
        generators usually want this)."""
        self._read = read_fn
        self.num_channels = num_channels
        self.len_frames = len_frames
        self.sample_rate = sample_rate

    def read(self, start_frame: int, num_frames: int) -> np.ndarray:
        out = np.asarray(
            self._read(start_frame, num_frames), np.float32
        ).reshape(self.num_channels, num_frames)
        return out


class StreamingSamplerNode(AudioNode):
    debug_name = "streaming_sampler"

    def __init__(
        self,
        reader=None,
        percent_volume: float = 100.0,
        window_secs: float = 2.0,
    ):
        from ..core.formats import as_stream_reader

        self._reader = as_stream_reader(reader)
        self._percent_volume = max(float(percent_volume), 0.0)
        self._raw_gain = float(
            percent_volume_to_raw_gain(np.float32(percent_volume))
        )
        self._window_secs = float(window_secs)
        self._playing = False
        self._rate = 1.0
        # seeks stored in SECONDS; the processor converts at the real
        # stream rate (seeks issued pre-activation stay correct on non-48k
        # streams — see SamplerNode)
        self._seek_seq = 0
        self._seek_secs = 0.0
        # play() is a MESSAGE (see SamplerNode): the seq edge clears the
        # EOF `ended` latch so a repeat play() replays
        self._play_seq = 0
        self._sample_rate = 48000
        self._max_block_frames = 128  # real value adopted at activate
        #: (at_sample, kind, payload) transport commands awaiting their
        #: exact block (play/pause/stop/seek with ``at_sample=``)
        self._scheduled: list[tuple] = []

    # -- control --------------------------------------------------------------
    def set_reader(self, reader):
        """Swap the stream source (a reader, or a path any registered
        stream format opens); playback restarts from frame 0."""
        from ..core.formats import as_stream_reader

        self._reader = as_stream_reader(reader)
        self.stop()

    def play(self, at_sample: int | None = None):
        """Start playback.  ``at_sample``: absolute stream sample whose
        block should start the deck (rides the per-block param timelines,
        like ``SamplerNode.play(at_sample=...)``) — block-accurate
        transport inside chunked dispatches, the primitive gapless music
        transitions build on (``music.MusicPlayer``)."""
        if at_sample is None:
            self._playing = True
            self._play_seq += 1
        else:
            self._scheduled.append((int(at_sample), "play", None))
            self._scheduled.sort(key=lambda e: e[0])

    def pause(self, at_sample: int | None = None):
        if at_sample is None:
            self._playing = False
        else:
            self._scheduled.append((int(at_sample), "pause", None))
            self._scheduled.sort(key=lambda e: e[0])

    def stop(self, at_sample: int | None = None):
        """Stop and rewind to 0.  An in-chunk rewind on a PLAYING deck can
        leave the rest of that chunk silent (the prefetch window covers
        the pre-rewind span; it refills at the next dispatch) — schedule
        rewinds on stopped decks, or alternate decks (MusicPlayer)."""
        if at_sample is None:
            self._playing = False
            self._seek_seq += 1
            self._seek_secs = 0.0
        else:
            self._scheduled.append((int(at_sample), "stop", None))
            self._scheduled.sort(key=lambda e: e[0])

    def set_playhead(self, secs: float, at_sample: int | None = None):
        if at_sample is None:
            self._seek_seq += 1
            self._seek_secs = max(float(secs), 0.0)
        else:
            self._scheduled.append(
                (int(at_sample), "seek", max(float(secs), 0.0))
            )
            self._scheduled.sort(key=lambda e: e[0])

    def cancel_scheduled(self) -> None:
        """Drop every pending ``at_sample=`` command not yet consumed
        by a dispatch."""
        self._scheduled.clear()

    def set_playback_rate(self, rate: float):
        self._rate = float(np.clip(rate, 0.0, 4.0))

    def set_percent_volume(self, percent_volume: float):
        self._raw_gain = float(
            percent_volume_to_raw_gain(np.float32(percent_volume))
        )
        self._percent_volume = max(float(percent_volume), 0.0)

    def raw_gain(self) -> float:
        return self._raw_gain

    def is_playing(self) -> bool:
        return self._playing

    # -- plumbing -------------------------------------------------------------
    def info(self) -> AudioNodeInfo:
        return AudioNodeInfo(
            num_min_supported_outputs=1,
            num_max_supported_outputs=MAX_PORTS,
            updates=True,
        )

    def activate(self, sample_rate, max_block_frames, num_inputs, num_outputs):
        self._sample_rate = int(sample_rate)
        self._max_block_frames = int(max_block_frames)
        return StreamingSamplerProcessor(
            self, sample_rate, max_block_frames, num_inputs, num_outputs
        )


class StreamingSamplerProcessor(NodeProcessor):
    supports_megakernel = False  # data-dependent playback gathers
    def __init__(self, node, sample_rate, max_block_frames, num_inputs, num_outputs):
        super().__init__(sample_rate, max_block_frames, num_inputs, num_outputs)
        self._node = node
        self._coeffs = smoother_coeffs(sample_rate, SmootherConfig())
        self._eps = SmootherConfig().settle_epsilon

        self.window_frames = max(
            4 * max_block_frames,
            int(node._window_secs * sample_rate),
        )
        self._window = _frozen(np.zeros((1, self.window_frames), np.float32))
        self._window_start = 0
        self._window_valid = False
        # host shadow playhead (frames, float for fractional rates)
        self._est_playhead = 0.0
        self._seen_seek_seq = node._seek_seq
        self.refill_count = 0

    #: scheduled transport commands ride per-block param timelines
    #: (executor.PerBlock) — and the executor passes the dispatch's block
    #: count + start sample so the prefetch shadow clock simulates the
    #: SAME per-block transport the device will apply
    collect_timeline = True

    # -- host-side window management -----------------------------------------
    def _refill(self, start: int):
        # a fresh array each refill, never rewritten: a dispatch still in
        # flight reads the window it was given
        reader = self._node._reader
        ch = reader.num_channels
        self._window = _frozen(np.array(np.asarray(
            reader.read(start, self.window_frames), np.float32
        ).reshape(ch, self.window_frames)))
        self._window_start = start
        self._window_valid = True
        self.refill_count += 1

    def collect_params(
        self, blocks=1, start_sample=None, frames=None, consume=True
    ):
        node = self._node
        reader = node._reader
        has_reader = reader is not None

        # clip-native rate: rated readers auto-convert (a 44.1 kHz file
        # plays at native pitch in a 48 kHz stream) and seeks address
        # CLIP time — same contract as SampleResource.sample_rate
        clip_sr = float(
            getattr(reader, "sample_rate", 0) or self.sample_rate
        ) if has_reader else float(self.sample_rate)
        eff_rate = node._rate * clip_sr / self.sample_rate

        k = max(1, int(np.ceil(blocks)))
        f = int(frames or self.max_block_frames)

        # apply immediate seeks to the shadow playhead (seconds → clip frames)
        seek_frame = min(
            max(int(round(node._seek_secs * clip_sr)), 0), 0xFFFFFFFF
        )
        if node._seek_seq != self._seen_seek_seq:
            self._seen_seek_seq = node._seek_seq
            self._est_playhead = float(seek_frame)
            self._window_valid = False

        # -- per-block transport timelines (chunked hot path) ---------------
        # Consume scheduled play/pause/stop/seek commands landing in this
        # dispatch window and build the SAME per-block flags the device
        # will apply — then simulate them on the shadow playhead so the
        # prefetch window stays in lockstep with scheduled transport.
        playing_tl = np.full(k, bool(node._playing and has_reader))
        seq_tl = np.full(k, np.uint32(node._seek_seq), np.uint32)
        pos_tl = np.full(k, np.uint32(seek_frame), np.uint32)
        play_seq_tl = np.full(
            k, np.uint32(node._play_seq & 0xFFFFFFFF), np.uint32
        )
        # sub-block start offset, applied by the kernel at the play-seq
        # trigger block only — scheduled starts are SAMPLE-accurate
        # (music joins and loop periods are exact, not block-rounded)
        offset_tl = np.zeros(k, np.uint32)
        seek_at_block: dict[int, int] = {}
        play_off_at_block: dict[int, int] = {}
        if (
            consume
            and start_sample is not None
            and node._scheduled
        ):
            start = int(start_sample)
            end = start + k * f
            cur_playing = node._playing
            cur_seq = node._seek_seq
            cur_play_seq = node._play_seq
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
                    off = max(0, int(at) - (start + b * f))
                    offset_tl[b] = np.uint32(min(off, f - 1))
                    play_off_at_block[b] = min(off, f - 1)
                elif kind == "pause":
                    cur_playing = False
                elif kind == "stop":
                    cur_playing = False
                    cur_seq += 1
                    node._seek_secs = 0.0
                    pos_tl[b:] = np.uint32(0)
                    seq_tl[b:] = np.uint32(cur_seq & 0xFFFFFFFF)
                    seek_at_block[b] = 0
                elif kind == "seek":
                    cur_seq += 1
                    node._seek_secs = float(payload)
                    tgt = min(
                        max(int(round(payload * clip_sr)), 0), 0xFFFFFFFF
                    )
                    pos_tl[b:] = np.uint32(tgt)
                    seq_tl[b:] = np.uint32(cur_seq & 0xFFFFFFFF)
                    seek_at_block[b] = tgt
                playing_tl[b:] = cur_playing and has_reader
            node._playing = cur_playing
            node._seek_seq = cur_seq
            node._play_seq = cur_play_seq
            self._seen_seek_seq = cur_seq
            node._scheduled = remaining

        if has_reader:
            span = f * float(k)
            # the whole upcoming dispatch must fit the window (plus an
            # interpolation guard); grow it for large chunked dispatches
            # (a growth is a one-time retrace)
            needed = int(2 * span * max(eff_rate, 1.0)) + 3 * self.max_block_frames
            if needed > self.window_frames:
                self.window_frames = needed
                self._window = _frozen(np.zeros(
                    (self._window.shape[0], self.window_frames), np.float32
                ))
                self._window_valid = False
            need_start = int(self._est_playhead)
            lookahead_end = int(
                self._est_playhead + span * max(eff_rate, 1.0) * 2
            )
            if (
                not self._window_valid
                or need_start < self._window_start
                or lookahead_end > self._window_start + self.window_frames
            ):
                # window begins slightly before the playhead so interpolation
                # never reads behind it
                self._refill(max(0, need_start - self.max_block_frames))
            if consume:
                # advance the shadow clock exactly as the device will: a
                # seek resets it at its block, playing blocks advance it.
                # Clamp at EOF: the device latches `ended` there, and an
                # unbounded shadow playhead would trigger useless (or, for
                # callback readers, failing) refills past the clip forever.
                est = self._est_playhead
                if seek_at_block or play_off_at_block or not playing_tl.all():
                    for b in range(k):
                        if b in seek_at_block:
                            est = float(seek_at_block[b])
                        if playing_tl[b]:
                            est += (
                                f - play_off_at_block.get(b, 0)
                            ) * eff_rate
                elif playing_tl.any():
                    est += span * eff_rate
                self._est_playhead = min(est, float(reader.len_frames))

        out = {
            "raw_gain": np.float32(node.raw_gain()),
            "rate": np.float32(eff_rate),
            "window": self._window,
            "window_start": np.uint32(self._window_start),
            "len_frames": np.uint32(
                reader.len_frames if has_reader else 0
            ),
        }
        if start_sample is None:
            # unpacked paths (BatchRenderer, direct kernels): plain
            # scalars; scheduled commands stay queued for a
            # timeline-capable dispatch
            out["playing"] = np.asarray(
                bool(node._playing and has_reader), bool
            )
            out["seek_seq"] = np.uint32(node._seek_seq)
            out["seek_pos"] = np.uint32(seek_frame)
            out["play_seq"] = np.uint32(node._play_seq & 0xFFFFFFFF)
            out["start_offset"] = np.uint32(0)
            return out

        from ..executor import PerBlock

        out["playing"] = PerBlock(playing_tl)
        out["seek_seq"] = PerBlock(seq_tl)
        out["seek_pos"] = PerBlock(pos_tl)
        out["play_seq"] = PerBlock(play_seq_tl)
        out["start_offset"] = PerBlock(offset_tl)
        return out

    def init_state(self):
        u32 = lambda: torch.zeros((), dtype=torch.int64)  # noqa: E731
        return {
            "gain": smoother_init(np.float32(self._node.raw_gain())),
            "playhead": u32(),
            "frac": torch.zeros((), dtype=torch.float32),
            "ended": torch.zeros((), dtype=torch.bool),
            "prev_playing": torch.zeros((), dtype=torch.bool),
            "seek_seq": u32(),
            "play_seq": u32(),
            "finish_count": u32(),
        }

    def resync_from_state(self, state) -> None:
        node = self._node
        node._seek_seq = int(torch.as_tensor(state["seek_seq"]).max())
        node._play_seq = int(torch.as_tensor(state["play_seq"]).max())
        # adopt the restored device playhead into the prefetch shadow
        # clock (and swallow the seq edge): otherwise the next collect
        # would take the restored seq for a fresh seek, rewind the window
        # to the stale host seek target, and the deck would render silence
        # from a window that no longer covers the playhead
        self._seen_seek_seq = node._seek_seq
        self._est_playhead = float(
            torch.as_tensor(state["playhead"]).max()
        ) + float(torch.as_tensor(state["frac"]).max())
        self._window_valid = False

    def event_counters(self):
        """``finished``: the stream reached EOF (core/events.py)."""
        return {"finished": "finish_count"}

    def kernel(self, params, state, inputs, in_mask, info):
        frames = inputs.shape[-1]
        n_out = self.num_outputs
        window = params["window"]
        w_ch, w_len = window.shape[-2:]
        dev = window.device
        f32 = torch.float32

        seek_new = params["seek_seq"] != state["seek_seq"]
        playhead = torch.where(seek_new, params["seek_pos"], state["playhead"])
        frac = state["frac"].masked_fill(seek_new, 0.0)
        ended = state["ended"] & ~seek_new

        rising = params["playing"] & ~state["prev_playing"]
        trigger = params["play_seq"] != state["play_seq"]
        ended = ended & ~(rising | trigger)
        playing = params["playing"] & ~ended

        ramp, gain_processed, smoothing = smoother_set_and_process(
            state["gain"], params["raw_gain"], frames, self._coeffs, self._eps
        )
        gain_state = {k: torch.where(playing, gain_processed[k], v)
                      for k, v in state["gain"].items()}
        muted = ~smoothing & (ramp[..., 0] < _MUTE_F32)

        rate = params["rate"]
        # sub-block start offset: a scheduled play beginning mid-block
        # outputs silence for the first `start_off` samples and advances
        # only the remainder (sample-accurate starts, music.MusicPlayer)
        start_off = torch.where(
            trigger, params["start_offset"],
            torch.zeros_like(params["start_offset"])).to(f32)
        k = torch.arange(frames, dtype=f32, device=dev)
        off = torch.clamp_min(
            _fma(k - start_off[..., None], rate[..., None], frac[..., None]), 0.0)
        off_floor = torch.floor(off)
        interp_w = off - off_floor

        pos = (playhead[..., None] + off_floor.to(torch.int64)) & UINT32_MASK
        rel = wrap_int32(wrap_int32(pos) - wrap_int32(params["window_start"])[..., None])
        in_window = (rel >= 0) & (rel < w_len - 1)
        in_clip = pos < params["len_frames"][..., None]
        valid = in_window & in_clip & (k >= start_off[..., None])
        idx0 = rel.clamp(0, w_len - 1)
        idx1 = wrap_int32(rel + 1).clamp(0, w_len - 1)

        s0 = _take(window, idx0)
        out_rows = s0 + (_take(window, idx1) - s0) * interp_w[..., None, :]
        out_rows = out_rows.masked_fill(~valid[..., None, :], 0.0)

        adv = _fma(float(frames) - start_off, rate, frac)
        adv_int = torch.floor(adv)
        new_playhead = (playhead + adv_int.to(torch.int64)) & UINT32_MASK
        new_frac = adv - adv_int
        finished = new_playhead >= params["len_frames"]
        fire = playing & finished

        silent = ~playing | muted
        # a muted streaming voice keeps consuming (unlike SamplerNode):
        # the host's prefetch shadow clock advances in lockstep with this
        # playhead and cannot see the device-side smoother's mute
        new_state = {
            "gain": gain_state,
            "playhead": torch.where(playing, new_playhead, playhead),
            "frac": torch.where(playing, new_frac, frac),
            "ended": ended | fire,
            "prev_playing": params["playing"],
            "seek_seq": params["seek_seq"],
            "play_seq": params["play_seq"],
            "finish_count": (state["finish_count"] + fire.to(torch.int64))
            & UINT32_MASK,
        }

        gained = out_rows * ramp[..., None, :]
        zeros = torch.zeros_like(gained[..., 0, :])
        rows, mask_rows = [], []
        for ch in range(n_out):
            if ch < w_ch:
                rows.append(gained[..., ch, :])
                mask_rows.append(silent)
            elif n_out == 2 and w_ch == 1:
                rows.append(gained[..., 0, :])
                mask_rows.append(silent)
            else:
                rows.append(zeros)
                mask_rows.append(torch.ones_like(silent))
        out = gate(torch.stack(rows, dim=-2), silent)
        return out, new_state, torch.stack(mask_rows, dim=-1)
