"""Music system: gapless queueing and crossfades over streaming decks.

The reference's design scope ends at the sampler's "disk and network
streaming" bullet (DESIGN_DOC.md sampler list); every shipping game audio
engine layers a *music system* on top — gapless track sequencing,
crossfades, looped beds.  This module is that layer, built entirely from
engine primitives (no new kernels):

* **Two alternating decks**, each a
  :class:`~firewheel_tpu.nodes.streaming_sampler.StreamingSamplerNode`
  (arbitrary-length tracks stream through a fixed window — a track change
  never retraces) feeding a :class:`~firewheel_tpu.nodes.volume.VolumeNode`
  (the fade lane), summed into the destination.
* **Transitions are scheduled, not reactive.**  A queued track's start
  rides the streaming sampler's ``play(at_sample=...)`` per-block timeline
  — inside a K-block chunked dispatch, with no host round-trip at the
  transition — and carries a sub-block start offset the kernel applies at
  the trigger block, so joins are **sample-exact**: a looped bed's period
  equals its length to the sample (phase-continuity verified on-chip
  against an analytic sine).
* **Fades are volume ramps** scheduled block-accurately on the deck's
  VolumeNode (equal-power sin/cos), so a 4-second crossfade costs a few
  hundred scheduled scalar points and zero recompiles.
* **Completion is device truth**: feed ``cx.poll_events()`` into
  :meth:`MusicPlayer.poll` and finished tracks report from the on-device
  finish counters (``core/events.py``).

Two decks means ONE transition can be device-scheduled at a time (a live
deck cannot adopt a new reader early — ``set_reader`` is immediate);
deeper queues wait host-side and are promoted by :meth:`update` /
:meth:`poll` as transitions complete — promotion happens a full track
ahead, so the device schedule never starves.  The deck-alternation design
exists because a streaming window cannot cover a mid-chunk rewind
(tail → head) on ONE deck; the next track (or loop iteration) always
starts on the *other* deck, whose window prefetches at the head.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from .nodes.sampler import SamplerNode
from .nodes.streaming_sampler import StreamingSamplerNode
from .nodes.sum import SumNode
from .nodes.volume import VolumeNode
from .core.formats import as_stream_reader
from .core.units import db_to_gain, raw_gain_to_percent_volume

__all__ = ["MusicPlayer"]

#: fade ramps schedule one point per this many samples (~5 ms at 48 kHz —
#: finer than the 10 ms smoother that glides between points)
_RAMP_STEP = 256


def _pct_for_amp(amp: float) -> float:
    """Percent value whose raw gain is ``amp`` (core/units inverse)."""
    return float(raw_gain_to_percent_volume(np.float32(amp)))


class _Deck:
    __slots__ = ("sampler", "sampler_id", "vol", "vol_id", "start_sample",
                 "end_sample", "reader", "prev_reader", "gain_db")

    def __init__(self, sampler, sampler_id, vol, vol_id):
        self.sampler = sampler
        self.sampler_id = sampler_id
        self.vol = vol
        self.vol_id = vol_id
        self.start_sample = -1
        self.end_sample = -1  # absolute stream sample the deck goes idle
        self.reader = None
        self.prev_reader = None
        self.gain_db = 0.0


class MusicPlayer:
    """Gapless/crossfaded music over two alternating streaming decks.

    Build it BEFORE compiling/activating (it adds nodes to the graph)::

        player = MusicPlayer(cx.graph,
                             clock=lambda: cx.stream.frames_rendered)
        cx.activate(...)
        player.play(WavStreamReader("intro.wav"))
        player.queue(WavStreamReader("chorus.wav"), crossfade_secs=2.0)
        ...
        player.update()                      # once per game frame
        for kind, reader in player.poll(cx.poll_events()):
            ...                              # ("finished", reader)

    ``clock``: zero-arg callable returning the current absolute stream
    sample (bind ``lambda: cx.stream.frames_rendered``); with it, ``now``
    may be omitted everywhere.  ``dest``: ``(node_id, ports)`` to receive
    the music mix; defaults to the graph's output ports.
    """

    def __init__(
        self,
        graph,
        *,
        channels: int = 2,
        dest=None,
        window_secs: float = 2.0,
        clock=None,
    ):
        assert channels in (1, 2)
        self.graph = graph
        self.channels = int(channels)
        self._clock = clock
        if dest is None:
            dest_node = graph.graph_out_node()
            dest_ports = (0, 1) if channels == 2 else (0,)
        else:
            dest_node, dest_ports = dest
        n_ch = len(dest_ports)
        # 2 streaming decks + 2 stinger samplers, summed
        self.sum_id = graph.add_node(4 * n_ch, n_ch, SumNode())
        self.decks: list[_Deck] = []
        for i in range(2):
            s = StreamingSamplerNode(window_secs=window_secs)
            sid = graph.add_node(0, n_ch, s)
            v = VolumeNode(100.0)
            vid = graph.add_node(n_ch, n_ch, v)
            for ch in range(n_ch):
                graph.connect(sid, ch, vid, ch)
                graph.connect(vid, ch, self.sum_id, n_ch * i + ch)
            self.decks.append(_Deck(s, sid, v, vid))
        #: stinger lanes: TWO in-memory samplers for short musical
        #: overlays (clips are live params — same-shape swaps are free).
        #: Two lanes make the common retrigger — a new stinger while the
        #: previous one still sounds — sample-accurate: it fires on the
        #: free lane instead of waiting host-side for the busy one.
        self._stingers: list[SamplerNode] = []
        self.stinger_ids: list[int] = []
        self._stinger_ends = [-1, -1]  # stream sample each lane ends
        self._stinger_starts = [-1, -1]  # stream sample each lane fires
        for j in range(2):
            st = SamplerNode(100.0)
            stid = graph.add_node(0, n_ch, st)
            self._stingers.append(st)
            self.stinger_ids.append(stid)
            for ch in range(n_ch):
                graph.connect(stid, ch, self.sum_id, (2 + j) * n_ch + ch)
        self.stinger_id = self.stinger_ids[0]
        for j, port in enumerate(dest_ports):
            graph.connect(self.sum_id, j, dest_node, port)
        self._current: Optional[int] = None  # audibly-playing deck
        self._tail: Optional[int] = None  # deck of the LAST scheduled track
        self._pending: list[tuple] = []  # (reader, gain_db, crossfade_secs)
        self._loop_reader = None
        self._loop_gain_db = 0.0
        self._pending_stinger: Optional[tuple] = None  # (clip, gain_db, at)
        # musical grid for quantized transitions (set_tempo)
        self._bpm = 0.0
        self._beats_per_bar = 4
        self._grid_origin = 0  # stream sample of beat/bar zero

    # -- internals -------------------------------------------------------------
    def _now(self, now) -> int:
        if now is not None:
            return int(now)
        assert self._clock is not None, "pass now= or bind clock="
        return int(self._clock())

    def _sr(self) -> int:
        return int(self.decks[0].sampler._sample_rate)


    def _stream_len(self, reader) -> int:
        """Track length in STREAM frames (rated readers convert)."""
        sr = self._sr()
        clip_sr = float(getattr(reader, "sample_rate", 0) or sr)
        return int(math.ceil(reader.len_frames * sr / clip_sr))

    def _cancel_all_scheduled(self):
        """Drop every not-yet-dispatched transport/fade command (a hard
        transition supersedes whatever was queued on the device)."""
        for d in self.decks:
            d.sampler.cancel_scheduled()
            d.vol.cancel_scheduled()
        self._pending.clear()

    def _ramp(self, deck: _Deck, t0: int, secs: float, a0: float, a1: float):
        """Equal-power amplitude ramp a0→a1 over [t0, t0+secs]."""
        sr = self._sr()
        n = max(1, int(round(secs * sr)))
        for t in range(0, n, _RAMP_STEP):
            x = t / n
            # up-fades ride sin, down-fades 1-cos — two crossfading decks
            # sum to ~constant power
            w = math.sin(0.5 * math.pi * x) if a1 >= a0 else (
                1.0 - math.cos(0.5 * math.pi * x)
            )
            amp = a0 + (a1 - a0) * w
            deck.vol.set_percent_volume(_pct_for_amp(amp), at_sample=t0 + t)
        deck.vol.set_percent_volume(_pct_for_amp(a1), at_sample=t0 + n)

    def _schedule_track(self, idx: int, reader, gain_db: float, at: int,
                        fade_in_secs: float):
        """Arm deck ``idx`` (must be idle) to start ``reader`` at ``at``
        — SAMPLE-accurate: the streaming sampler's scheduled play carries
        a sub-block start offset, so chained joins are exact and loop
        periods equal the track length."""
        at = max(0, int(at))
        d = self.decks[idx]
        d.sampler.set_reader(reader)  # immediate rewind; deck is idle
        d.prev_reader = d.reader  # event attribution across re-arming
        d.reader = reader
        d.gain_db = float(gain_db)
        amp = float(db_to_gain(np.float32(gain_db)))
        if fade_in_secs > 0:
            d.vol.set_percent_volume(0.0)
            self._ramp(d, at, fade_in_secs, 0.0, amp)
        else:
            d.vol.set_percent_volume(_pct_for_amp(amp), at_sample=at)
        d.sampler.play(at_sample=at)
        d.start_sample = at
        d.end_sample = at + self._stream_len(reader)
        self._tail = idx

    # -- musical grid ----------------------------------------------------------
    def set_tempo(self, bpm: float, beats_per_bar: int = 4,
                  origin_sample: int = 0):
        """Define the musical grid quantized transitions snap to.
        ``origin_sample``: the stream sample of beat zero (usually the
        current track's start)."""
        self._bpm = max(float(bpm), 0.0)
        self._beats_per_bar = max(int(beats_per_bar), 1)
        self._grid_origin = int(origin_sample)

    def _quantize(self, at: int, quantize) -> int:
        """Next grid boundary at/after ``at``: ``None`` (as-is),
        ``"beat"``, or ``"bar"`` (requires :meth:`set_tempo`)."""
        if not quantize:
            return at
        # a real exception, not an assert: asserts vanish under -O and the
        # failure would otherwise surface as a bare ZeroDivisionError
        if self._bpm <= 0:
            raise ValueError("set_tempo() before quantized transitions")
        step = self._sr() * 60.0 / self._bpm
        if quantize == "bar":
            step *= self._beats_per_bar
        n = math.ceil(max(0.0, (at - self._grid_origin)) / step)
        return self._grid_origin + int(round(n * step))

    def stinger(self, clip, *, gain_db: float = 0.0, quantize=None,
                now: int | None = None):
        """Fire a short musical overlay ON TOP of the current music —
        optionally ``quantize="beat"``/``"bar"`` so it lands on the grid
        (the middleware 'stinger' feature).  ``clip`` is a
        :class:`SampleResource` — or a path string, whole-file decoded
        through ``load_audio`` (stingers are short); same-shape clips
        swap without retraces (pad a stinger set to one length for
        zero-recompile switching).  Returns the absolute stream sample
        the stinger fires at."""
        if isinstance(clip, str) or hasattr(clip, "__fspath__"):
            from .core.formats import load_audio

            clip, _sr = load_audio(clip)
        t = self._now(now)
        at = self._quantize(t, quantize)
        free = [j for j, e in enumerate(self._stinger_ends) if e <= t]
        if free:
            # a silent lane exists: fire (or schedule for `at`) on it —
            # sample-accurate, any still-sounding overlay plays out on the
            # other lane untouched.  A staged stinger is superseded.
            self._pending_stinger = None
            self._fire_stinger(free[0], clip, float(gain_db), at)
            return at
        if at > t:
            # BOTH overlays still sounding and the retrigger lies in the
            # future: re-programming either lane now would cut it.  Stage
            # host-side; update() fires it once a lane frees (sample-
            # accurate when that happens before the boundary) or at the
            # boundary (within the host's update cadence when all three
            # overlap — the two-lane trade-off).
            self._pending_stinger = (clip, float(gain_db), at)
            return at
        # immediate retrigger with every lane busy: cut the one ending
        # soonest (the least audible loss)
        self._pending_stinger = None
        lane = min(range(len(self._stingers)),
                   key=lambda j: self._stinger_ends[j])
        self._fire_stinger(lane, clip, float(gain_db), at)
        return at

    def _fire_stinger(self, lane: int, clip, gain_db: float, at: int):
        st = self._stingers[lane]
        st.cancel_scheduled()
        st.set_sample(clip)
        st.set_percent_volume(
            _pct_for_amp(float(db_to_gain(np.float32(gain_db))))
        )
        st.play(at_sample=at)
        self._stinger_starts[lane] = at
        self._stinger_ends[lane] = at + self._stream_len(clip)

    def _mark_cut(self, d: _Deck, at: int, end: int | None = None):
        """Bookkeeping after a deck's playback was cut at ``at``: a deck
        whose armed FUTURE start was cancelled never played (start -1,
        idle at ``at``); a playing deck goes idle at ``end`` (default
        ``at``)."""
        if d.start_sample > at:
            d.start_sample = -1
            d.end_sample = at
        else:
            d.end_sample = at if end is None else end

    # -- transport -------------------------------------------------------------
    def play(self, reader, *, gain_db: float = 0.0, now: int | None = None,
             fade_in_secs: float = 0.0, loop: bool = False):
        """Start ``reader`` at the next block, hard-cutting any current
        track at that block (fade the old one out instead with
        :meth:`crossfade_to`).  ``loop=True`` re-queues the track
        gaplessly on alternating decks for as long as it stays current
        (:meth:`update` keeps one iteration scheduled ahead).  ``reader``
        may be a path string — any registered stream format opens
        (``core.formats.open_stream_reader``)."""
        reader = as_stream_reader(reader)
        at = self._now(now)
        self.update(now=at)  # sync current/tail with the stream clock
        self._pending.clear()
        if self._current is not None:
            # hard-cut the audible track; the other deck gets cut by
            # _schedule_track's set_reader
            cur = self.decks[self._current]
            cur.sampler.cancel_scheduled()
            cur.vol.cancel_scheduled()
            cur.sampler.pause(at_sample=at)
            self._mark_cut(cur, at)
            idx = 1 - self._current
        else:
            if self._tail is not None:
                # a quantized transition armed from the stopped state has
                # not started yet — this play supersedes it
                armed = self.decks[self._tail]
                armed.sampler.cancel_scheduled()
                armed.vol.cancel_scheduled()
                self._mark_cut(armed, at)
            # prefer a deck already idle at `at`: a stop(fade) leaves one
            # deck audibly fading — grabbing it would cut the fade
            idle = [i for i, d in enumerate(self.decks)
                    if d.end_sample <= at]
            idx = idle[0] if idle else min(
                range(2), key=lambda i: self.decks[i].end_sample
            )
        d = self.decks[idx]
        d.sampler.cancel_scheduled()
        d.vol.cancel_scheduled()
        self._loop_reader = reader if loop else None
        self._loop_gain_db = float(gain_db)
        self._schedule_track(idx, reader, gain_db, at, fade_in_secs)
        self._current = idx
        self._top_up_loop()

    def queue(self, reader, *, gain_db: float = 0.0,
              crossfade_secs: float = 0.0, now: int | None = None):
        """Play ``reader`` after the last scheduled track — gapless
        (block-aligned) by default, or overlapped by ``crossfade_secs``
        of equal-power crossfade.  Queue depth is unlimited: the first
        follow-on is armed on the device; deeper entries wait host-side
        and are promoted a full track ahead by :meth:`update`.
        ``reader`` may be a path string."""
        reader = as_stream_reader(reader)
        if now is not None or self._clock is not None:
            self.update(now=now)  # sync current/tail with the stream clock
        if self._current is None:
            if self._tail is not None:
                # a quantized transition armed from the stopped state has
                # not reached its grid boundary yet — preserve FIFO order:
                # the queued track waits host-side and update() promotes
                # it after the armed track becomes current
                self._loop_reader = None
                self._pending.append((reader, float(gain_db),
                                      float(crossfade_secs)))
                return
            return self.play(reader, gain_db=gain_db, now=now)
        self._loop_reader = None  # an explicit queue ends a loop
        if self._tail != self._current or self._pending:
            # a transition is already armed (or earlier entries are
            # waiting) — preserve FIFO order
            self._pending.append((reader, float(gain_db),
                                  float(crossfade_secs)))
            return
        t = (self._now(now)
             if (now is not None or self._clock is not None) else None)
        other = self.decks[1 - self._current]
        if t is not None and other.end_sample > t:
            # the other deck is still audible (e.g. a crossfade's
            # outgoing tail) — arming it now would hard-cut the fade;
            # update() promotes this entry once the deck goes idle
            self._pending.append((reader, float(gain_db),
                                  float(crossfade_secs)))
            return
        self._queue_on_device(reader, gain_db, crossfade_secs)

    def _queue_on_device(self, reader, gain_db, crossfade_secs):
        prev = self.decks[self._tail]
        end = prev.end_sample
        sr = self._sr()
        fade = max(0.0, float(crossfade_secs))
        start = max(0, end - int(round(fade * sr)))
        if fade > 0:
            # ramp the outgoing deck down across the overlap; the safety
            # pause lands one block AFTER the end so the device EOF latch
            # (and its `finished` event) fires before playing drops
            self._ramp(prev, start, fade,
                       float(db_to_gain(np.float32(prev.gain_db))), 0.0)
            blk = int(prev.sampler._max_block_frames)
            prev.sampler.pause(at_sample=end + blk)
        self._schedule_track(1 - self._tail, reader, gain_db, start,
                             fade_in_secs=fade)

    def crossfade_to(self, reader, secs: float, *, gain_db: float = 0.0,
                     now: int | None = None, quantize=None):
        """Transition to ``reader`` over ``secs`` of equal-power
        crossfade — immediately, or ``quantize="beat"``/``"bar"`` snaps
        the transition to the next grid boundary (interactive-music
        quantized transitions; :meth:`set_tempo` defines the grid): the
        incoming track starts ON the grid point and the crossfade runs
        from it.  ``reader`` may be a path string."""
        reader = as_stream_reader(reader)
        t_now = self._now(now)
        at = self._quantize(t_now, quantize)
        self.update(now=t_now)  # sync current/tail with the stream clock
        secs = max(float(secs), 1e-3)
        self._pending.clear()
        self._loop_reader = None
        sr = self._sr()
        if self._current is not None:
            cur = self.decks[self._current]
            cur.sampler.cancel_scheduled()
            cur.vol.cancel_scheduled()
            self._ramp(cur, at, secs,
                       float(db_to_gain(np.float32(cur.gain_db))), 0.0)
            cur.sampler.pause(at_sample=at + int(round(secs * sr)))
            self._mark_cut(cur, at, end=at + int(round(secs * sr)))
            idx = 1 - self._current
        else:
            if self._tail is not None:
                # an earlier quantized transition armed from the stopped
                # state never started — this one supersedes it
                armed = self.decks[self._tail]
                armed.sampler.cancel_scheduled()
                armed.vol.cancel_scheduled()
                self._mark_cut(armed, t_now)
            # after stop(fade) one deck may still be fading NOW — classify
            # idleness at call time (NOT the future grid point: a fade
            # ending before the boundary is still audible here) and LEAVE
            # the fading deck's ramp+pause intact so its fade completes
            # underneath the incoming track
            idle = [i for i, d in enumerate(self.decks)
                    if d.end_sample <= t_now]
            idx = idle[0] if idle else min(
                range(2), key=lambda i: self.decks[i].end_sample
            )
        d = self.decks[idx]
        d.sampler.cancel_scheduled()
        d.vol.cancel_scheduled()
        self._schedule_track(idx, reader, gain_db, at, fade_in_secs=secs)
        # current = the AUDIBLE deck: until the grid boundary passes, the
        # old deck (or, from the stopped state, no deck at all) stays
        # current — update() flips current to the tail once `at` passes,
        # so transport calls issued before the boundary act on what the
        # player actually hears (stop(fade) fades it / cancels the armed
        # deck, they don't hard-cut the incoming track)
        if at <= t_now:
            self._current = idx

    def stop(self, *, fade_secs: float = 0.0, now: int | None = None):
        """Fade out (or hard-pause) the current track, clear the queue,
        and drop any stinger that has not yet FIRED — staged host-side
        for its grid boundary, or already device-scheduled on a free
        lane (the second lane made quantized stingers device-schedule
        immediately, so stop() must cancel those too) — while a stinger
        already sounding plays out on its own lane."""
        at = self._now(now)
        self.update(now=at)
        self._cancel_all_scheduled()
        self._loop_reader = None
        self._pending_stinger = None
        for j, st in enumerate(self._stingers):
            if self._stinger_starts[j] > at:
                st.cancel_scheduled()
                st.stop()
                self._stinger_starts[j] = -1
                self._stinger_ends[j] = -1
        if self._current is None:
            # nothing is current, but decks may not be silent: a cancelled
            # armed transition goes idle now, and a deck still draining an
            # earlier stop-fade is hard-cut (its ramp + safety pause were
            # just wiped — without a pause it would sound forever)
            self._tail = None
            for d in self.decks:
                if d.start_sample > at:
                    self._mark_cut(d, at)
                elif d.end_sample > at:
                    d.sampler.pause(at_sample=at)
                    self._mark_cut(d, at)
            return
        cur = self.decks[self._current]
        other = self.decks[1 - self._current]
        other.sampler.pause(at_sample=at)  # cancel wiped its commands
        self._mark_cut(
            other, at,
            end=min(other.end_sample, at) if other.end_sample >= 0 else at,
        )
        if fade_secs > 0:
            self._ramp(cur, at, fade_secs,
                       float(db_to_gain(np.float32(cur.gain_db))), 0.0)
            fade_end = at + int(round(fade_secs * self._sr()))
            cur.sampler.pause(at_sample=fade_end)
            # audible until the fade completes (unless it never started)
            self._mark_cut(cur, at, end=fade_end)
        else:
            cur.sampler.pause(at_sample=at)
            self._mark_cut(cur, at)
        self._current = None
        self._tail = None

    # -- bookkeeping -----------------------------------------------------------
    def _top_up_loop(self):
        """Keep exactly one future loop iteration armed on the device."""
        if self._loop_reader is None or self._current is None:
            return
        if self._tail != self._current:
            return  # next iteration already armed
        cur = self.decks[self._current]
        self._schedule_track(1 - self._current, self._loop_reader,
                             self._loop_gain_db, cur.end_sample,
                             fade_in_secs=0.0)

    def update(self, now: int | None = None):
        """Advance bookkeeping on the stream clock: flips the current
        deck once an armed follow-on (queue/loop) has started, promotes
        host-side queue entries, and keeps one loop iteration armed.
        Call once per game frame."""
        if now is None and self._clock is None:
            return
        t = self._now(now)
        if self._pending_stinger is not None:
            clip, gdb, s_at = self._pending_stinger
            if t >= min(s_at, min(self._stinger_ends)):
                # a lane freed (fire the staged one armed for its
                # boundary) or the boundary arrived with every lane still
                # sounding (retrigger now — late by at most one host
                # frame, cutting the soonest-ending overlay)
                self._pending_stinger = None
                free = [j for j, e in enumerate(self._stinger_ends)
                        if e <= t]
                lane = free[0] if free else min(
                    range(len(self._stingers)),
                    key=lambda j: self._stinger_ends[j],
                )
                self._fire_stinger(lane, clip, gdb, s_at)
        if self._current is None:
            if (self._tail is None
                    or t < self.decks[self._tail].start_sample):
                return
            # a transition armed from the stopped state reached its grid
            # boundary: the armed deck becomes the audible current
            self._current = self._tail
        elif (
            self._tail != self._current
            and t >= self.decks[self._tail].start_sample
        ):
            # the armed follow-on is now the audible track
            self._current = self._tail
        if self._tail == self._current:
            # nothing armed; the other deck can be re-armed once it has
            # actually gone idle (a crossfade's outgoing fade may still
            # be running when the new track starts)
            other = self.decks[1 - self._current]
            if t >= other.end_sample:
                if self._pending:
                    self._queue_on_device(*self._pending.pop(0))
                else:
                    self._top_up_loop()

    def poll(self, events) -> list:
        """Translate a ``poll_events()`` batch: returns
        ``[("finished", reader), ...]`` for tracks whose deck reported
        EOF on-device; also runs :meth:`update` when a clock is bound.

        Attribution: a finish belongs to the track that most recently
        ENDED on the deck — when the deck was already re-armed with a
        follow-on that has not finished yet (queue promotion lands at
        the same stream time the finish event is generated), the event
        is attributed to the PREVIOUS reader, not the pending one."""
        out = []
        ids = {d.sampler_id: d for d in self.decks}
        t = int(self._clock()) if self._clock is not None else None
        for e in events:
            if e.name == "finished" and e.node_id in ids:
                d = ids[e.node_id]
                stale = (
                    t is not None
                    and t < d.end_sample
                    and d.prev_reader is not None
                )
                out.append(("finished",
                            d.prev_reader if stale else d.reader))
        if self._clock is not None:
            self.update()
        return out

    def current_reader(self):
        """The reader of the audibly-current deck (None when stopped,
        including while a transition armed from the stopped state still
        awaits its grid boundary)."""
        if self._current is None:
            return None
        return self.decks[self._current].reader
