"""Fire-and-forget polyphony: a fixed bank of pooled sampler voices.

PyTorch port of ``firewheel_tpu/voice_pool.py`` (reference: the design
document's "pools of nodes where the majority of the time nodes are
unused", and the sampler family, ``basic_nodes/sampler.rs``).  The
reference leaves voice management to the game; here it is a first-class
manager, because a fixed bank keeps the graph's topology still: adding or
removing a sampler per sound effect would recompile the schedule per shot,
while a fixed bank is pure parameter traffic:

* ``play()`` never recompiles — the topology (N × sampler → pan → sum)
  is built once; clips are live params.
* Triggers are sample-accurate even inside K-block dispatches
  (``SamplerNode.play(at_sample=...)`` rides the per-block timelines).
* All N voices share one clip shape (zero-padded to the pool bucket), so
  the N identical poolable samplers share one ``group_key`` and the
  executor runs them as ONE pooled group: one kernel call over a stacked
  member axis a block, not N (``ScheduleProgram._build_plan``).

Voice allocation is the classic game-audio policy: a free voice if one
exists, else steal the lowest-(priority, start-time) voice.  Freeness is
tracked with a host-side shadow clock (trigger sample + clip duration at
the stream rate), so no device readback sits on the control path; stolen
or finished voices are simply re-targeted with new params.  Handles are
generation-checked: a handle whose voice was stolen becomes a silent
no-op, never a control message to the wrong sound.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from .core.sample_resource import SampleResource
from .core.units import db_to_gain, raw_gain_to_percent_volume
from .nodes.pan import StereoPanNode
from .nodes.sampler import LoopRange, SamplerNode
from .nodes.sum import SumNode

__all__ = ["VoicePool", "VoiceHandle"]

_INF = float("inf")

#: max distinct (clip, bucket) padded copies kept; past this, entries not
#: held by a live voice evict oldest-first
_PADDED_CACHE_CAP = 256


def _db_to_percent(db: float) -> float:
    """Percent whose raw gain equals the dB gain (core/units inverse)."""
    return float(raw_gain_to_percent_volume(db_to_gain(np.float32(db))))


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n - 1).bit_length())


class VoiceHandle:
    """A live-control handle for one play().  Valid until the voice ends
    or is stolen; after that every method is a no-op (game code can keep
    handles around without use-after-steal hazards)."""

    def __init__(self, pool: "VoicePool", index: int, gen: int):
        self._pool = pool
        self._index = index
        self._gen = gen

    @property
    def alive(self) -> bool:
        """True while this handle still addresses the sound it started
        (the voice has not been stolen; shadow-clock expiry counts as
        dead for one-shots)."""
        v = self._pool._voices[self._index]
        if v.gen != self._gen:
            return False
        return v.busy_until == _INF or self._pool._now() < v.busy_until

    def _voice(self):
        v = self._pool._voices[self._index]
        return v if v.gen == self._gen else None

    def set_gain_db(self, db: float) -> None:
        v = self._voice()
        if v is not None:
            v.sampler.set_percent_volume(_db_to_percent(db))

    def set_pan(self, pan: float) -> None:
        v = self._voice()
        if v is not None:
            v.pan.set_pan(pan)

    def set_rate(self, rate: float) -> None:
        """Doppler/pitch while playing.  The shadow clock keeps the
        ORIGINAL duration estimate (a conservative free time is fine —
        stealing re-targets voices regardless)."""
        v = self._voice()
        if v is not None:
            v.sampler.set_playback_rate(rate)

    def stop(self, at_sample: int | None = None) -> None:
        v = self._voice()
        if v is not None:
            v.sampler.stop(at_sample=at_sample)
            v.busy_until = float(at_sample) if at_sample is not None else 0.0


class _Voice:
    __slots__ = (
        "sampler", "pan", "busy_until", "priority", "started_at", "gen",
        "clip", "node_id",
    )

    def __init__(self, sampler, pan):
        self.sampler = sampler
        self.pan = pan
        self.node_id = None  # the sampler's graph NodeID (event routing)
        self.busy_until = 0.0  # absolute stream sample; _INF while looping
        self.priority = -(10 ** 9)
        self.started_at = -1.0
        self.gen = 0
        self.clip = None  # the TRUE (unpadded) clip this voice holds


class VoicePool:
    """A fixed bank of ``num_voices`` sampler→pan voices summed into the
    graph.  Build it BEFORE compiling/activating::

        pool = VoicePool(g, num_voices=16, max_clip_frames=1 << 17)
        # ... cx.activate(...) / g.compile(...) as usual ...
        h = pool.play(gunshot, gain_db=-6, pan=0.3, when=now + 480)

    ``dest``: (node_id, (left_port, right_port)) to receive the pool mix;
    defaults to the graph's output ports 0/1.

    ``max_clip_frames``: the shared clip bucket (frames at clip rate,
    rounded up to a power of two).  Every clip is zero-padded to it — one
    shape, one pooled group, zero recompiles.  ``None`` derives the
    bucket from the first clip played and GROWS it (every voice moves to
    the new shape at once) when a longer clip arrives; fix it up front so
    that no play re-pads every voice's clip.

    ``clock``: optional zero-arg callable returning the current absolute
    stream sample; when set, ``play(...)``/``active_voices()`` may omit
    ``now``.  With a streaming context the authoritative clock is the
    RENDER head — bind ``clock=lambda: ctx.stream.frames_rendered`` —
    and ``when`` must be at or past it (a trigger behind the head is
    already-rendered audio; it fires at the head's next block instead).
    """

    def __init__(
        self,
        graph,
        num_voices: int = 16,
        *,
        channels: int = 2,
        max_clip_frames: Optional[int] = None,
        quality: str = "linear",
        declick_secs: float = 0.002,
        dest=None,
        clock=None,
    ):
        assert num_voices >= 1
        assert channels in (1, 2), "pool voices are mono or stereo"
        self.graph = graph
        self.num_voices = int(num_voices)
        self.channels = int(channels)
        self.declick_secs = float(declick_secs)
        self._bucket = (
            _next_pow2(max_clip_frames) if max_clip_frames else None
        )
        self._clock = clock
        self._gen_counter = 0
        self._padded: dict[tuple, SampleResource] = {}
        self._padded_refs: list = []  # keeps id() keys stable

    # topology: N × (sampler → pan) → sum → dest; built once
        if dest is None:
            dest_node = graph.graph_out_node()
            dest_ports = (0, 1) if channels == 2 else (0,)
        else:
            dest_node, dest_ports = dest
        n_ch = len(dest_ports)
        self.sum_id = graph.add_node(
            self.num_voices * n_ch, n_ch, SumNode()
        )
        self._voices: list[_Voice] = []
        for i in range(self.num_voices):
            s = SamplerNode(poolable=True, quality=quality)
            s.set_envelope(0.0, self.declick_secs)
            sid = graph.add_node(0, 2 if n_ch == 2 else 1, s)
            if n_ch == 2:
                p = StereoPanNode(0.0)
                pid = graph.add_node(2, 2, p)
                for ch in range(2):
                    graph.connect(sid, ch, pid, ch)
                    graph.connect(pid, ch, self.sum_id, n_ch * i + ch)
            else:
                p = None
                graph.connect(sid, 0, self.sum_id, i)
            v = _Voice(s, p)
            v.node_id = sid
            self._voices.append(v)
        for j, port in enumerate(dest_ports):
            graph.connect(self.sum_id, j, dest_node, port)

        # Pooled samplers stack their params per dispatch, so every voice
        # must hold a bucket-shaped sample at ALL times (a lone
        # odd-shaped member would fail the group stack).  Known bucket:
        # park silence now.  Unknown: voices stay sample-less until the
        # first clip fixes the bucket, then _grow() parks all of them.
        if self._bucket is not None:
            self._grow(self._bucket)

    def _silent(self, bucket: int) -> SampleResource:
        key = ("silence", bucket)
        got = self._padded.get(key)
        if got is None:
            got = SampleResource(
                np.zeros((self.channels, bucket), np.float32)
            )
            self._padded[key] = got
        return got

    def _grow(self, new_bucket: int) -> None:
        """Move EVERY voice to ``new_bucket``-shaped samples in one step
        (members of a pooled group must change shape together; a playing
        voice keeps playing — its audio is identical, just padded
        further)."""
        # entries keyed by the old bucket are unreachable from now on —
        # drop them (and their pinned source clips) so a session that
        # grows the bucket does not leak every clip it ever played
        self._padded = {
            k: v for k, v in self._padded.items() if k[1] == new_bucket
        }
        live = {id(c) for c, _ in ((v.clip, 0) for v in self._voices)
                if c is not None}
        self._padded_refs = [
            c for c in self._padded_refs
            if (id(c), new_bucket) in self._padded or id(c) in live
        ]
        self._bucket = new_bucket
        for v in self._voices:
            if v.clip is not None:
                v.sampler.set_sample(
                    self._prepare_padded(v.clip), stop_playback=False
                )
            else:
                v.sampler.set_sample(
                    self._silent(new_bucket), stop_playback=False
                )

    # -- clip preparation ------------------------------------------------------

    def preload(self, *clips: SampleResource) -> None:
        """Pad clips ahead of time (and, with
        ``max_clip_frames=None``, fix the bucket to the longest *now* so
        later plays never grow it)."""
        if clips:
            top = _next_pow2(max(c.len_frames for c in clips))
            if self._bucket is None or top > self._bucket:
                self._grow(top)
        for c in clips:
            self._prepare(c)

    def _prepare(self, clip: SampleResource) -> SampleResource:
        if self._bucket is None or clip.len_frames > self._bucket:
            self._grow(_next_pow2(clip.len_frames))
        return self._prepare_padded(clip)

    def _prepare_padded(self, clip: SampleResource) -> SampleResource:
        key = (id(clip), self._bucket)
        got = self._padded.get(key)
        if got is not None:
            return got
        data = clip.host_data
        ch = self.channels
        if data.shape[0] != ch:
            if data.shape[0] == 1:
                data = np.broadcast_to(data, (ch, data.shape[1]))
            else:  # downmix extra channels equally
                data = np.broadcast_to(
                    data.mean(axis=0, keepdims=True), (ch, data.shape[1])
                )
        pad = self._bucket - data.shape[1]
        if pad:
            data = np.concatenate(
                [data, np.zeros((ch, pad), np.float32)], axis=1
            )
        padded = SampleResource(
            np.ascontiguousarray(data, np.float32),
            sample_rate=clip.sample_rate,
        )
        # bounded cache: a long session streaming many distinct clips
        # must not pin them all forever — evict oldest entries not held
        # by a live voice once past the cap
        if len(self._padded) >= _PADDED_CACHE_CAP:
            live = {id(v.clip) for v in self._voices if v.clip is not None}
            for k in list(self._padded):
                if len(self._padded) < _PADDED_CACHE_CAP:
                    break
                if k[0] not in live and k != key:
                    del self._padded[k]
            kept = {k[0] for k in self._padded}
            self._padded_refs = [
                c for c in self._padded_refs if id(c) in kept
            ]
        self._padded[key] = padded
        self._padded_refs.append(clip)
        return padded

    # -- allocation ------------------------------------------------------------

    def _now(self) -> float:
        return float(self._clock()) if self._clock is not None else 0.0

    def _alloc(self, now: float, priority: int) -> Optional[_Voice]:
        free = [v for v in self._voices if v.busy_until <= now]
        if free:
            # oldest-finished first: spreads wear, maximizes declick slack
            return min(free, key=lambda v: v.busy_until)
        victim = min(self._voices, key=lambda v: (v.priority, v.started_at))
        if victim.priority > priority:
            return None  # everything live outranks the new sound
        return victim

    def play(
        self,
        clip: SampleResource,
        *,
        gain_db: float = 0.0,
        pan: float = 0.0,
        rate: float = 1.0,
        loop: bool = False,
        priority: int = 0,
        when: int | None = None,
        now: int | None = None,
        attack_secs: float | None = None,
    ) -> Optional[VoiceHandle]:
        """Fire a clip.  Returns a :class:`VoiceHandle`, or ``None`` when
        every voice is busy with strictly higher priority (the sound is
        dropped — the policy a game wants for footstep #65).

        ``when``: absolute stream sample for a sample-accurate trigger
        (rides the per-block timelines; omit for "next dispatch").  Like
        every scheduled command it quantizes to the START of its
        enclosing render block (``SamplerNode.play`` semantics) — pass
        block-aligned times for exact starts.
        Prefer a ``when`` at least one block out: the voice is then
        silence-masked for a block first, which lets the pan smoother
        SNAP to the new position (pan state resets under silent input)
        instead of gliding 10 ms from the voice's previous pan.
        ``now``: current stream sample for freeness accounting; taken
        from ``clock`` when bound, else defaults to ``when`` or 0.
        """
        if now is None:
            now = (
                self._clock()
                if self._clock is not None
                else (when if when is not None else 0)
            )
        now = float(now)
        v = self._alloc(now, int(priority))
        if v is None:
            return None
        padded = self._prepare(clip)

        v.gen = self._gen_counter = self._gen_counter + 1
        v.priority = int(priority)
        v.clip = clip
        trigger = float(when) if when is not None else now
        v.started_at = trigger

        s = v.sampler
        # A stolen/reused voice may still hold scheduled commands from
        # its previous owner; any command at or after the NEW trigger
        # (e.g. a handle's long-delayed stop) would fire into the new
        # sound — drop those.  Commands strictly before the trigger stay:
        # they belong to a legitimately sequenced earlier shot on this
        # voice (scheduling two future shots on one voice is supported —
        # with the caveat, inherent to one-sample-per-voice, that both
        # shots play the voice's CURRENT clip).
        cutoff = int(when) if when is not None else int(now)
        s._scheduled = [c for c in s._scheduled if c[0] < cutoff]
        s.set_sample(padded)  # stops + rewinds the stolen voice
        s.set_percent_volume(_db_to_percent(gain_db))
        s.set_playback_rate(rate)
        s.set_envelope(
            attack_secs if attack_secs is not None else 0.0,
            self.declick_secs,
        )
        if loop:
            # loop over the TRUE clip, not the zero-pad tail
            clip_sr = clip.sample_rate or float(s._sample_rate)
            s.set_loop_range(
                LoopRange.range_secs(0.0, clip.len_frames / clip_sr)
            )
        else:
            s.set_loop_range(None)
        if v.pan is not None:
            v.pan.set_pan(pan)
        if when is None:
            s.play()
        else:
            # re-triggering a voice whose previous one-shot ended is safe
            # without a falling edge: play() is a message (play_seq), the
            # seq edge clears the `ended` latch at the trigger block
            s.play(at_sample=int(when))

        if loop or rate <= 0.0:
            v.busy_until = _INF
        else:
            # duration in STREAM samples: clip frames at clip rate,
            # resampled to the stream rate, stretched by 1/rate.  The
            # PADDED length is used — the device voice renders (silent)
            # pad tail too, and freeing only after it keeps "free" ==
            # "safe to retarget without cutting a tail".  Conservative by
            # the pad, never early.
            stream_sr = float(s._sample_rate)
            clip_sr = clip.sample_rate or stream_sr
            dur = math.ceil(
                self._bucket * (stream_sr / clip_sr) / float(rate)
            )
            v.busy_until = trigger + dur
        return VoiceHandle(self, self._voices.index(v), v.gen)

    # -- event routing ----------------------------------------------------------

    def finished_handles(self, events) -> list:
        """Translate a ``poll_events()`` batch into the
        :class:`VoiceHandle`\\ s of pool voices whose one-shot playback
        finished on-device (``core/events.py``)::

            for h in pool.finished_handles(cx.poll_events()):
                game.on_sfx_done(h)

        Device truth, not the host estimate ``busy_until`` uses — a voice
        whose rate was doppler-shifted mid-flight reports its REAL finish.
        Events aggregate between polls: a voice re-targeted since its
        finish still reports once (the handle carries the voice's CURRENT
        generation — check ``h.alive()`` if the distinction matters)."""
        by_id = {v.node_id: i for i, v in enumerate(self._voices)}
        out = []
        for e in events:
            if e.name != "finished":
                continue
            i = by_id.get(e.node_id)
            if i is not None:
                out.append(VoiceHandle(self, i, self._voices[i].gen))
        return out

    # -- pool-wide control ------------------------------------------------------

    def stop_all(self, at_sample: int | None = None) -> None:
        for v in self._voices:
            # pending scheduled plays must not out-live a stop-all
            v.sampler.cancel_scheduled()
            v.sampler.stop(at_sample=at_sample)
            v.busy_until = float(at_sample) if at_sample is not None else 0.0
            v.gen = self._gen_counter = self._gen_counter + 1

    def active_voices(self, now: int | None = None) -> int:
        t = float(now) if now is not None else self._now()
        return sum(1 for v in self._voices if v.busy_until > t)

    @property
    def bucket_frames(self) -> Optional[int]:
        """Current shared clip shape (frames), or None before first use."""
        return self._bucket
