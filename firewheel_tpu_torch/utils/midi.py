"""Standard MIDI File playback onto a :class:`~firewheel_tpu_torch.
voice_pool.VoicePool`.

A copy of ``firewheel_tpu/utils/midi.py`` (standard library only), with one
fault of the reference fixed: an NRPN select (CC 99/98) now deselects the
channel's RPN, so a data entry after it no longer rewrites the pitch-bend
range that RPN 0,0 set.

The reference excludes MIDI on the audio-graph level but promises the
capability one layer up: a custom sampler or synthesizer that reads a MIDI
file as input (the reference design document).  This module is that
layer: a dependency-free SMF (Standard MIDI File) parser producing
absolute-time note events, and a :class:`MidiSequencer` that schedules
them onto the pool's sample-accurate trigger timeline
(``VoicePool.play(when=)``), so the notes land on their exact stream
samples whatever the host's ``update()`` cadence, the same look-ahead
scheme the music transport uses.

Mapping (classic sampler semantics):

* pitch — ``rate = 2**((note - root_note)/12)`` on the instrument's clip
  (coupled resampling, i.e. a *sampler* instrument; for stretched pads
  route a :class:`~firewheel_tpu_torch.nodes.granular.GranularSamplerNode`
  yourself);
* velocity — amplitude ``velocity/127`` (``-inf..0 dB``), optionally
  squared (``velocity_curve="square"``) for a more played-in feel;
* sustain — one-shot clips simply ring; ``Instrument(sustain=True)``
  loops the clip and schedules the note-off as a sample-accurate
  ``stop(at_sample=)`` (declick release applies).

Scope: note on/off, tempo map (set-tempo metas, PPQ and SMPTE
divisions), program changes (selectable per-instrument), formats 0/1/2,
running status — plus the musical-minimum controllers:

* **pitch bend** (±``bend range`` semitones, default ±2, RPN 0
  honored; an NRPN select deselects the RPN) — a rate multiplier on the
  channel's voices, applied at note-on exactly and to sounding notes at
  ``update()`` cadence;
* **CC 7 (channel volume) / CC 11 (expression)** — per-channel gain,
  GM curve ``40·log10(v/127)`` dB each (amplitude ∝ (v/127)²),
  0 dB until the channel's first event.

Aftertouch and the remaining controllers stay parsed-past (game
jukebox scope, not a DAW).
"""

from __future__ import annotations

import bisect
import math
from dataclasses import dataclass, field
from typing import Callable, Optional

__all__ = [
    "MidiNote",
    "MidiSong",
    "parse_midi",
    "Instrument",
    "MidiSequencer",
]

_DEFAULT_US_PER_QN = 500_000  # 120 bpm, the SMF default


def _cc_db(value: int) -> float:
    """GM volume/expression curve: amplitude ∝ (v/127)², i.e.
    ``40·log10(v/127)`` dB (MMA GM Developer Guidelines); CC 0 floors
    at the curve's v=1 point (−84 dB — inaudible, not −inf, so a later
    CC ramp-up recovers cleanly)."""
    return 40.0 * math.log10(max(int(value), 1) / 127.0)


def _curve_at(curve, t: float, default: float = 0.0) -> float:
    """Latest value of a sorted ``[(secs, value), ...]`` piecewise-
    constant curve at time ``t`` (``default`` before the first event)."""
    if not curve:
        return default
    i = bisect.bisect_right(curve, (t, float("inf")))
    return curve[i - 1][1] if i else default


@dataclass(frozen=True)
class MidiNote:
    """One note, in absolute seconds (tempo map already applied)."""

    time_secs: float
    duration_secs: float
    note: int  # 0..127, 60 = middle C
    velocity: int  # 1..127
    channel: int  # 0..15 (9 = GM percussion)
    program: int  # GM program active at note-on (0 when never set)
    track: int


@dataclass
class MidiSong:
    notes: "list[MidiNote]"  # sorted by time_secs
    duration_secs: float
    ticks_per_quarter: Optional[int]  # None for SMPTE division
    tempo_changes: "list[tuple[float, float]]"  # (secs, bpm)
    format: int
    num_tracks: int
    #: pitch-bend curve, (secs, channel, semitones) sorted by secs —
    #: already scaled by the channel's bend range (RPN 0; default ±2 st)
    bend_changes: "list[tuple[float, int, float]]" = field(
        default_factory=list)
    #: volume/expression curve, (secs, channel, controller, value) with
    #: controller ∈ {7, 11}, sorted by secs
    cc_changes: "list[tuple[float, int, int, int]]" = field(
        default_factory=list)


class _Reader:
    def __init__(self, data: bytes):
        self.d = data
        self.pos = 0

    def bytes(self, n: int) -> bytes:
        if self.pos + n > len(self.d):
            raise ValueError("truncated MIDI data")
        out = self.d[self.pos : self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.bytes(1)[0]

    def u16(self) -> int:
        b = self.bytes(2)
        return (b[0] << 8) | b[1]

    def u32(self) -> int:
        b = self.bytes(4)
        return (b[0] << 24) | (b[1] << 16) | (b[2] << 8) | b[3]

    def varlen(self) -> int:
        v = 0
        for _ in range(4):
            b = self.u8()
            v = (v << 7) | (b & 0x7F)
            if not b & 0x80:
                return v
        raise ValueError("variable-length quantity longer than 4 bytes")

    @property
    def eof(self) -> bool:
        return self.pos >= len(self.d)


def _tick_to_secs(tick: int, tempo_map: "list[tuple[int, int]]",
                  tpq: int) -> float:
    """Piecewise-linear tick→seconds under a sorted (tick, us_per_qn)
    tempo map whose first entry is (0, default)."""
    secs = 0.0
    for i, (t0, us) in enumerate(tempo_map):
        t1 = tempo_map[i + 1][0] if i + 1 < len(tempo_map) else None
        if t1 is not None and tick >= t1:
            secs += (t1 - t0) * us * 1e-6 / tpq
        else:
            secs += (tick - t0) * us * 1e-6 / tpq
            break
    return secs


def parse_midi(src) -> MidiSong:
    """Parse an SMF from a path or ``bytes`` into absolute-time notes.

    Raises ``ValueError`` on malformed data.  Zero-velocity note-ons are
    note-offs (running-status idiom); a note left hanging at track end
    closes there.
    """
    if isinstance(src, (bytes, bytearray)):
        data = bytes(src)
    else:
        with open(src, "rb") as f:
            data = f.read()
    r = _Reader(data)
    if r.bytes(4) != b"MThd":
        raise ValueError("not a MIDI file (missing MThd)")
    hlen = r.u32()
    if hlen < 6:
        raise ValueError("bad MThd length")
    fmt = r.u16()
    ntrks = r.u16()
    division = r.u16()
    r.bytes(hlen - 6)  # spec: ignore header extensions

    smpte = bool(division & 0x8000)
    if smpte:
        fps = 256 - (division >> 8)  # two's complement of the high byte
        tpf = division & 0xFF
        if fps not in (24, 25, 29, 30) or tpf == 0:
            raise ValueError(f"bad SMPTE division 0x{division:04x}")
        tick_secs = 1.0 / (fps * tpf)
        tpq = None
    else:
        tpq = division
        if tpq == 0:
            raise ValueError("ticks-per-quarter of zero")

    # pass 1: split into per-track event lists at absolute ticks, and
    # gather the tempo map (all tracks — format 0/1 keep it in track 0
    # by convention, but files in the wild scatter it)
    tracks: "list[list[tuple[int, int, bytes]]]" = []  # (tick,status,data)
    tempo_ticks: "list[tuple[int, int]]" = []
    while not r.eof:
        tag = r.bytes(4)
        length = r.u32()
        body = _Reader(r.bytes(length))
        if tag != b"MTrk":
            continue  # alien chunk: spec says skip
        events: "list[tuple[int, int, bytes]]" = []
        tick = 0
        status = 0
        while not body.eof:
            tick += body.varlen()
            b0 = body.u8()
            if b0 == 0xFF:  # meta
                mtype = body.u8()
                mlen = body.varlen()
                mdata = body.bytes(mlen)
                if mtype == 0x51 and mlen == 3:
                    us = (mdata[0] << 16) | (mdata[1] << 8) | mdata[2]
                    tempo_ticks.append((tick, us))
                if mtype == 0x2F:
                    break  # end of track
                continue
            if b0 in (0xF0, 0xF7):  # sysex: skip payload
                body.bytes(body.varlen())
                status = 0  # sysex cancels running status
                continue
            if b0 & 0x80:
                status = b0
                d0 = body.u8()
            else:  # running status
                if not status & 0x80:
                    raise ValueError("data byte with no running status")
                d0 = b0
            kind = status & 0xF0
            if kind in (0xC0, 0xD0):  # program change / channel pressure
                events.append((tick, status, bytes([d0])))
            else:  # two-data-byte channel messages
                events.append((tick, status, bytes([d0, body.u8()])))
        tracks.append(events)

    if not smpte:
        tempo_map = sorted(set(tempo_ticks))
        if not tempo_map or tempo_map[0][0] != 0:
            tempo_map.insert(0, (0, _DEFAULT_US_PER_QN))

        def to_secs(tick: int) -> float:
            return _tick_to_secs(tick, tempo_map, tpq)

        tempo_changes = [
            (to_secs(t), 60_000_000.0 / us) for t, us in tempo_map
        ]
    else:
        def to_secs(tick: int) -> float:
            return tick * tick_secs

        tempo_changes = []

    # pass 2: pair note on/off per track (FIFO per channel+note), track
    # program changes chronologically; gather bend/CC events for the
    # global (cross-track — channels are global in SMF) control walk
    notes: "list[MidiNote]" = []
    ctrl_raw: "list[tuple[int, int, int, int, int]]" = []  # tick,ch,kind,d0,d1
    for ti, events in enumerate(tracks):
        open_notes: "dict[tuple[int, int], list]" = {}
        program = [0] * 16
        end_tick = events[-1][0] if events else 0
        for tick, status, d in events:
            kind, ch = status & 0xF0, status & 0x0F
            if kind in (0xB0, 0xE0):
                ctrl_raw.append((tick, ch, kind, d[0], d[1]))
            if kind == 0xC0:
                program[ch] = d[0]
            elif kind == 0x90 and d[1] > 0:  # note on
                open_notes.setdefault((ch, d[0]), []).append(
                    (tick, d[1], program[ch])
                )
            elif kind == 0x80 or (kind == 0x90 and d[1] == 0):  # note off
                stack = open_notes.get((ch, d[0]))
                if stack:
                    t_on, vel, prog = stack.pop(0)
                    notes.append(MidiNote(
                        to_secs(t_on),
                        max(to_secs(tick) - to_secs(t_on), 0.0),
                        d[0], vel, ch, prog, ti,
                    ))
        for (ch, note), stack in open_notes.items():  # hanging notes
            for t_on, vel, prog in stack:
                notes.append(MidiNote(
                    to_secs(t_on),
                    max(to_secs(end_tick) - to_secs(t_on), 0.0),
                    note, vel, ch, prog, ti,
                ))
    notes.sort(key=lambda n: (n.time_secs, n.channel, n.note))
    duration = max(
        (n.time_secs + n.duration_secs for n in notes), default=0.0
    )

    # pass 3: the control walk — chronological across tracks, with the
    # per-channel RPN state machine for bend range (RPN 0,0 = pitch bend
    # sensitivity: data MSB semitones + LSB cents; MMA GM default ±2; an
    # NRPN select returns the channel to the null RPN)
    bend_changes: "list[tuple[float, int, float]]" = []
    cc_changes: "list[tuple[float, int, int, int]]" = []
    bend_range = [2.0] * 16
    rpn = [(0x7F, 0x7F)] * 16  # null RPN
    # stable sort on tick ONLY: same-tick events keep file order (an
    # RPN select must stay ahead of its data entry at the same tick)
    for tick, ch, kind, d0, d1 in sorted(ctrl_raw, key=lambda e: e[0]):
        if kind == 0xE0:
            value = ((d1 << 7) | d0) - 8192  # -8192..8191
            bend_changes.append(
                (to_secs(tick), ch, value / 8192.0 * bend_range[ch])
            )
        elif d0 == 101:  # RPN MSB
            rpn[ch] = (d1, rpn[ch][1])
        elif d0 == 100:  # RPN LSB
            rpn[ch] = (rpn[ch][0], d1)
        elif d0 in (99, 98):  # NRPN MSB/LSB: data entry now targets the
            rpn[ch] = (0x7F, 0x7F)  # NRPN, so the RPN is deselected
        elif d0 == 6 and rpn[ch] == (0, 0):  # data entry MSB: semitones
            bend_range[ch] = float(d1) + (bend_range[ch] % 1.0)
        elif d0 == 38 and rpn[ch] == (0, 0):  # data entry LSB: cents
            bend_range[ch] = float(int(bend_range[ch])) + d1 / 100.0
        elif d0 in (7, 11):
            cc_changes.append((to_secs(tick), ch, d0, d1))

    return MidiSong(notes, duration, tpq, tempo_changes, fmt, ntrks,
                    bend_changes, cc_changes)


@dataclass
class Instrument:
    """A clip played at ``rate = 2**((note-root_note)/12)``.

    ``sustain=True`` loops the clip for the note's written duration and
    stops sample-accurately at note-off (pad/organ semantics); one-shots
    (default) ring their natural length (piano/drum semantics).
    ``velocity_curve``: ``"linear"`` (amplitude ∝ vel/127), ``"square"``
    (∝ (vel/127)²), or ``None`` (ignore velocity).
    """

    clip: object  # SampleResource
    root_note: int = 60
    gain_db: float = 0.0
    pan: float = 0.0
    sustain: bool = False
    velocity_curve: Optional[str] = "linear"
    priority: int = 0

    def velocity_db(self, velocity: int) -> float:
        if self.velocity_curve is None:
            return 0.0
        a = max(int(velocity), 1) / 127.0
        if self.velocity_curve == "square":
            a *= a
        return 20.0 * math.log10(a)


class MidiSequencer:
    """Schedules a :class:`MidiSong` onto a :class:`VoicePool` with
    sample-accurate note starts.

    ::

        pool = VoicePool(g, num_voices=32,
                         clock=lambda: cx.stream.frames_rendered)
        seq = MidiSequencer(pool, parse_midi("level_theme.mid"), {
            0: Instrument(piano_c4, root_note=60),
            9: {36: Instrument(kick), 38: Instrument(snare)},
        })
        seq.start()
        while seq.update():   # call at game-frame cadence
            cx.update(); ...

    Instrument lookup per note: ``instruments[channel][note]`` (a dict
    maps a percussion channel per-key) → ``instruments[channel]`` →
    ``default``; notes with no instrument are skipped (counted in
    ``skipped_notes``).  When an instrument map value is itself keyed by
    *program* (``{(channel, program): ...}``) the note's program-at-on
    selects it.

    ``update()`` schedules every note starting within ``horizon_secs``
    of the pool clock, so any call cadence faster than the horizon is
    sample-exact; it returns False once the song (and its longest ring)
    has fully passed.  ``transpose`` is in semitones; ``speed`` scales
    musical time (1.0 = as written).
    """

    def __init__(
        self,
        pool,
        song: MidiSong,
        instruments: dict,
        *,
        default: Optional[Instrument] = None,
        sample_rate: Optional[float] = None,
        horizon_secs: float = 0.25,
        gain_db: float = 0.0,
        transpose: float = 0.0,
        speed: float = 1.0,
        clock: Optional[Callable[[], int]] = None,
    ):
        if speed <= 0.0:
            raise ValueError("speed must be positive")
        self.pool = pool
        self.song = song
        self.instruments = instruments
        self.default = default
        self.horizon_secs = float(horizon_secs)
        self.gain_db = float(gain_db)
        self.transpose = float(transpose)
        self.speed = float(speed)
        self.skipped_notes = 0
        self.dropped_notes = 0  # pool was full at trigger time
        self._clock = clock if clock is not None else pool._clock
        if self._clock is None:
            raise ValueError(
                "MidiSequencer needs a stream clock: bind the pool's "
                "clock= or pass clock= here"
            )
        sr = sample_rate
        if sr is None:
            sr = getattr(pool, "sample_rate", None)
        self._sr = float(sr) if sr else 48000.0
        self._start_sample: Optional[int] = None
        self._next = 0  # index of the first unscheduled note
        #: (handle, end_sample, channel, base_semitones, base_gain_db) —
        #: base values EXCLUDE bend/CC so live control recomputes cleanly
        self._handles: "list[tuple]" = []
        self._end_sample = 0
        # per-channel piecewise-constant control curves (song seconds)
        self._bend_curve: "dict[int, list[tuple[float, float]]]" = {}
        for secs, ch, semis in song.bend_changes:
            self._bend_curve.setdefault(ch, []).append((secs, semis))
        self._gain_curve: "dict[int, list[tuple[float, float]]]" = {}
        vol: "dict[int, int]" = {}
        expr: "dict[int, int]" = {}
        for secs, ch, cc, val in song.cc_changes:
            (vol if cc == 7 else expr)[ch] = val
            db = _cc_db(vol.get(ch, 127)) + _cc_db(expr.get(ch, 127))
            self._gain_curve.setdefault(ch, []).append((secs, db))
        self._ctrl_channels = set(self._bend_curve) | set(self._gain_curve)
        self._applied: "dict[int, tuple[float, float]]" = {}

    # -- control ----------------------------------------------------------------
    def start(self, at_sample: Optional[int] = None) -> None:
        """Arm playback; note 0 lands at ``at_sample`` (default: one
        horizon ahead of the clock, so the first notes schedule with
        full look-ahead rather than clamping to the render head)."""
        if at_sample is None:
            at_sample = int(self._clock()) + int(
                self.horizon_secs * self._sr
            )
        self._start_sample = int(at_sample)
        self._next = 0
        self._end_sample = self._start_sample
        self.skipped_notes = self.dropped_notes = 0
        self._applied = {}

    def stop(self) -> None:
        """Cancel unscheduled notes and stop sounding sustained ones."""
        self._next = len(self.song.notes)
        now = int(self._clock())
        for h, *_ in self._handles:
            if h.alive:
                h.stop(at_sample=now)
        self._handles.clear()
        self._end_sample = min(self._end_sample, now)

    @property
    def playing(self) -> bool:
        return (
            self._start_sample is not None
            and (self._next < len(self.song.notes)
                 or int(self._clock()) < self._end_sample)
        )

    # -- per-frame pump -----------------------------------------------------------
    def _resolve(self, n: MidiNote) -> Optional[Instrument]:
        inst = self.instruments.get((n.channel, n.program))
        if inst is None:
            inst = self.instruments.get(n.channel)
        if isinstance(inst, dict):
            inst = inst.get(n.note)
        if inst is None:
            inst = self.default
        return inst

    def update(self) -> bool:
        """Schedule notes due within the horizon.  Returns True while
        the song is still playing or ringing."""
        if self._start_sample is None:
            return False
        now = int(self._clock())
        horizon = now + int(self.horizon_secs * self._sr)
        notes = self.song.notes
        while self._next < len(notes):
            n = notes[self._next]
            when = self._start_sample + int(
                round(n.time_secs / self.speed * self._sr)
            )
            if when > horizon:
                break
            self._next += 1
            inst = self._resolve(n)
            if inst is None:
                self.skipped_notes += 1
                continue
            # pitch bend / CC7·CC11 at the note's OWN song time (exact
            # even with look-ahead scheduling); base values kept bend-
            # free so live control below recomputes from them
            base_semi = n.note + self.transpose - inst.root_note
            base_db = (self.gain_db + inst.gain_db
                       + inst.velocity_db(n.velocity))
            bend = _curve_at(self._bend_curve.get(n.channel), n.time_secs)
            cc_db = _curve_at(self._gain_curve.get(n.channel), n.time_secs)
            rate = 2.0 ** ((base_semi + bend) / 12.0)
            h = self.pool.play(
                inst.clip,
                gain_db=base_db + cc_db,
                pan=inst.pan,
                rate=rate,
                loop=inst.sustain,
                priority=inst.priority,
                when=max(when, now),
            )
            if h is None:
                self.dropped_notes += 1
                continue
            dur = int(round(n.duration_secs / self.speed * self._sr))
            note_end = max(when, now) + max(dur, 1)
            if inst.sustain:
                h.stop(at_sample=note_end)
                self._end_sample = max(self._end_sample, note_end)
            else:
                clip_sr = inst.clip.sample_rate or self._sr
                ring = int(math.ceil(
                    inst.clip.len_frames * (self._sr / clip_sr) / rate
                ))
                self._end_sample = max(
                    self._end_sample, max(when, now) + ring
                )
            self._handles.append((h, note_end, n.channel, base_semi,
                                  base_db))
        # live control: apply bend/CC changes to SOUNDING notes at
        # update() cadence (chunk-granular — note-ons above are the
        # sample-exact path; a DAW would automate per-sample, a jukebox
        # tracks the curve between game frames)
        if self._ctrl_channels:
            t_song = max(
                (now - self._start_sample) / self._sr * self.speed, 0.0
            )
            for ch in self._ctrl_channels:
                bend = _curve_at(self._bend_curve.get(ch), t_song)
                cc_db = _curve_at(self._gain_curve.get(ch), t_song)
                if self._applied.get(ch, (0.0, 0.0)) == (bend, cc_db):
                    continue  # neutral/unchanged: no per-voice traffic
                self._applied[ch] = (bend, cc_db)
                for h, _e, hch, bsemi, bdb in self._handles:
                    if hch == ch and h.alive:
                        h.set_rate(2.0 ** ((bsemi + bend) / 12.0))
                        h.set_gain_db(bdb + cc_db)
        # drop dead handles so long songs don't accumulate them
        if len(self._handles) > 4 * self.pool.num_voices:
            self._handles = [
                t for t in self._handles
                if t[1] > now and t[0].alive
            ]
        return self.playing
