"""The port's MIDI playback (``firewheel_tpu_torch/utils/midi.py``) held
against the JAX package's copy on the CPU.

``parse_midi`` gives equal songs for the SMF bytes ``tests/test_midi.py``
builds and for the jukebox example's ``demo_song``; the sequencer
schedules the same ``play`` calls (and the same live rate and gain
changes) onto a recording stub pool in both packages.  One fault of the
reference is fixed in the port: an NRPN select (CC 99/98) deselects the
channel's RPN, so a data entry after it leaves the pitch-bend range that
RPN 0,0 set; the JAX parser rewrites the range there, and its test below
pins both outcomes.
"""

import dataclasses
import math

import numpy as np
import pytest

import firewheel_tpu.utils.midi as jmidi
import firewheel_tpu_torch as ft
import firewheel_tpu_torch.utils.midi as tmidi
from examples.midi_jukebox import demo_song
from test_midi import bend, cc, off, on, smf, tempo_meta, track

SR = 48000


def _as_tuple(song):
    return (tuple(map(dataclasses.astuple, song.notes)), song.duration_secs,
            song.ticks_per_quarter, song.tempo_changes, song.format,
            song.num_tracks, song.bend_changes, song.cc_changes)


def _port_song(jsong):
    """The port's ``MidiSong`` with a JAX song's fields."""
    return tmidi.MidiSong(
        notes=[tmidi.MidiNote(*dataclasses.astuple(n)) for n in jsong.notes],
        **{f.name: getattr(jsong, f.name) for f in dataclasses.fields(jsong)
           if f.name != "notes"})


SONGS = {
    "tempo_map": smf([track([(2 * 480, tempo_meta(250_000))]),
                      track([(0, on(0, 60, 100)), (240, off(0, 60)),
                             (240, on(0, 62, 100)), (240, off(0, 62)),
                             (240, on(0, 64, 100)), (240, off(0, 64))])]),
    "running_status": smf([track([(0, on(3, 60, 90)), (120, bytes([62, 80])),
                                  (120, bytes([60, 0])), (120, bytes([62, 0]))])],
                          fmt=0, division=240),
    "program_and_hanging": smf([track([(0, bytes([0xC2, 42])), (0, on(2, 70, 64)),
                                       (480, on(2, 71, 64)), (480, off(2, 71))])],
                               fmt=0),
    "smpte": smf([track([(0, on(0, 60, 100)), (500, off(0, 60))])], fmt=0,
                 division=((256 - 25) << 8) | 40),
    "bend_and_rpn": smf([track([
        (0, bend(0, 8192 + 4096)),
        (480, cc(0, 101, 0)), (0, cc(0, 100, 0)), (0, cc(0, 6, 12)),
        (0, bend(0, 8192 + 4096)), (480, bend(1, 0)),
        (0, on(0, 60, 100)), (480, off(0, 60))])], fmt=0),
    "cc": smf([track([(0, cc(2, 7, 100)), (480, cc(2, 11, 64)), (0, cc(2, 1, 33)),
                      (0, on(2, 60, 100)), (480, off(2, 60))])], fmt=0),
    "demo_song": demo_song(),
}


@pytest.mark.parametrize("name", list(SONGS))
def test_parse_midi_matches_jax(name):
    t, j = tmidi.parse_midi(SONGS[name]), jmidi.parse_midi(SONGS[name])
    assert _as_tuple(t) == _as_tuple(j)
    assert t.notes, name


def test_parse_midi_rejects_what_jax_rejects():
    for data, match in ((b"RIFFxxxx", "MThd"),
                        (smf([track([(0, on(0, 60, 1))])])[:-4], "truncated")):
        for mod in (tmidi, jmidi):
            with pytest.raises(ValueError, match=match):
                mod.parse_midi(data)


def test_nrpn_data_entry_leaves_the_bend_range():
    """RPN 0,0 sets a 12-semitone bend range; an NRPN select (CC 99/98)
    and a data entry follow.  The port keeps the range at 12 (a half-up
    wheel bends +6 st); the JAX parser moves it to the NRPN's 40 (+20 st)."""
    data = smf([track([
        (0, cc(0, 101, 0)), (0, cc(0, 100, 0)), (0, cc(0, 6, 12)),
        (0, cc(0, 99, 1)), (0, cc(0, 98, 5)), (0, cc(0, 6, 40)),
        (0, bend(0, 8192 + 4096)),
        (0, on(0, 60, 100)), (480, off(0, 60))])], fmt=0)
    assert tmidi.parse_midi(data).bend_changes == [(0.0, 0, 6.0)]
    assert jmidi.parse_midi(data).bend_changes == [(0.0, 0, 20.0)]  # the fault
    # a later RPN 0,0 selects the range again
    again = smf([track([
        (0, cc(0, 101, 0)), (0, cc(0, 100, 0)), (0, cc(0, 6, 12)),
        (0, cc(0, 99, 1)), (0, cc(0, 98, 5)), (0, cc(0, 6, 40)),
        (0, cc(0, 101, 0)), (0, cc(0, 100, 0)), (0, cc(0, 6, 4)),
        (0, bend(0, 8192 + 4096))])], fmt=0)
    assert tmidi.parse_midi(again).bend_changes == [(0.0, 0, 2.0)]


class RecordingPool:
    """Records ``play`` calls and each handle's live controls; hands out
    live handle stubs (``tests/test_midi.py``'s fake pools, one class)."""

    num_voices = 8
    sample_rate = SR
    _clock = None

    def __init__(self):
        self.calls, self.live = [], []

    def play(self, clip, **kw):
        idx, rec = len(self.calls), self.live
        self.calls.append((clip.len_frames, kw))

        class H:
            alive = True

            def stop(self_h, at_sample=None):
                rec.append((idx, "stop", at_sample))

            def set_rate(self_h, rate):
                rec.append((idx, "rate", rate))

            def set_gain_db(self_h, db):
                rec.append((idx, "gain", db))

        return H()


def _sequence(mod, sample_resource, song, speed, transpose):
    """Run ``mod``'s sequencer over ``song`` against a stepped clock; every
    call the stub pool saw, and the counters."""
    clip = lambda frames: sample_resource(  # noqa: E731
        np.ones((1, frames), np.float32), sample_rate=SR)
    instruments = {
        0: mod.Instrument(clip(300), root_note=69, gain_db=-6, pan=-0.2),
        1: mod.Instrument(clip(900), root_note=45, sustain=True),
        9: {36: mod.Instrument(clip(64), root_note=36, velocity_curve="square"),
            38: mod.Instrument(clip(80), root_note=38, velocity_curve=None)},
    }
    pool, t = RecordingPool(), [0]
    seq = mod.MidiSequencer(pool, song, instruments, clock=lambda: t[0],
                            horizon_secs=0.25, speed=speed, transpose=transpose)
    seq.start()
    while seq.update():
        t[0] += 4096
    return pool.calls, pool.live, seq.skipped_notes, seq.dropped_notes


@pytest.mark.parametrize("speed,transpose", [(1.0, 0.0), (1.5, -12.0)])
def test_sequencer_schedules_what_jax_schedules(speed, transpose):
    """The demo song with bends and volume changes on its bass channel and
    an unmapped drum key: the same ``play`` calls, stops, live rate and
    gain changes and counts."""
    song = tmidi.parse_midi(SONGS["demo_song"])
    bent = dataclasses.replace(
        song, bend_changes=[(0.5, 1, 1.0), (1.2, 1, -0.5)],
        cc_changes=[(0.0, 1, 7, 100), (0.9, 1, 11, 64)],
        notes=song.notes + [tmidi.MidiNote(0.3, 0.1, 40, 100, 9, 0, 2)])
    bent.notes.sort(key=lambda n: (n.time_secs, n.channel, n.note))
    jsong = jmidi.MidiSong(
        notes=[jmidi.MidiNote(*dataclasses.astuple(n)) for n in bent.notes],
        **{f.name: getattr(bent, f.name) for f in dataclasses.fields(bent)
           if f.name != "notes"})
    got = _sequence(tmidi, ft.SampleResource, bent, speed, transpose)
    from firewheel_tpu import SampleResource as JSampleResource
    want = _sequence(jmidi, JSampleResource, jsong, speed, transpose)
    assert got == want
    calls, live, skipped, dropped = got
    assert len(calls) == len(song.notes) and skipped == 1 and dropped == 0
    assert {k for _, k, _ in live} == {"stop", "rate", "gain"}
    assert any(kw["rate"] == pytest.approx(2.0 ** ((43 - 45 + transpose + 1.0) / 12))
               for _, kw in calls)


def test_sequencer_needs_a_clock():
    song = _port_song(jmidi.parse_midi(SONGS["running_status"]))
    with pytest.raises(ValueError, match="clock"):
        tmidi.MidiSequencer(RecordingPool(), song, {})
    assert math.isclose(tmidi.Instrument(None).velocity_db(127), 0.0)


def test_chip_smoke_jukebox_song():
    """``chip_smoke.py`` 15(b)'s song: the example's ``demo_song`` bytes,
    and with its control track the NRPN path, where the parsers part."""
    import chip_smoke

    assert chip_smoke.demo_song() == demo_song()
    data = chip_smoke.demo_song(control=chip_smoke.JUKE_CONTROL)
    bass = lambda song: [s for _, ch, s in song.bend_changes if ch == 1]  # noqa: E731
    assert bass(tmidi.parse_midi(data)) == [1.75, -3.5, 0.0]
    assert bass(jmidi.parse_midi(data)) == [16.0, -32.0, 0.0]  # the range moved to 64
