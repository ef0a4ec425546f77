"""MIDI jukebox on the port: play a Standard MIDI File through a VoicePool.

``parse_midi`` → ``MidiSequencer`` → sample-accurate ``VoicePool``
triggers: an 8-bar two-voice chiptune riff with a drum map, rendered to a
WAV.  With no .mid argument a small riff is assembled in code (this file
doubles as an SMF-writer snippet).

Run:  python -m firewheel_tpu_torch.examples.midi_jukebox [song.mid] [out.wav]
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

from ..backend import ArraySink, FirewheelCtx, StreamConfig
from ..core.sample_resource import SampleResource
from ..device import DEFAULT_DEVICE
from ..graph import AudioGraphConfig
from ..utils.midi import Instrument, MidiSequencer, parse_midi
from ..utils.wav import write_wav
from ..voice_pool import VoicePool

SR = 48000


# -- tiny SMF writer (for the built-in demo song) ----------------------------

def _varlen(v):
    out = [v & 0x7F]
    v >>= 7
    while v:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    return bytes(reversed(out))


def _track(events):
    body = b"".join(_varlen(d) + e for d, e in events)
    body += _varlen(0) + bytes([0xFF, 0x2F, 0x00])
    return b"MTrk" + len(body).to_bytes(4, "big") + body


def demo_song(tpq=480):
    """Two bars of lead + bass + kick/snare at 140 bpm, looped 4x."""
    lead_bar = [64, 67, 71, 67, 72, 71, 67, 64]   # E4 G4 B4 ... (Em arp)
    bass_bar = [40, 40, 43, 47]                    # E2 E2 G2 B2
    eighth, quarter = tpq // 2, tpq

    lead, bass, drums = [], [], []
    lead.append((0, bytes([0xFF, 0x51, 0x03]) + (428_571).to_bytes(3, "big")))
    for bar in range(8):
        for n in lead_bar:
            nn = n + (12 if bar % 4 == 3 else 0)   # lift the 4th bar
            lead.append((0, bytes([0x90, nn, 96])))
            lead.append((eighth - 30, bytes([0x80, nn, 0])))
            lead.append((30, b""))                  # tiny gap
        for n in bass_bar:
            bass.append((0, bytes([0x91, n, 110])))
            bass.append((quarter - 20, bytes([0x81, n, 0])))
            bass.append((20, b""))
        for beat in range(4):
            drum = 36 if beat % 2 == 0 else 38      # kick / snare
            drums.append((0, bytes([0x99, drum, 127])))
            drums.append((quarter, bytes([0x89, drum, 0])))

    def merge_deltas(evs):
        # drop the zero-length spacer events, keeping their time
        out, carry = [], 0
        for d, e in evs:
            if e:
                out.append((d + carry, e))
                carry = 0
            else:
                carry += d
        return out

    head = b"MThd" + (6).to_bytes(4, "big") + (1).to_bytes(2, "big") \
        + (3).to_bytes(2, "big") + tpq.to_bytes(2, "big")
    return head + _track(merge_deltas(lead)) + _track(merge_deltas(bass)) \
        + _track(merge_deltas(drums))


# -- instrument bank (synthesized: swap for sampled clips) --------------------

def synth_clip(freq, secs, kind="pulse", sr=SR):
    t = np.arange(int(secs * sr)) / sr
    if kind == "pulse":
        x = np.sign(np.sin(2 * np.pi * freq * t) + 0.3).astype(np.float32)
    elif kind == "tri":
        x = (2 / np.pi * np.arcsin(np.sin(2 * np.pi * freq * t))).astype(
            np.float32
        )
    elif kind == "noise":
        x = np.random.default_rng(7).standard_normal(len(t)).astype(
            np.float32
        )
    env = np.exp(-t / (secs / 4)).astype(np.float32)
    return SampleResource((0.3 * x * env)[None, :], sample_rate=sr)


def instruments() -> dict:
    """The song's instruments by MIDI channel: a pulse lead (0), a
    triangle bass (1) and the GM percussion channel's drum map (9)."""
    a4 = 440.0
    return {
        0: Instrument(synth_clip(a4, 0.8, "pulse"), root_note=69,
                      gain_db=-6, pan=-0.2),
        1: Instrument(synth_clip(a4 / 4, 1.2, "tri"), root_note=45,
                      gain_db=-3, pan=0.0),
        9: {  # GM percussion channel: per-key drum map
            36: Instrument(synth_clip(55.0, 0.25, "tri"), root_note=36,
                           gain_db=0.0),
            38: Instrument(synth_clip(0.0, 0.15, "noise"), root_note=38,
                           gain_db=-8, pan=0.15),
        },
    }


def main(mid_path: str | None = None, out_path: str | None = None,
         device=DEFAULT_DEVICE) -> dict:
    """Play ``mid_path`` (the demo song when None) on a 24-voice pool on
    ``device`` in 0.1 s steps until 1.5 s after its end, and write the WAV
    ``out_path`` (a file in the temporary directory by default).  Returns
    the WAV's path, the audio, its peak and the notes the sequencer
    dropped and skipped."""
    out_path = out_path or os.path.join(tempfile.gettempdir(), "midi_jukebox.wav")
    song = parse_midi(mid_path if mid_path else demo_song())
    print(f"song: {len(song.notes)} notes, {song.duration_secs:.1f} s, "
          f"{song.num_tracks} tracks, "
          f"tempo {song.tempo_changes[0][1]:.0f} bpm"
          if song.tempo_changes else "(SMPTE timing)")

    cx = FirewheelCtx(AudioGraphConfig(0, 2), device=device)
    pool = VoicePool(cx.graph, num_voices=24, max_clip_frames=1 << 16,
                     clock=lambda: cx.stream.frames_rendered)
    sink = ArraySink()
    cx.activate(StreamConfig(SR, 2), sink=sink)

    seq = MidiSequencer(pool, song, instruments(), horizon_secs=0.5)

    seq.start()
    total = song.duration_secs + 1.5
    rendered = 0.0
    step = 0.1
    while rendered < total:
        seq.update()                    # game-frame cadence
        cx.render_offline(step)
        rendered += step
    cx.update()
    cx.deactivate()

    audio = sink.audio(2)
    write_wav(out_path, audio, SR)
    peak = float(np.abs(audio).max())
    print(f"rendered {rendered:.1f} s → {out_path} (peak {peak:.2f}, "
          f"dropped {seq.dropped_notes}, skipped {seq.skipped_notes})")
    return {"path": out_path, "audio": audio, "peak": peak,
            "dropped": seq.dropped_notes, "skipped": seq.skipped_notes}


def _cli(argv):
    """The example's arguments: ``[song.mid] [out.wav]``."""
    args = [a for a in argv if not a.startswith("--")]
    mid_path = args[0] if args and args[0].endswith(".mid") else None
    out_path = (args[1] if mid_path and len(args) > 1
                else (args[0] if args and not mid_path else None))
    return mid_path, out_path


if __name__ == "__main__":
    main(*_cli(sys.argv[1:]))
