"""Music system demo on the port: gapless sequencing + crossfades over
disk tracks.

Generates three short "tracks" as WAV files, streams them through
:class:`~firewheel_tpu_torch.music.MusicPlayer` (two alternating
disk-streaming decks: tracks of any length, no recompile on a track
change), and bounces the session to ``music_demo.wav``:

* the intro plays, the main bed is QUEUED with a 0.5 s equal-power
  crossfade (the transition is armed on the device and lands while the
  host does nothing);
* the bed LOOPS sample-exactly (its length is not a block multiple);
* an "outro" crossfades in live, then fades to silence;
* track completions arrive as device finish events via ``player.poll``;
* the tracks are PASSED AS PATHS in three formats (a WAV intro, a FLAC
  bed, an OGG outro when the system's Vorbis codec can encode and decode,
  else a WAV): the stream registry picks the decoder by extension.

Run:  python -m firewheel_tpu_torch.examples.music_player [outdir]
"""

from __future__ import annotations

import os
import sys
import wave

import numpy as np

from ..backend import FirewheelCtx, StreamConfig, WavSink
from ..core.formats import load_audio
from ..device import DEFAULT_DEVICE
from ..music import MusicPlayer
from ..utils import vorbis as _vorbis
from ..utils.flac_encode import encode_flac

SR = 48000


def write_track(path, freqs, secs, level=0.4):
    """A little chord arpeggio as a 16-bit stereo WAV track."""
    n = int(secs * SR)
    t = np.arange(n) / SR
    sig = np.zeros(n, np.float32)
    step = max(1, n // (4 * len(freqs)))
    for i in range(0, n, step):
        f = freqs[(i // step) % len(freqs)]
        seg = slice(i, min(i + step, n))
        env = np.exp(-3.0 * (t[seg] - t[seg.start]))
        sig[seg] = np.sin(2 * np.pi * f * t[seg]) * env
    sig *= level
    pcm = np.clip(sig * 32767, -32768, 32767).astype("<i2")
    stereo = np.repeat(pcm[:, None], 2, axis=1)
    with wave.open(path, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(stereo.tobytes())


def track_name(reader) -> str:
    """A finished track's name: its file's, else its reader's type (the
    FLAC and OGG decks)."""
    path = getattr(reader, "path", None)
    return os.path.basename(path) if path else type(reader).__name__


def main(outdir: str = ".", device=DEFAULT_DEVICE) -> dict:
    """Write the tracks into ``outdir``, play the session on ``device`` and
    bounce it to ``outdir/music_demo.wav``.  Returns the bounce's path,
    the finished tracks' names in poll order and the outro's format."""
    intro = os.path.join(outdir, "_intro.wav")
    bed = os.path.join(outdir, "_bed.wav")
    outro = os.path.join(outdir, "_outro.wav")
    write_track(intro, [220, 277, 330], 1.0)
    # bed length 0.7 s = 33600 frames, NOT a block multiple: the loop
    # join exercises the sample-exact sub-block start offset
    write_track(bed, [110, 165, 220, 277], 0.7)
    write_track(outro, [330, 277, 220, 165], 1.0)

    # re-encode the bed as FLAC (in-tree codec, always available) and the
    # outro as OGG when the system codec is present: the decks open any
    # registered format by path
    bed_audio = load_audio(bed, device=False)[0].host_data
    flac_bed = os.path.join(outdir, "_bed.flac")
    encode_flac(bed_audio, SR, path=flac_bed)
    os.remove(bed)
    bed = flac_bed
    # playing the .ogg back needs the decoder too (libvorbisfile is a
    # separate package from libvorbisenc on Debian-family systems)
    if _vorbis.available()["encode"] and _vorbis.available()["decode"]:
        out_audio = load_audio(outro, device=False)[0].host_data
        _vorbis.encode_vorbis(outro.replace(".wav", ".ogg"), out_audio, SR)
        os.remove(outro)
        outro = outro.replace(".wav", ".ogg")

    cx = FirewheelCtx(device=device)
    player = MusicPlayer(
        cx.graph_mut(), clock=lambda: cx.stream.frames_rendered
    )
    out_path = os.path.join(outdir, "music_demo.wav")
    cx.activate(StreamConfig(SR, 2, buffer_frames=512),
                sink=WavSink(out_path, SR, 2))

    player.play(intro)  # a PATH: WAV via the stream registry
    player.queue(bed, crossfade_secs=0.5)  # FLAC bed, same API
    finished = []
    for _ in range(8):  # ~2.4 s: intro crossfades into the bed
        cx.render_offline(0.3)
        player.update()
        finished += player.poll(cx.poll_events())
    # switch the bed to a LOOP: re-play it looped (gapless period = len)
    player.play(bed, loop=True)
    for _ in range(6):
        cx.render_offline(0.3)
        player.update()
        finished += player.poll(cx.poll_events())
    # live transition out
    player.crossfade_to(outro, 0.5)  # OGG when the codec is present
    for _ in range(4):
        cx.render_offline(0.3)
        player.update()
        finished += player.poll(cx.poll_events())
    player.stop(fade_secs=0.3)
    cx.render_offline(0.5)
    cx.deactivate()

    print(f"wrote {out_path}")
    print(f"{len(finished)} track-finish events "
          f"(loop iterations each report once)")
    for p in (intro, bed, outro):
        os.remove(p)
    assert len(finished) >= 3
    return {"path": out_path, "finished": [track_name(r) for _, r in finished],
            "outro": os.path.splitext(outro)[1]}


if __name__ == "__main__":
    main(*sys.argv[1:2])
