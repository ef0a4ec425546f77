"""Host-side helpers copied from the JAX package (numpy and the standard
library only): WAV IO, the FLAC encoder, the system-codec bindings (MP3,
Ogg Vorbis, Ogg Opus), the resampler, IMA/MS ADPCM, MIDI playback and WAV
streaming over HTTP."""

from .wav import read_wav, write_wav
from . import mp3, opus, vorbis
from .flac_encode import encode_flac
from .midi import Instrument, MidiNote, MidiSequencer, MidiSong, parse_midi
from .net_stream import HttpByteSource, HttpWavStreamReader, SegmentCache
from .resample import resample
from .viz import ascii_graph, schedule_table, to_dot, to_html
from .profiler import annotate, trace

__all__ = [
    "read_wav",
    "mp3",
    "opus",
    "vorbis",
    "encode_flac",
    "Instrument",
    "MidiNote",
    "MidiSequencer",
    "MidiSong",
    "parse_midi",
    "resample",
    "write_wav",
    "HttpByteSource",
    "HttpWavStreamReader",
    "SegmentCache",
    "ascii_graph",
    "schedule_table",
    "to_dot",
    "to_html",
    "annotate",
    "trace",
]
