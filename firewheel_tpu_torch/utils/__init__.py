"""Host-side helpers copied from the JAX package (numpy only): WAV IO, the
FLAC encoder, the system-codec bindings (MP3, Ogg Vorbis, Ogg Opus), the
resampler and IMA/MS ADPCM."""

from .wav import read_wav, write_wav
from . import mp3, opus, vorbis
from .flac_encode import encode_flac
from .resample import resample

__all__ = [
    "read_wav",
    "mp3",
    "opus",
    "vorbis",
    "encode_flac",
    "resample",
    "write_wav",
]
