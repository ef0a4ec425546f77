"""Audio format loading: a pluggable decoder registry.

Reference scope: "Support for loading a wide variety of audio formats (using
Symphonia)" (``DESIGN_DOC.md:32``; the reference never wired a decoder).
The Symphonia analog here is a *registry*: built-in decoders for the formats
the environment can read without third-party code (WAV incl. IEEE-float and
the IMA/MS ADPCM game-asset flavors — ``utils/adpcm.py`` — AIFF, AU, FLAC —
``core/flac.py``), and :func:`register_format` for plugging any external
decoder (ffmpeg wrapper, miniaudio binding, a network codec, ...).

``load_audio(path)`` → :class:`SampleResource` ready for the sampler.

Compressed formats: FLAC decodes in-tree (pure NumPy, ``core/flac.py``);
MP3 binds the system codec pair libmpg123/libmp3lame through ``ctypes``
(``utils/mp3.py``) and registers only when the library is present, and
Ogg Vorbis binds libvorbisfile/libvorbisenc the same way
(``utils/vorbis.py``) — so the practical game-audio cases (compressed
music beds) load with zero third-party Python code.

A parallel registry serves *streaming*: :func:`open_stream_reader(path)`
returns a windowed reader (the ``num_channels / sample_rate /
len_frames / read(start, n)`` protocol consumed by
:class:`StreamingSamplerNode` and :class:`MusicPlayer`) without loading
the whole file; :func:`register_stream_reader` extends it.
"""

from __future__ import annotations

import os
from typing import Callable

import numpy as np

from .sample_resource import SampleResource

__all__ = [
    "load_audio",
    "register_format",
    "supported_formats",
    "open_stream_reader",
    "register_stream_reader",
    "supported_stream_formats",
    "as_stream_reader",
    "read_window",
]

# ext (lowercase, with dot) → loader(path) -> (f32[ch, frames], sample_rate)
_LOADERS: dict[str, Callable] = {}

# ext → reader_factory(path) -> stream-reader protocol object
_STREAM_READERS: dict[str, Callable] = {}


def register_format(extensions, loader: Callable) -> None:
    """Register ``loader(path) -> (f32[channels, frames], sample_rate)`` for
    the given extension(s)."""
    if isinstance(extensions, str):
        extensions = [extensions]
    for ext in extensions:
        _LOADERS[ext.lower() if ext.startswith(".") else "." + ext.lower()] = (
            loader
        )


def supported_formats() -> list[str]:
    return sorted(_LOADERS)


def register_stream_reader(extensions, factory: Callable) -> None:
    """Register ``factory(path) -> reader`` for the given extension(s),
    where ``reader`` satisfies the windowed stream protocol
    (``num_channels``, ``sample_rate``, ``len_frames``,
    ``read(start_frame, num_frames) -> f32[ch, n]`` with zero-padding
    outside ``[0, len_frames)``, and ``close()``)."""
    if isinstance(extensions, str):
        extensions = [extensions]
    for ext in extensions:
        _STREAM_READERS[
            ext.lower() if ext.startswith(".") else "." + ext.lower()
        ] = factory


def supported_stream_formats() -> list[str]:
    return sorted(_STREAM_READERS)


def open_stream_reader(path: str):
    """Open ``path`` for windowed streaming (no full decode, no device
    upload) → a stream-reader for :class:`StreamingSamplerNode` /
    :class:`MusicPlayer` decks."""
    ext = os.path.splitext(path)[1].lower()
    factory = _STREAM_READERS.get(ext)
    if factory is None:
        raise ValueError(
            f"no stream reader registered for {ext!r}; supported: "
            f"{supported_stream_formats()} (register_stream_reader to "
            "extend, or load_audio for whole-file decode)"
        )
    return factory(path)


def read_window(len_frames: int, num_channels: int, start_frame: int,
                num_frames: int, decode) -> np.ndarray:
    """The stream-reader protocol's windowing contract, implemented once.

    Wraps ``decode(start, count) -> f32 [num_channels, got<=count]``
    (called only with an in-range span) with the shared edge handling:
    ``num_frames <= 0`` and starts at/after EOF return silence; negative
    starts pre-roll — leading zeros at the correct positions, not
    time-shifted audio; EOF-short decodes zero-pad the tail.  Matches
    ``WavStreamReader`` semantics; every built-in codec reader routes
    through here so the contract can't drift between them."""
    start = int(start_frame)
    n = int(num_frames)
    out = np.zeros((num_channels, n), np.float32)
    if n <= 0 or start >= len_frames:
        return out
    a = max(start, 0)
    end = min(start + n, len_frames)
    if end <= a:
        return out
    got = decode(a, end - a)
    g = min(got.shape[1], end - a)
    out[:, a - start:a - start + g] = got[:, :g]
    return out


def as_stream_reader(source):
    """Coerce ``source`` to a stream reader: a path (str / PathLike)
    opens through :func:`open_stream_reader`; anything else (already a
    reader) passes through untouched.  The convenience layer behind
    ``MusicPlayer.play("bed.mp3")`` / ``StreamingSamplerNode("a.flac")``."""
    if isinstance(source, (str, os.PathLike)):
        return open_stream_reader(os.fspath(source))
    return source


def load_audio(path: str, device: bool = True):
    """Decode an audio file → ``(SampleResource, sample_rate)``."""
    ext = os.path.splitext(path)[1].lower()
    loader = _LOADERS.get(ext)
    if loader is None:
        raise ValueError(
            f"no decoder registered for {ext!r}; supported: "
            f"{supported_formats()} (register_format to extend)"
        )
    audio, sample_rate = loader(path)
    # the resource carries its native rate, so samplers auto-convert when
    # the stream runs at a different rate (SampleResource.sample_rate)
    return (
        SampleResource(
            np.asarray(audio, np.float32),
            sample_rate=float(sample_rate),
            device=device,
        ),
        int(sample_rate),
    )


# -- built-in decoders --------------------------------------------------------

def _load_wav(path):
    from ..utils.wav import read_wav

    return read_wav(path)


def _pcm_bytes_to_f32(raw: bytes, sampwidth: int, big_endian: bool) -> np.ndarray:
    if sampwidth == 1:
        # Both callers are AIFF and AU, whose 8-bit sample points are
        # SIGNED two's complement (unlike WAV's unsigned u8, decoded in
        # utils/wav.py) — decoding as unsigned would offset the waveform
        # by half-scale and wrap it.
        return np.frombuffer(raw, np.int8).astype(np.float32) / 127.0
    if sampwidth == 2:
        dt = ">i2" if big_endian else "<i2"
        return np.frombuffer(raw, dt).astype(np.float32) / 32767.0
    if sampwidth == 3:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        if big_endian:
            val = (
                (b[:, 0].astype(np.int32) << 16)
                | (b[:, 1].astype(np.int32) << 8)
                | b[:, 2]
            )
        else:
            val = (
                (b[:, 2].astype(np.int32) << 16)
                | (b[:, 1].astype(np.int32) << 8)
                | b[:, 0]
            )
        val = (val ^ 0x800000) - 0x800000  # sign-extend 24-bit
        return val.astype(np.float32) / 8388607.0
    if sampwidth == 4:
        dt = ">i4" if big_endian else "<i4"
        return np.frombuffer(raw, dt).astype(np.float32) / 2147483647.0
    raise ValueError(f"unsupported sample width {sampwidth}")


def _load_aiff(path):
    import aifc

    with aifc.open(path, "rb") as f:
        ch = f.getnchannels()
        sr = int(f.getframerate())
        n = f.getnframes()
        raw = f.readframes(n)
        flat = _pcm_bytes_to_f32(raw, f.getsampwidth(), big_endian=True)
    return flat.reshape(n, ch).T.copy(), sr


def _load_au(path):
    try:
        import sunau
    except ImportError as e:  # pragma: no cover (removed in py3.13)
        raise ValueError("AU decoding unavailable on this Python") from e

    with sunau.open(path, "rb") as f:
        ch = f.getnchannels()
        sr = int(f.getframerate())
        n = f.getnframes()
        raw = f.readframes(n)
        flat = _pcm_bytes_to_f32(raw, f.getsampwidth(), big_endian=True)
    return flat.reshape(n, ch).T.copy(), sr


register_format([".wav", ".wave"], _load_wav)
try:  # aifc exists through py3.12 (removed in 3.13)
    import aifc as _aifc  # noqa: F401

    register_format([".aif", ".aiff", ".aifc"], _load_aiff)
except ImportError:  # pragma: no cover
    pass
try:  # sunau exists through py3.12
    import sunau as _sunau  # noqa: F401

    register_format([".au", ".snd"], _load_au)
except ImportError:  # pragma: no cover
    pass


def _load_flac(path):
    from .flac import decode_flac

    return decode_flac(path)


register_format([".flac"], _load_flac)


def _load_mp3(path):
    from ..utils.mp3 import decode_mp3

    return decode_mp3(path)


def _load_vorbis(path):
    from ..utils.vorbis import decode_vorbis

    return decode_vorbis(path)


try:  # MP3 rides the system libmpg123; skip the ext when it's absent
    from ..utils.mp3 import available as _mp3_available

    if _mp3_available()["decode"]:
        register_format([".mp3"], _load_mp3)
except Exception:  # pragma: no cover - optional system dependency
    pass

try:  # Ogg Vorbis rides the system libvorbisfile
    from ..utils.vorbis import available as _vorbis_available

    if _vorbis_available()["decode"]:
        register_format([".ogg", ".oga"], _load_vorbis)
except Exception:  # pragma: no cover - optional system dependency
    pass


def _load_opus(path):
    from ..utils.opus import decode_opus

    return decode_opus(path)


try:  # Ogg Opus: in-tree Ogg demux + the system libopus codec
    from ..utils.opus import available as _opus_available

    if _opus_available()["decode"]:
        register_format([".opus"], _load_opus)
except Exception:  # pragma: no cover - optional system dependency
    pass


# -- built-in stream readers ---------------------------------------------------

def _open_wav_stream(path):
    from ..utils.wav import WavStreamReader

    return WavStreamReader(path)


def _open_flac_stream(path):
    from .flac import FlacStreamReader

    return FlacStreamReader(path)


def _open_mp3_stream(path):
    from ..utils.mp3 import Mp3StreamReader

    return Mp3StreamReader(path)


def _open_vorbis_stream(path):
    from ..utils.vorbis import VorbisStreamReader

    return VorbisStreamReader(path)


def _open_opus_stream(path):
    from ..utils.opus import OpusStreamReader

    return OpusStreamReader(path)


register_stream_reader([".wav", ".wave"], _open_wav_stream)
register_stream_reader([".flac"], _open_flac_stream)
try:
    if _opus_available()["decode"]:
        register_stream_reader([".opus"], _open_opus_stream)
except Exception:  # pragma: no cover
    pass
try:
    if _mp3_available()["decode"]:
        register_stream_reader([".mp3"], _open_mp3_stream)
except Exception:  # pragma: no cover
    pass
try:
    if _vorbis_available()["decode"]:
        register_stream_reader([".ogg", ".oga"], _open_vorbis_stream)
except Exception:  # pragma: no cover
    pass
