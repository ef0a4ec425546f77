"""The port's audio formats (``firewheel_tpu_torch/core/{formats,flac,
ranges}.py``, ``utils/{wav,flac_encode,mp3,vorbis,opus}.py``) held against
the JAX package's copies on the CPU.

The files are written once from a numpy seed and decoded by both packages:
every decode is bit for bit the JAX package's, FLAC with its STREAMINFO MD5
verified; ``encode_flac`` writes the same bytes; the native CRC and LPC
kernels (``backend/native``) build into the port's library and agree with
the Python loops; the codec bindings give the same ``available()``
answers; and the parameter ranges map tensors as numpy maps arrays.
"""

import aifc
import sunau

import numpy as np
import pytest
import torch

from firewheel_tpu.core import flac as jflac
from firewheel_tpu.core import formats as jfmt
from firewheel_tpu.utils import flac_encode as jenc
from firewheel_tpu.utils import mp3 as jmp3, opus as jopus, vorbis as jvorbis
from firewheel_tpu.utils import wav as jwav
from firewheel_tpu_torch.core import flac as tflac
from firewheel_tpu_torch.core import formats as tfmt
from firewheel_tpu_torch.core import ranges as tranges
from firewheel_tpu_torch.utils import flac_encode as tenc
from firewheel_tpu_torch.utils import mp3 as tmp3, opus as topus, vorbis as tvorbis
from firewheel_tpu_torch.utils import wav as twav

SR = 48000


def make_audio(frames, channels=2, seed=7, level=0.4):
    rng = np.random.default_rng(seed)
    t = np.arange(frames, dtype=np.float64)
    tone = np.stack([np.sin(2 * np.pi * (180.0 * (c + 1)) * t / SR)
                     for c in range(channels)])
    noise = rng.standard_normal((channels, frames)) * 0.02
    return (level * tone + noise).astype(np.float32)


def decode_both(path):
    """``load_audio`` in both packages: the same samples and rate."""
    (j, jsr), (t, tsr) = (m.load_audio(path, device=False) for m in (jfmt, tfmt))
    assert tsr == jsr and t.sample_rate == j.sample_rate
    np.testing.assert_array_equal(t.host_data, j.host_data)
    return t.host_data, tsr


@pytest.mark.parametrize("dtype", ["f32", "i16", "ima", "ms"])
def test_wav_decode_matches_jax(tmp_path, dtype):
    a = make_audio(3000)
    path = str(tmp_path / f"x-{dtype}.wav")
    twav.write_wav(path, a, SR, dtype=dtype)
    with open(path, "rb") as f:
        mine = f.read()
    jwav.write_wav(str(tmp_path / "j.wav"), a, SR, dtype=dtype)
    with open(tmp_path / "j.wav", "rb") as f:
        assert f.read() == mine
    got, sr = decode_both(path)
    assert sr == SR
    # the ADPCM flavours are lossy: 4 bits a sample
    tol = {"f32": 0, "i16": 1e-4, "ima": 0.1, "ms": 0.1}[dtype]
    np.testing.assert_allclose(got, a, atol=tol)


@pytest.mark.parametrize("width", [1, 2, 3, 4])
def test_aiff_and_au_decode_match_jax(tmp_path, width):
    rng = np.random.default_rng(width)
    lim = 1 << (8 * width - 1)
    pcm = rng.integers(-lim, lim, size=(500, 2), dtype=np.int64)
    raw = b"".join(int(v).to_bytes(width, "big", signed=True) for v in pcm.ravel())
    for ext, mod in ((".aiff", aifc), (".au", sunau)):
        path = str(tmp_path / f"x{width}{ext}")
        with mod.open(path, "wb") as f:
            f.setnchannels(2)
            f.setsampwidth(width)
            f.setframerate(22050)
            f.writeframes(raw)
        got, sr = decode_both(path)
        assert sr == 22050 and got.shape == (2, 500)


# The JAX registries' built-in entries, read when this module is imported.
# Collection imports every test module before any test runs in a worker, so
# these are the entries the JAX package registers itself: two of its own
# tests (``tests/test_codecs.py``, ``tests/test_formats.py``) register
# ``.dummy`` and ``.fake`` into the live dicts and leave them there.
JAX_FORMATS = jfmt.supported_formats()
JAX_STREAM_FORMATS = jfmt.supported_stream_formats()


def test_registry_and_custom_decoders(tmp_path):
    assert tfmt.supported_formats() == JAX_FORMATS
    assert tfmt.supported_stream_formats() == JAX_STREAM_FORMATS
    p = str(tmp_path / "x.xyz")
    open(p, "wb").write(b"\xff\xfb")
    with pytest.raises(ValueError, match="no decoder registered"):
        tfmt.load_audio(p)
    with pytest.raises(ValueError, match="no stream reader registered"):
        tfmt.open_stream_reader(p)
    jax_before = jfmt.supported_formats()
    tfmt.register_format(".fake", lambda path: (np.ones((1, 100), np.float32) * 0.25, 8000))
    try:
        q = str(tmp_path / "x.fake")
        open(q, "w").write("")
        res, sr = tfmt.load_audio(q)
        assert sr == 8000 and isinstance(res.data, torch.Tensor)
        assert (res.data == 0.25).all()
        assert jfmt.supported_formats() == jax_before
    finally:
        del tfmt._LOADERS[".fake"]


@pytest.mark.parametrize("bits,channels,block", [(16, 2, 4096), (24, 2, 1024),
                                                  (8, 1, 576), (16, 3, 4096)])
def test_flac_encode_bytes_and_decode_bit_exact(tmp_path, bits, channels, block):
    """``encode_flac`` writes JAX's bytes; both decoders give the same
    samples, the MD5 verified, equal to the PCM that went in."""
    audio = make_audio(7777, channels=channels, seed=bits)
    tpath, jpath = str(tmp_path / "t.flac"), str(tmp_path / "j.flac")
    tenc.encode_flac(audio, SR, bits=bits, block_size=block, path=tpath)
    jenc.encode_flac(audio, SR, bits=bits, block_size=block, path=jpath)
    with open(tpath, "rb") as f, open(jpath, "rb") as g:
        assert f.read() == g.read()
    (t, tsr), (j, jsr) = (tflac.decode_flac(tpath, verify_md5=True),
                          jflac.decode_flac(tpath, verify_md5=True))
    assert tsr == jsr == SR
    np.testing.assert_array_equal(t, j)
    scale = float(1 << (bits - 1))
    pcm = np.clip(np.rint(audio.astype(np.float64) * scale), -scale, scale - 1)
    np.testing.assert_array_equal(np.rint(t.astype(np.float64) * scale), pcm)
    decode_both(tpath)


def test_flac_stream_reader_matches_jax(tmp_path):
    audio = make_audio(SR // 2)
    path = str(tmp_path / "clip.flac")
    tenc.encode_flac(audio, SR, block_size=1024, path=path)
    t, j = tflac.FlacStreamReader(path, cache_frames=4), jflac.FlacStreamReader(path, cache_frames=4)
    assert (t.num_channels, t.len_frames, t.sample_rate) == (2, SR // 2, SR)
    for start, n in ((0, 100), (100, 3000), (5000, 4096), (50, 500), (-100, 5000),
                     (SR // 2 - 10, 64), (SR, 16)):
        np.testing.assert_array_equal(t.read(start, n), j.read(start, n))
    assert isinstance(tfmt.open_stream_reader(path), tflac.FlacStreamReader)


def test_flac_native_kernels_match_python(tmp_path):
    """The CRCs and the LPC recurrence from ``backend/native/{crc,lpc}.cpp``
    (built into the port's library) against the Python loops."""
    assert tflac._native_crc() is not None and tflac._native_lpc() is not None
    rng = np.random.default_rng(5)
    data = bytes(rng.integers(0, 256, 4097, dtype=np.int64).astype(np.uint8))
    lib = tflac._native_crc()
    for fn, tbl, width in ((lib.flac_crc8, tflac._CRC8_TBL, 8),
                           (lib.flac_crc16, tflac._CRC16_TBL, 16)):
        c = 0
        for b in data:
            c = (int(tbl[(c ^ b) & 0xFF]) if width == 8 else
                 (int(tbl[((c >> 8) ^ b) & 0xFF]) ^ ((c << 8) & 0xFFFF)) & 0xFFFF)
        assert int(fn(data, len(data), 0)) == c
        assert c == (jflac.crc8(data) if width == 8 else jflac.crc16(data))
    warm = np.array([100, -50, 25], np.int64)
    coeffs = [1200, -600, 150]
    resid = rng.integers(-300, 300, 2000).astype(np.int64)
    native = tflac._undo_lpc(warm, coeffs, 10, resid)
    saved, tflac._NATIVE_LPC = tflac._NATIVE_LPC, None
    try:
        python = tflac._undo_lpc(warm, coeffs, 10, resid)
    finally:
        tflac._NATIVE_LPC = saved
    np.testing.assert_array_equal(native, python)
    np.testing.assert_array_equal(native, jflac._undo_lpc(warm, coeffs, 10, resid))


def test_codec_bindings_answer_as_jax():
    assert tmp3.available() == jmp3.available()
    assert tvorbis.available() == jvorbis.available()
    assert topus.available() == jopus.available()


@pytest.mark.skipif(not jvorbis.available()["encode"] or not jvorbis.available()["decode"],
                    reason="the system has no libvorbis")
def test_vorbis_and_opus_decode_match_jax(tmp_path):
    """Where the system has the codecs: a file encoded once decodes to the
    same samples in both packages, whole and windowed."""
    audio = make_audio(SR // 2)
    ogg = str(tmp_path / "x.ogg")
    tvorbis.encode_vorbis(ogg, audio, SR)
    decode_both(ogg)
    t, j = tfmt.open_stream_reader(ogg), jfmt.open_stream_reader(ogg)
    np.testing.assert_array_equal(t.read(1000, 3000), j.read(1000, 3000))
    if topus.available()["encode"] and topus.available()["decode"]:
        op = str(tmp_path / "x.opus")
        topus.encode_opus(op, audio, SR)
        decode_both(op)


def test_ranges_map_tensors_as_numpy():
    x = np.linspace(-0.2, 1.2, 57).astype(np.float32)
    cases = (
        (tranges.LinearRange(-1.0, 2.0), "clamp"),
        (tranges.LinearRange(3.0, 1.0), "clamp"),
        (tranges.NormToFreqRange(20.0, 20000.0), "to_hz"),
        (tranges.NormToPowRange(0.0, 10.0, 2.0), "to_dsp"),
    )
    for rng, fn in cases:
        want = getattr(rng, fn)(x)
        got = getattr(rng, fn)(torch.from_numpy(x))
        assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
        assert isinstance(want, np.ndarray)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
