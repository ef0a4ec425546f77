"""The port's network streaming (``firewheel_tpu_torch/utils/net_stream.py``)
held against the JAX package's copy on the CPU.

``tests/test_net_stream.py``'s cases: a localhost HTTP server with
byte-range support stands in for a CDN, so no network is needed.  Each
reader span is read by both packages' ``HttpWavStreamReader`` and by the
port's disk reader and must be equal bit for bit; the port's
``StreamingSamplerNode`` fed over HTTP renders what it renders from the
file, bit for bit, through ``FirewheelCtx`` on the CPU.
"""

import threading
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

import firewheel_tpu_torch as ft
from firewheel_tpu.utils import net_stream as jnet
from firewheel_tpu_torch.utils.net_stream import (
    HttpByteSource,
    HttpWavStreamReader,
    SegmentCache,
)
from firewheel_tpu_torch.utils.wav import WavStreamReader, write_wav
from test_net_stream import _NoRangeHandler, http_server, make_audio  # noqa: F401

SR = 48000


def test_http_byte_source_and_segment_cache(http_server):  # noqa: F811
    base, files = http_server
    files["/blob"] = bytes(range(256)) * 100  # 25600 bytes
    src = HttpByteSource(base + "/blob")
    assert src.length() == 25600
    assert src.read_range(0, 4) == bytes([0, 1, 2, 3])
    assert src.read_range(255, 3) == bytes([255, 0, 1])
    assert src.read_range(25598, 10) == bytes([254, 255])  # short at EOF
    assert src.read_range(30000, 8) == b""
    with pytest.raises(ValueError):
        HttpByteSource("https://example.com/x")

    files["/big"] = np.arange(100000, dtype=np.uint8).tobytes()
    ref = files["/big"]
    counts = []
    for mod in (jnet, None):
        s = (mod.HttpByteSource if mod else HttpByteSource)(base + "/big")
        cache = (mod.SegmentCache if mod else SegmentCache)(s, segment_bytes=4096,
                                                            max_segments=8)
        assert cache.read(100, 50) == ref[100:150]
        n0 = s.request_count
        assert cache.read(100, 50) == ref[100:150]  # a pure cache hit
        assert s.request_count == n0
        assert cache.read(4090, 20) == ref[4090:4110]  # across segments
        for off in range(0, 32768, 1000):
            assert cache.read(off, 1000) == ref[off:off + 1000]
        counts.append(s.request_count)
    assert counts[0] == counts[1] <= 12


@pytest.mark.parametrize("dtype", ["f32", "i16"])
def test_http_wav_reader_matches_disk_and_jax(http_server, tmp_path, dtype):  # noqa: F811
    base, files = http_server
    audio = make_audio(SR)
    path = str(tmp_path / f"clip_{dtype}.wav")
    write_wav(path, audio, SR, dtype=dtype)
    files[f"/clip_{dtype}.wav"] = open(path, "rb").read()
    net = HttpWavStreamReader(base + f"/clip_{dtype}.wav", segment_bytes=8192)
    jax_net = jnet.HttpWavStreamReader(base + f"/clip_{dtype}.wav", segment_bytes=8192)
    disk = WavStreamReader(path)
    assert ((net.num_channels, net.len_frames, net.sample_rate)
            == (disk.num_channels, disk.len_frames, disk.sample_rate)
            == (jax_net.num_channels, jax_net.len_frames, jax_net.sample_rate))
    for start, n in [(0, 256), (1000, 777), (-64, 128), (SR - 10, 64)]:
        got = net.read(start, n)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, disk.read(start, n))
        np.testing.assert_array_equal(got, jax_net.read(start, n))


def test_rangeless_server_full_download_fallback(tmp_path):
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _NoRangeHandler)
    audio = make_audio(4096)
    path = str(tmp_path / "c.wav")
    write_wav(path, audio, SR)
    srv.files = {"/c.wav": open(path, "rb").read()}
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        net = HttpWavStreamReader(f"http://127.0.0.1:{srv.server_address[1]}/c.wav")
        np.testing.assert_allclose(net.read(0, 4096), audio, atol=1e-7)
        n0 = net.source.request_count  # the whole file came in one response
        net.read(1000, 512)
        assert net.source.request_count == n0
    finally:
        srv.shutdown()
        srv.server_close()


def test_streaming_sampler_over_http(http_server, tmp_path):  # noqa: F811
    """Network-streamed playback on the port equals disk-streamed playback,
    bit for bit, with a window refilled several times."""
    base, files = http_server
    secs = 0.6
    path = str(tmp_path / "clip.wav")
    write_wav(path, make_audio(int(SR * secs)), SR, dtype="i16")
    files["/clip.wav"] = open(path, "rb").read()

    def render(reader):
        cx = ft.FirewheelCtx(device="cpu")
        g = cx.graph_mut()
        smp = g.add_node(0, 2, ft.StreamingSamplerNode(reader, window_secs=0.25))
        g.connect(smp, 0, g.graph_out_node(), 0)
        g.connect(smp, 1, g.graph_out_node(), 1)
        sink = ft.ArraySink()
        cx.activate(ft.StreamConfig(SR, 2, buffer_frames=512, block_frames=128),
                    sink=sink)
        g.node(smp).play()
        cx.render_offline(secs + 0.1)
        cx.deactivate()
        return sink.audio(2)

    net_reader = HttpWavStreamReader(base + "/clip.wav", segment_bytes=65536)
    got = render(net_reader)
    np.testing.assert_array_equal(got, render(WavStreamReader(path)))
    assert float(np.abs(got).max()) > 0.01
    assert net_reader.source.request_count < 30
