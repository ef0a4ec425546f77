"""The port's tooling modules: ``utils/viz.py`` gives the JAX package's
strings for the same graph (``tests/test_viz.py``'s), ``backend/
os_audio.py`` plays and captures through a mocked ``sounddevice``
(``tests/test_os_audio.py``'s cases), and ``utils/profiler.py`` writes a
trace on the CPU."""

import json
import os
import threading
import time

import numpy as np
import pytest

import firewheel_tpu as fw
import firewheel_tpu_torch as ft
from firewheel_tpu.utils import viz as jax_viz
from firewheel_tpu_torch.backend import os_audio
from firewheel_tpu_torch.backend.os_audio import (
    SoundDeviceSink,
    SoundDeviceSource,
    _SPSCRing,
    os_audio_available,
)
from firewheel_tpu_torch.utils import annotate, ascii_graph, schedule_table, to_dot, to_html, trace


def build(pk):
    g = pk.AudioGraph(pk.AudioGraphConfig(0, 2))
    beep = g.add_node(0, 2, pk.nodes.BeepTestNode(440.0, -12.0))
    vol = g.add_node(2, 2, pk.nodes.VolumeNode(100.0))
    g.connect(beep, 0, vol, 0)
    g.connect(beep, 1, vol, 1)
    g.connect(vol, 0, g.graph_out_node(), 0)
    g.connect(vol, 1, g.graph_out_node(), 1)
    return g


# -- viz -------------------------------------------------------------------------------

@pytest.mark.parametrize("render", ["ascii_graph", "to_dot", "to_html", "schedule_table"])
def test_viz_strings_equal_jax(render):
    port_g, jax_g = build(ft), build(fw)
    port_s, jax_s = port_g.compile_internal(128), jax_g.compile_internal(128)
    args = {"ascii_graph": lambda g, s: (g,), "to_dot": lambda g, s: (g, s),
            "to_html": lambda g, s: (g, s), "schedule_table": lambda g, s: (s,)}[render]
    port = getattr(ft.utils, render)(*args(port_g, port_s))
    assert port == getattr(jax_viz, render)(*args(jax_g, jax_s))
    assert port  # and the checks of tests/test_viz.py on the port's string
    if render == "ascii_graph":
        assert all(repr(e.id) in port for e in port_g.nodes())
        assert port.count("-->") == len(list(port_g.edges()))
    elif render == "to_dot":
        assert port.startswith("digraph") and port.rstrip().endswith("}")
        assert port.count("->") == len(list(port_g.edges())) and 'label="b' in port
    elif render == "to_html":
        assert port.startswith("<!DOCTYPE html>") and "<script>" in port
        assert "http" not in port.split("</title>")[1].split("<script>")[0]
    else:
        assert "buffers:" in port
        assert all(repr(sn.id) in port for sn in port_s.schedule)


def test_viz_names_are_the_utils_exports():
    assert (ascii_graph, to_dot, to_html, schedule_table) == (
        ft.utils.viz.ascii_graph, ft.utils.viz.to_dot, ft.utils.viz.to_html,
        ft.utils.viz.schedule_table)


# -- profiler --------------------------------------------------------------------------

def test_trace_writes_a_trace_with_the_annotation(tmp_path):
    import torch

    with trace(str(tmp_path)) as prof:
        with annotate("render-chunk"):
            torch.ones(64).cumsum(0)
    (path,) = list(tmp_path.iterdir())
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert "render-chunk" in names
    assert any(e.key == "render-chunk" for e in prof.key_averages())


def test_annotate_is_a_context_manager():
    region = annotate("x")
    assert hasattr(region, "__enter__") and hasattr(region, "__exit__")
    with annotate("outside-a-trace"):
        pass


# -- os_audio (a mocked sounddevice) ---------------------------------------------------

class _FakeStream:
    """A sounddevice stream stand-in: a thread calling the callback with
    256-frame buffers at ~hardware pace; an input stream delivers a
    positive ramp, an output one collects what the callback wrote."""

    def __init__(self, samplerate, channels, dtype, device, callback, ramp):
        self.callback, self.channels, self.block = callback, channels, 256
        self.ramp, self.delivered, self.collected = ramp, 0, []
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            if self.ramp:
                n = self.block * self.channels
                data = (np.arange(self.delivered + 1, self.delivered + n + 1)
                        .astype(np.float32) * 1e-6).reshape(self.block, self.channels)
                self.callback(data, self.block, None, None)
                self.delivered += n
            else:
                out = np.empty((self.block, self.channels), np.float32)
                self.callback(out, self.block, None, None)
                self.collected.append(out.copy())
            time.sleep(0.001)

    def start(self):
        self._t.start()

    def stop(self):
        self._stop.set()
        self._t.join(timeout=2)

    def close(self):
        pass


class FakeSD:
    @staticmethod
    def OutputStream(**kw):
        return _FakeStream(**kw, ramp=False)

    @staticmethod
    def InputStream(**kw):
        return _FakeStream(**kw, ramp=True)

    @staticmethod
    def query_devices():
        return [{"name": "fake"}]


def test_ring_push_pop_wraparound_and_empty():
    ring = _SPSCRing(10)
    data = np.arange(25, dtype=np.float32)
    out = np.zeros(25, np.float32)
    done = read = 0
    while read < 25:
        done += ring.push(data[done:])
        read += ring.pop_into(out[read:read + 4])
    np.testing.assert_array_equal(out, data)
    assert _SPSCRing(8).pop_into(np.ones(4, np.float32)) == 0


@pytest.mark.parametrize("cls, channels", [(SoundDeviceSink, 2), (SoundDeviceSource, 1)])
def test_missing_sounddevice_raises_clear_error(monkeypatch, cls, channels):
    monkeypatch.setattr(os_audio, "_load_sounddevice", lambda: None)
    with pytest.raises(RuntimeError, match="sounddevice"):
        cls(48000, channels)
    assert os_audio_available() is False


def test_sink_audio_flows_through_to_device_callback():
    sink = SoundDeviceSink(48000, 2, buffer_secs=0.1, _sd=FakeSD)
    try:
        tone = np.sin(np.linspace(0, 40 * np.pi, 4800)).astype(np.float32)
        interleaved = np.repeat(tone, 2)
        want = interleaved[interleaved != 0.0]
        sink.write(interleaved, 2)
        deadline = time.time() + 3
        while time.time() < deadline:
            # the device thread may not have run its first callback yet
            got = [c.reshape(-1) for c in list(sink._stream.collected)]
            if got and np.count_nonzero(np.concatenate(got)) >= want.shape[0]:
                break
            time.sleep(0.01)
        played = np.concatenate([c.reshape(-1) for c in sink._stream.collected])
        np.testing.assert_array_equal(played[played != 0.0], want)
    finally:
        sink.close()


def test_sink_underflow_counts_when_ring_runs_dry():
    sink = SoundDeviceSink(48000, 2, buffer_secs=0.05, _sd=FakeSD)
    try:
        time.sleep(0.05)
        assert sink.underflow_count == 0  # silence before the first write
        sink.write(np.ones(256, np.float32), 2)
        time.sleep(0.08)
        assert sink.underflow_count > 0
        sink.write(np.ones(48000, np.float32), 2)  # backpressure, no deadlock
    finally:
        sink.close()


def test_source_captured_audio_flows_in_order():
    src = SoundDeviceSource(48000, 2, buffer_secs=0.2, _sd=FakeSD)
    try:
        pulled = []
        deadline = time.time() + 3
        while sum(int(np.count_nonzero(p)) for p in pulled) < 4096 and time.time() < deadline:
            pulled.append(src(128))
            time.sleep(0.001)
        got = np.concatenate(pulled)
        nz = got[got != 0.0]
        assert nz.shape[0] >= 4096
        np.testing.assert_array_equal(nz, np.arange(1, nz.shape[0] + 1).astype(np.float32) * 1e-6)
    finally:
        src.close()


@pytest.mark.parametrize("buffer_secs", [0.5, 0.01])
def test_source_starves_or_overflows_and_counts(buffer_secs):
    """A wide ring read far past the capture zero-fills and counts a
    starve; a tiny ring never read drops the callback's tail and counts
    an overflow."""
    src = SoundDeviceSource(48000, 1, buffer_secs=buffer_secs, _sd=FakeSD)
    try:
        deadline = time.time() + 3
        if buffer_secs > 0.1:
            while not src._started and time.time() < deadline:
                time.sleep(0.005)
            out = src(48000)
            assert out.shape == (48000,) and np.count_nonzero(out) < 48000
            assert src.starve_count >= 1
        else:
            while src.overflow_count == 0 and time.time() < deadline:
                time.sleep(0.01)
            assert src.overflow_count >= 1 and src.latency_frames() <= 480
    finally:
        src.close()


def test_source_feeds_the_port_engine_end_to_end():
    """``SoundDeviceSource`` as the port's ``FirewheelCtx`` input source:
    captured audio passes through a graph to the sink."""
    cx = ft.FirewheelCtx(ft.AudioGraphConfig(num_graph_inputs=2, num_graph_outputs=2),
                         device="cpu")
    g = cx.graph_mut()
    clip = g.add_node(2, 2, ft.nodes.HardClipNode(0.0))
    for c in range(2):
        g.connect(g.graph_in_node(), c, clip, c)
        g.connect(clip, c, g.graph_out_node(), c)
    src = SoundDeviceSource(48000, 2, buffer_secs=1.0, _sd=FakeSD)
    sink = ft.ArraySink()
    try:
        deadline = time.time() + 3
        while src.latency_frames() < 6000 and time.time() < deadline:
            time.sleep(0.01)
        cx.activate(ft.StreamConfig(48000, 2, num_in_channels=2, buffer_frames=256),
                    sink=sink, input_source=src, duration_secs=0.1)
        cx.render_offline(0.1)
        cx.deactivate()
    finally:
        src.close()
    got = sink.audio(2)
    inter = np.empty(got.size, np.float32)
    inter[0::2], inter[1::2] = got[0], got[1]
    nz = inter[inter != 0.0]
    assert nz.shape[0] >= 4096
    np.testing.assert_array_equal(nz, np.arange(1, nz.shape[0] + 1).astype(np.float32) * 1e-6)


def test_os_audio_is_not_in_backend_all():
    assert "SoundDeviceSink" not in ft.backend.__all__
    assert "os_audio_available" in os_audio.__all__
    assert os.path.basename(os_audio.__file__) == "os_audio.py"
