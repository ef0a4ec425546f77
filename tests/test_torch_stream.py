"""The port's streaming engine (``GraphContext`` → ``GraphProcessor``, and
``FirewheelCtx`` over ``OutputStream``) held against the JAX package on the
CPU.

Both packages build the same graph from their own node classes (the beep
test with a metering sink, and ``mixer.add_mixer``'s mixer at three
voices, its filter on the default ``"auto"`` backend: the associative scan
on both sides), stream the same buffers, and apply the same edits between
buffers: a volume change scheduled ``at_sample=`` inside a buffer, and a
topology edit (one voice dropped, one added at its sum inputs) installed
at once or staged (``deferred_swap``).  Tolerance 1e-6 absolute on every
output sample and every float state leaf; masks, integer and bool leaves
equal.  The JAX processor renders each dispatch as one jitted program;
the port renders block by block, so both cover chunked dispatches, partial
blocks (1000-frame buffers in 128-frame blocks) and the clock.
"""

import jax
import numpy as np
import pytest
import torch

import firewheel_tpu as fw
from firewheel_tpu import nodes as jn
import firewheel_tpu_torch as ft
from firewheel_tpu_torch import mixer
from firewheel_tpu_torch import nodes as tn
from firewheel_tpu_torch.backend.ring_buffer import RingBuffer
from firewheel_tpu_torch.channels import channel_pair
from firewheel_tpu_torch.convert import state_from_jax, state_to_numpy

SR, F = 48000, 128
TOL = 1e-6
VOICES = 3
BUFFERS = 6
#: (package, node module, activation keywords)
PACKAGES = {"jax": (fw, jn, {}), "port": (ft, tn, {"device": "cpu"})}


def beep_graph(g, nodes):
    """BeepTest 440 Hz -12 dB → out, and a 0-output DbMeter on the beep."""
    beep = g.add_node(0, 2, nodes.BeepTestNode(440.0, -12.0, True))
    meter = g.add_node(2, 0, nodes.DbMeterNode())
    for ch in range(2):
        g.connect(beep, ch, g.graph_out_node(), ch)
        g.connect(beep, ch, meter, ch)
    return {"beep": beep, "meter": meter}


def mixer3_graph(g, nodes):
    s, voices = mixer.add_mixer(g, VOICES, "auto", nodes=nodes)
    return {"sum": s, "voices": voices}


GRAPHS = {"beep": beep_graph, "mixer": mixer3_graph}


def _normalize(tree):
    """A state tree of either package → nested dicts of numpy."""
    return state_to_numpy(state_from_jax(jax.tree.map(np.asarray, tree), "cpu"))


def assert_trees_close(a, b, path=()):
    assert a.keys() == b.keys(), path
    for k in a:
        if isinstance(a[k], dict):
            assert_trees_close(a[k], b[k], path + (k,))
        elif a[k].dtype.kind == "f":
            np.testing.assert_allclose(a[k], b[k], atol=TOL, rtol=0,
                                       err_msg=str(path + (k,)))
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=str(path + (k,)))


def close(cx, proc):
    """Stop the processor and finish the context's drop handshake."""
    silence = np.zeros(F * 2, np.float32)

    def pump():
        status = proc.process_interleaved(np.zeros(0, np.float32), silence, 0, 2,
                                          F, 0.0)
        if status.value != "ok":
            proc.drop()

    cx.deactivate(True, pump=pump)


class Stream:
    """One package's graph context and processor, driven buffer by buffer."""

    def __init__(self, pkg, graph, chunk_blocks=1, deferred=False):
        mod, self.nodes, kw = PACKAGES[pkg]
        self.cx = mod.GraphContext(mod.AudioGraphConfig(0, 2))
        self.ids = GRAPHS[graph](self.cx.graph, self.nodes)
        self.proc = self.cx.activate(SR, 0, 2, F, chunk_blocks=chunk_blocks,
                                     deferred_swap=deferred, **kw)
        self.cx.update()
        self.sample = 0

    def render(self, frames):
        out = np.zeros(frames * 2, np.float32)
        self.proc.process_interleaved(np.zeros(0, np.float32), out, 0, 2, frames,
                                      self.sample / SR)
        self.sample += frames
        return out

    def edit(self):
        """Drop voice 0 and add a voice at its sum inputs."""
        for nid in self.ids["voices"][0]:
            self.cx.graph.remove_node(nid)
        self.ids["voices"][0] = mixer.add_voice(self.cx.graph, self.ids["sum"], 0,
                                                VOICES, self.nodes)
        self.cx.update()

    def state(self):
        st = self.proc.state_dict()
        return _normalize(st) if isinstance(self.proc, fw.GraphProcessor) else \
            state_to_numpy(st)


@pytest.mark.parametrize("graph", list(GRAPHS))
@pytest.mark.parametrize("chunk_blocks", [1, 4])
@pytest.mark.parametrize("frames", [1024, 1000])
def test_process_interleaved_matches_jax(graph, chunk_blocks, frames):
    """Buffers of 8 whole blocks, or of 7 and a 104-frame block, in
    dispatches of 1 or up to 4 blocks; on the mixer, voice 1's volume moves
    at a sample 300 frames into buffer 2."""
    streams = [Stream(p, graph, chunk_blocks) for p in PACKAGES]
    for i in range(BUFFERS):
        if graph == "mixer" and i == 2:
            for s in streams:
                vol = s.cx.graph.node(s.ids["voices"][1][1])
                vol.set_percent_volume(35.0, at_sample=s.sample + 300)
        jo, to = (s.render(frames) for s in streams)
        np.testing.assert_allclose(to, jo, atol=TOL, rtol=0, err_msg=f"buffer {i}")
    assert np.abs(to).max() > 0.05
    assert_trees_close(streams[1].state(), streams[0].state())
    for s in streams:
        close(s.cx, s.proc)


@pytest.mark.parametrize("mode", ["immediate", "deferred", "deferred_merged"])
def test_topology_edit_matches_jax(mode):
    """The edit after buffer 2: installed at the next dispatch, or staged
    until ``advance_pending`` (which the stream calls after each pump); in
    ``deferred_merged`` a second edit (voice 1 dropped) arrives while the
    first is staged and the two install as one.  Surviving nodes keep their
    state across the swap, so the streams agree throughout."""
    deferred = mode != "immediate"
    streams = [Stream(p, "mixer", 4, deferred) for p in PACKAGES]
    for i in range(BUFFERS):
        if i == 2:
            for s in streams:
                s.edit()
                if mode == "deferred_merged":
                    for nid in s.ids["voices"][1]:
                        s.cx.graph.remove_node(nid)
                    s.cx.update()
        outs = [s.render(1024) for s in streams]
        if i == 2:
            assert [s.proc.has_pending() for s in streams] == [deferred] * 2
        for s in streams:
            if deferred:
                s.proc.advance_pending()
            s.cx.update()
        np.testing.assert_allclose(outs[1], outs[0], atol=TOL, rtol=0,
                                   err_msg=f"buffer {i}")
    assert not any(s.proc.has_pending() for s in streams)
    assert_trees_close(streams[1].state(), streams[0].state())
    n_voices = VOICES - (mode == "deferred_merged")
    assert sum(k.startswith("beep_test") for k in streams[1].state()) == n_voices
    for s in streams:
        close(s.cx, s.proc)


def test_state_hands_over_from_jax():
    """JAX streams three buffers of the mixer; its state (uint32 phases and
    sequence numbers as numpy) goes into a fresh port processor with
    ``set_state_dict``, and both stream on alike; ``node_state`` reads the
    meter as JAX's does."""
    jax_s, port_s = (Stream(p, "mixer", 4) for p in PACKAGES)
    for _ in range(3):
        jax_s.render(1024)
    port_s.proc.poll_messages()  # install the first schedule
    port_s.proc.set_state_dict(jax.tree.map(np.asarray, jax_s.proc.state_dict()))
    port_s.sample = jax_s.sample
    for i in range(2):
        np.testing.assert_allclose(port_s.render(1000), jax_s.render(1000), atol=TOL,
                                   rtol=0, err_msg=f"buffer {i}")
    assert_trees_close(port_s.state(), jax_s.state())
    meter = next(k for k in port_s.state() if k.startswith("db_meter"))
    nid = next(n for n in port_s.proc._processors if repr(n) == meter)
    jnid = next(n for n in jax_s.proc._processors if repr(n) == meter)
    assert_trees_close(port_s.proc.node_state(nid),
                       _normalize(jax_s.proc.node_state(jnid)))
    for s in (jax_s, port_s):
        close(s.cx, s.proc)


def test_dormant_node_parks_and_resumes_like_jax():
    """``prune_dormant``: a disabled beep leaves the schedule, its state
    parks (frozen) and comes back when it is enabled again; both packages
    stream the same audio throughout."""
    audio, parked = [], []
    for pkg in PACKAGES:
        mod, nodes, kw = PACKAGES[pkg]
        cx = mod.FirewheelCtx(**kw)
        g = cx.graph_mut()
        g.prune_dormant = True
        beep_node = nodes.BeepTestNode(440.0, -18.0, True)
        beep = g.add_node(0, 2, beep_node)
        s = g.add_node(2, 2, nodes.SumNode())
        for ch in range(2):
            g.connect(beep, ch, s, ch)
            g.connect(s, ch, g.graph_out_node(), ch)
        sink = mod.ArraySink()
        cx.activate(mod.StreamConfig(buffer_frames=F, deferred_swap=False), sink=sink)
        cx.render_offline(0.05)
        beep_node.set_enabled(False)
        g.notify_dormancy_changed()
        cx.render_offline(0.05)
        proc = cx.stream._processor
        parked.append(repr(beep) in proc._parked_state)
        beep_node.set_enabled(True)
        g.notify_dormancy_changed()
        cx.render_offline(0.05)
        assert repr(beep) not in proc._parked_state
        cx.deactivate()
        audio.append(sink.audio(2))
    assert parked == [True, True]
    np.testing.assert_allclose(audio[1], audio[0], atol=TOL, rtol=0)
    assert np.abs(audio[1][:, -F:]).max() > 0.05 and not audio[1][:, 3000:4800].any()


def _ctx_render(pkg, graph, secs, config):
    mod, nodes, kw = PACKAGES[pkg]
    cx = mod.FirewheelCtx(**kw)
    ids = GRAPHS[graph](cx.graph_mut(), nodes)
    sink = mod.ArraySink()
    cx.activate(mod.StreamConfig(**config), sink=sink)
    cx.render_offline(secs)
    return cx, ids, sink.audio(2)


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_render_offline_matches_jax(graph):
    """``FirewheelCtx.render_offline`` into an ``ArraySink``: the JAX
    context in buffers of 128 frames, 8 a dispatch; the port in buffers of
    1024 frames of 128-frame blocks (``block_frames``), one dispatch a
    buffer, pipelined.  The same blocks reach the sink."""
    jcx, _, ja = _ctx_render("jax", graph, 0.25, dict(buffer_frames=F, chunk_buffers=8))
    tcx, _, ta = _ctx_render("port", graph, 0.25, dict(buffer_frames=1024, block_frames=F))
    n = min(ja.shape[1], ta.shape[1])
    assert n >= 0.25 * SR
    np.testing.assert_allclose(ta[:, :n], ja[:, :n], atol=TOL, rtol=0)
    assert np.abs(ta).max() > 0.05
    for cx in (jcx, tcx):
        cx.deactivate()


def test_beep_renders_offline():
    """The beep test at the stream's defaults (1024-frame buffers and
    blocks): a 440 Hz tone at -12 dB, whose meter sink reads -12 dB."""
    cx, ids, audio = _ctx_render("port", "beep", 1.0, {})
    spectrum = np.abs(np.fft.rfft(audio[0]))
    assert abs(np.argmax(spectrum) * SR / audio.shape[1] - 440.0) < 1.0
    assert abs(np.abs(audio).max() - 0.2512) < 1e-4
    meter = tn.DbMeterNode.read(cx.node_state(ids["meter"]))
    np.testing.assert_allclose(meter["peak_db"], -12.0, atol=0.05)
    assert cx.stream.stats()["buffers_timed"] > 0
    cx.deactivate()


def test_poll_events_match_jax():
    """The clip counter: a -12 dB beep through a -20 dB hard clip, 0.1 s;
    both packages report the same count and total, then nothing new."""
    events = []
    for pkg in PACKAGES:
        mod, nodes, kw = PACKAGES[pkg]
        cx = mod.FirewheelCtx(**kw)
        g = cx.graph_mut()
        beep = g.add_node(0, 2, nodes.BeepTestNode(440.0, -12.0, True))
        clip = g.add_node(2, 2, nodes.HardClipNode(-20.0))
        for ch in range(2):
            g.connect(beep, ch, clip, ch)
            g.connect(clip, ch, g.graph_out_node(), ch)
        cx.activate(mod.StreamConfig(buffer_frames=F, chunk_buffers=4),
                    sink=mod.ArraySink())
        cx.render_offline(0.1)
        got = cx.poll_events()
        events.append([(repr(e.node_id), e.name, e.count, e.total, e.lane) for e in got])
        assert cx.poll_events() == []
        cx.deactivate()
    assert events[1] == events[0]
    assert len(events[0]) == 1 and events[0][0][1] == "clipped"
    assert events[0][0][2] > 2000


def test_entry_points_default_to_the_card(monkeypatch):
    """``FirewheelCtx``, ``GraphContext.activate`` and ``GraphProcessor``
    run on the card unless given ``device="cpu"``: without one they raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ft.FirewheelCtx()
    cx = ft.GraphContext()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cx.activate(SR, 0, 2, F)
    assert not cx.is_activated()
    a, b = channel_pair()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ft.GraphProcessor(a, b, 0, 2, SR, F)
    assert ft.GraphProcessor(a, b, 0, 2, SR, F, device="cpu").device.type == "cpu"
    assert ft.FirewheelCtx(device="cpu").device.type == "cpu"


def test_native_and_python_ring_buffers_agree():
    """The native SPSC ring and the Python one return the same floats for
    the same seeded sequence of writes and reads, across wrap-arounds and
    full and empty rings."""
    native, python = RingBuffer(100), RingBuffer(100, force_python=True)
    assert native.is_native and not python.is_native
    assert native.capacity == python.capacity == 128
    rng = np.random.default_rng(11)
    for _ in range(300):
        data = rng.standard_normal(int(rng.integers(0, 90))).astype(np.float32)
        assert native.write(data) == python.write(data)
        assert native.readable() == python.readable()
        n = int(rng.integers(0, 90))
        a, b = np.zeros(n, np.float32), np.zeros(n, np.float32)
        got = native.read(a)
        assert got == python.read(b)
        np.testing.assert_array_equal(a[:got], b[:got])
        k = int(rng.integers(0, 8))
        assert native.skip(k) == python.skip(k)
        assert native.writable() == python.writable()


def test_realtime_stream_on_the_native_consumer():
    """A realtime stream: the native consumer paces buffers into the sink
    and counts underflows (a measurement: any number may occur here)."""
    cx = ft.FirewheelCtx(device="cpu")
    beep_graph(cx.graph_mut(), tn)
    sink = ft.ArraySink()
    cx.activate(ft.StreamConfig(buffer_frames=256, realtime=True), sink=sink)
    cx.render_offline(0.1)
    stats = cx.stream.stats()
    cx.deactivate()
    assert stats["consumer"] == "native" and stats["consumer_periods"] >= 0
    audio = sink.audio(2)
    assert audio.shape[1] % 256 == 0 and audio.shape[1] >= 256
