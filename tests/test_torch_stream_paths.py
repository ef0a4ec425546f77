"""The cases of ``tests/test_stream_paths.py`` that hold for the port's
design, on its streaming engine (``FirewheelCtx`` on the CPU): stream
inputs through the graph, a partial tail block, chunked dispatch (the
same audio, params at chunk granularity, per-block input masks), and the
pipelining cases (``StreamConfig(pipeline_depth=)``,
``backend/stream.py``): offline pumping with whole chunks in flight
renders bit for bit what synchronous dispatch renders, the chunks still
in flight included, and a fixed-duration caller that pumps until
``finished`` reads every frame from the sink without a ``stop``,
``drain`` or ``flush``.  The bounds are the JAX tests'.

``test_offline_pump_dispatches_whole_chunks`` does not hold for the
port's design: the JAX package floors ``chunk_buffers`` to a power of two,
the dispatch sizes it compiles ahead (23 → 16), while the port, which
compiles nothing, dispatches any chunk as given.
"""

import numpy as np
import pytest

from firewheel_tpu_torch import ArraySink, FirewheelCtx, GraphContext, StreamConfig
from firewheel_tpu_torch.graph import AudioGraphConfig
from firewheel_tpu_torch.nodes import BeepTestNode, HardClipNode, VolumeNode

SR = 48000


def build_passthrough(cx):
    g = cx.graph_mut() if hasattr(cx, "graph_mut") else cx.graph
    clip = g.add_node(2, 2, HardClipNode(0.0))
    g.connect(g.graph_in_node(), 0, clip, 0)
    g.connect(g.graph_in_node(), 1, clip, 1)
    g.connect(clip, 0, g.graph_out_node(), 0)
    g.connect(clip, 1, g.graph_out_node(), 1)


def test_input_source_flows_to_output():
    """Stream inputs (graph_in) pass through the engine end to end."""
    cx = FirewheelCtx(AudioGraphConfig(num_graph_inputs=2, num_graph_outputs=2),
                      device="cpu")
    build_passthrough(cx)

    rng = np.random.default_rng(0)
    feed_log = []

    def source(frames):
        x = (rng.standard_normal((frames, 2)) * 0.4).astype(np.float32)
        feed_log.append(x)
        return x.reshape(-1)  # interleaved

    sink = ArraySink()
    cx.activate(
        StreamConfig(SR, 2, num_in_channels=2, buffer_frames=256),
        sink=sink,
        input_source=source,
        duration_secs=0.1,
    )
    cx.render_offline(0.1)
    cx.deactivate()
    got = sink.audio(2)
    fed = np.concatenate(feed_log).T  # [2, frames]
    n = min(got.shape[1], fed.shape[1])
    np.testing.assert_allclose(got[:, :n], np.clip(fed[:, :n], -1, 1), atol=1e-6)


def test_partial_tail_block():
    """A stream buffer not divisible by max_block_frames exercises the
    partial-block path with correct state advance (processor.rs:95-158)."""
    cx = GraphContext()
    g = cx.graph
    beep = g.add_node(0, 2, BeepTestNode(440.0, -12.0, True))
    g.connect(beep, 0, g.graph_out_node(), 0)
    g.connect(beep, 1, g.graph_out_node(), 1)
    proc = cx.activate(SR, 0, 2, 128, device="cpu")
    cx.update()

    # 128 + 128 + 64: last call is a partial block
    out_a = np.zeros(128 * 2, np.float32)
    out_b = np.zeros(128 * 2, np.float32)
    out_c = np.zeros(64 * 2, np.float32)
    proc.process_interleaved(np.zeros(0, np.float32), out_a, 0, 2, 128, 0.0)
    proc.process_interleaved(np.zeros(0, np.float32), out_b, 0, 2, 128, 128 / SR)
    proc.process_interleaved(np.zeros(0, np.float32), out_c, 0, 2, 64, 256 / SR)
    # a 4th call continues seamlessly after the 64-frame tail
    out_d = np.zeros(128 * 2, np.float32)
    proc.process_interleaved(np.zeros(0, np.float32), out_d, 0, 2, 128, 320 / SR)

    sig = np.concatenate([out_a[0::2], out_b[0::2], out_c[0::2], out_d[0::2]])
    ideal = 0.25118864 * np.sin(2 * np.pi * 440 / SR * np.arange(448))
    np.testing.assert_allclose(sig, ideal, atol=2e-6)
    cx.deactivate(stream_is_running=False, pump=lambda: proc.process_interleaved(
        np.zeros(0, np.float32), out_d, 0, 2, 128, 0.0) and None)


@pytest.mark.parametrize("chunk_buffers", [1, 4])
def test_chunked_pump_equivalence(chunk_buffers):
    """chunk_buffers=4 (one dispatch per 4 buffers) must produce the same
    audio as the per-buffer path."""
    cx = FirewheelCtx(device="cpu")
    g = cx.graph_mut()
    beep = g.add_node(0, 2, BeepTestNode(440.0, -12.0, True))
    vol = g.add_node(2, 2, VolumeNode(100.0))
    g.connect(beep, 0, vol, 0)
    g.connect(beep, 1, vol, 1)
    g.connect(vol, 0, g.graph_out_node(), 0)
    g.connect(vol, 1, g.graph_out_node(), 1)
    sink = ArraySink()
    cx.activate(
        StreamConfig(
            SR, 2, buffer_frames=256, chunk_buffers=chunk_buffers
        ),
        sink=sink,
    )
    cx.render_offline(0.25)
    cx.deactivate()
    audio = sink.audio(2)
    n = min(audio.shape[1], int(SR * 0.25))
    ideal = 0.25118864 * np.sin(2 * np.pi * 440 / SR * np.arange(n))
    np.testing.assert_allclose(audio[0, :n], ideal, atol=5e-6)


def test_chunked_live_param_applies_at_chunk_granularity():
    cx = FirewheelCtx(device="cpu")
    g = cx.graph_mut()
    beep = g.add_node(0, 2, BeepTestNode(440.0, -12.0, True))
    vol = g.add_node(2, 2, VolumeNode(100.0))
    g.connect(beep, 0, vol, 0)
    g.connect(beep, 1, vol, 1)
    g.connect(vol, 0, g.graph_out_node(), 0)
    g.connect(vol, 1, g.graph_out_node(), 1)
    sink = ArraySink()
    cx.activate(
        StreamConfig(SR, 2, buffer_frames=256, chunk_buffers=4), sink=sink
    )
    cx.render_offline(0.1)
    g.node(vol).set_percent_volume(0.0)
    cx.render_offline(0.3)
    cx.deactivate()
    audio = sink.audio(2)
    assert np.abs(audio[:, :2000]).max() > 0.1
    assert np.abs(audio[:, -2000:]).max() < 1e-5


def test_chunked_dispatch_with_stream_inputs():
    """_process_chunk's per-block deinterleave + mask path (inputs present)."""
    cx = FirewheelCtx(AudioGraphConfig(num_graph_inputs=2, num_graph_outputs=2),
                      device="cpu")
    build_passthrough(cx)
    rng = np.random.default_rng(1)
    fed = []

    def source(frames):
        x = (rng.standard_normal((frames, 2)) * 0.4).astype(np.float32)
        fed.append(x)
        return x.reshape(-1)

    sink = ArraySink()
    cx.activate(
        StreamConfig(
            SR, 2, num_in_channels=2, buffer_frames=256, chunk_buffers=4
        ),
        sink=sink,
        input_source=source,
    )
    cx.render_offline(0.2)
    cx.deactivate()
    got = sink.audio(2)
    want = np.concatenate(fed).T
    n = min(got.shape[1], want.shape[1])
    np.testing.assert_allclose(
        got[:, :n], np.clip(want[:, :n], -1, 1), atol=1e-6
    )


def test_chunked_input_silence_mask_per_block():
    """Silent input blocks inside a chunk must come out silent even when
    neighbors in the same chunk are loud (per-block masks through the scan)."""
    cx = FirewheelCtx(AudioGraphConfig(num_graph_inputs=1, num_graph_outputs=1),
                      device="cpu")
    g = cx.graph_mut()
    g.connect(g.graph_in_node(), 0, g.graph_out_node(), 0)

    calls = [0]

    def source(frames):
        calls[0] += 1
        if calls[0] % 2 == 0:
            return np.zeros(frames, np.float32)
        return np.full(frames, 0.5, np.float32)

    sink = ArraySink()
    cx.activate(
        StreamConfig(
            SR, 1, num_in_channels=1, buffer_frames=256, chunk_buffers=4
        ),
        sink=sink,
        input_source=source,
    )
    cx.render_offline(0.1)
    cx.deactivate()
    got = sink.audio(1)[0]
    blocks = got[: (len(got) // 256) * 256].reshape(-1, 256)
    for i, blk in enumerate(blocks[: calls[0]]):
        if i % 2 == 0:
            assert (blk == np.float32(0.5)).all(), f"block {i}"
        else:
            assert (blk == 0).all(), f"block {i}"


def _beep_ctx():
    cx = FirewheelCtx(device="cpu")
    g = cx.graph_mut()
    beep = g.add_node(0, 2, BeepTestNode(440.0, -12.0, True))
    g.connect(beep, 0, g.graph_out_node(), 0)
    g.connect(beep, 1, g.graph_out_node(), 1)
    return cx


def test_pipeline_depths_render_identically():
    """Pipelined offline pumping (depth 1 and deeper) is bit for bit the
    synchronous path (depth 0), including the flush of chunks still in
    flight when ``render_offline`` returns."""
    ref = None
    for depth in (0, 1, 3):
        cx = _beep_ctx()
        sink = ArraySink()
        cx.activate(
            StreamConfig(SR, 2, buffer_frames=128, chunk_buffers=16,
                         pipeline_depth=depth),
            sink=sink,
        )
        cx.render_offline(0.7)  # 262.5 buffers: chunks + odd tail
        cx.deactivate()
        audio = sink.audio(2)
        assert audio.shape[1] >= int(0.7 * SR)
        if ref is None:
            ref = audio
        else:
            np.testing.assert_array_equal(audio, ref)
    assert np.abs(ref).max() > 0.2


@pytest.mark.parametrize("depth", [1, 2])
def test_pump_until_finished_flushes_pipeline(depth):
    """A fixed-duration caller pumping until ``finished`` and reading the
    sink without stop()/drain()/flush() sees every frame: the final pump
    flushes the chunks in flight, and the audio is the synchronous path's."""
    outs = []
    for d in (0, depth):
        cx = _beep_ctx()
        sink = ArraySink()
        cx.activate(
            StreamConfig(SR, 2, buffer_frames=128, chunk_buffers=16,
                         pipeline_depth=d),
            sink=sink,
            duration_secs=0.5,
        )
        st = cx.stream
        for _ in range(10_000):
            if st.finished:
                break
            st.pump()
        assert st.finished
        audio = sink.audio(2)  # no stop()/drain()/flush()
        assert audio.shape[1] == int(0.5 * SR)
        outs.append(audio)
        cx.deactivate()
    np.testing.assert_array_equal(outs[0], outs[1])
