"""The 2^32 stream-clock epoch on the port (the JAX package's
``tests/test_clock_wrap.py``).

Host clocks are unbounded Python ints; the device clock is a 32-bit
counter.  torch has no uint32, so the port carries it as int64 masked to 32
bits (``core.node.wrap_stream_sample``).  The port left the JAX package's
``packing.py`` out, so where the JAX test renders with ``render_packed``
over ``pack_state``, these render with ``ScheduleProgram.render_chunk``:
``chunk_fn``'s K-block loop with the ``PerBlock`` timelines of
``collect_params(blocks=K, start_sample=...)`` and the per-block clocks of
``block_clocks``.  The window that crosses 2^32 is held bit for bit
against the same window in a small epoch, and against the JAX package's
render of it at 1e-6.
"""

import numpy as np
import pytest
import torch

import firewheel_tpu_torch as ft
from firewheel_tpu_torch.core.node import STREAM_SAMPLE_PERIOD, wrap_stream_sample
from firewheel_tpu_torch.core.sample_resource import SampleResource
from firewheel_tpu_torch.nodes import BeepTestNode, SamplerNode, SumNode, VolumeNode
import test_clock_wrap as jax_clock

SR, F = 48000, 128
WRAP = STREAM_SAMPLE_PERIOD  # 2**32


def make_program():
    """beep -> volume, plus a one-shot sampler, summed to graph_out."""
    g = ft.AudioGraph(ft.AudioGraphConfig(0, 2))
    tone, vol, sfx = BeepTestNode(440.0, -12.0, True), VolumeNode(100.0), SamplerNode(100.0)
    clip = (np.random.default_rng(7).standard_normal((2, 200)) * 0.2).astype(np.float32)
    sfx.set_sample(SampleResource(clip, device=False))
    tid, vid, sid = g.add_node(0, 2, tone), g.add_node(2, 2, vol), g.add_node(0, 2, sfx)
    mix = g.add_node(4, 2, SumNode())
    for ch in range(2):
        g.connect(tid, ch, vid, ch)
        g.connect(vid, ch, mix, ch)
        g.connect(sid, ch, mix, 2 + ch)
        g.connect(mix, ch, g.graph_out_node(), ch)
    pkg = g.compile(SR, F)
    prog = ft.ScheduleProgram(pkg.schedule, dict(pkg.new_node_processors), SR,
                              device="cpu")
    return prog, vol, sfx


def render_chunk(prog, epoch, k):
    """k blocks from ``epoch`` with the queued scheduled commands as
    per-block timelines (the port's counterpart of ``render_packed``)."""
    params = prog.collect_params(blocks=k, start_sample=epoch)
    outs, _, _ = prog.render_chunk(params, prog.init_state(), torch.zeros((k, 0, F)),
                                   torch.ones((k, 0), dtype=torch.bool), epoch)
    return outs.numpy()


def render_window(prog, vol, sfx, epoch, k=8):
    """k blocks from ``epoch``, a volume set scheduled 3 blocks in and a
    sampler play() 5 blocks in, both at absolute samples that may pass
    2^32."""
    vol.set_percent_volume(25.0, at_sample=epoch + 3 * F)
    sfx.play(at_sample=epoch + 5 * F)
    return render_chunk(prog, epoch, k)


def test_wrap_stream_sample_rebases_unbounded_ints():
    assert wrap_stream_sample(0) == 0
    assert wrap_stream_sample(WRAP) == 0
    assert wrap_stream_sample(WRAP + 12345) == 12345
    assert wrap_stream_sample(3 * WRAP + 7) == 7
    # tensors rebase modularly too, as int64
    a = wrap_stream_sample(torch.tensor([WRAP - 1, WRAP, WRAP + 1]))
    assert a.dtype == torch.int64 and a.tolist() == [WRAP - 1, 0, 1]


def test_dispatch_past_the_boundary_does_not_overflow():
    out = render_window(*make_program(), WRAP + 4 * F)
    assert np.isfinite(out).all() and np.abs(out).max() > 0.01


def test_scheduled_commands_land_exactly_across_the_boundary():
    """The window starts 4 blocks before 2^32: the volume set lands 1 block
    before the boundary, the sampler trigger 1 block after it, on the same
    blocks as in a small epoch, bit for bit."""
    big = render_window(*make_program(), WRAP - 4 * F)
    small = render_window(*make_program(), 64 * F)
    np.testing.assert_array_equal(big, small)
    assert np.abs(big[:5]).max() < 0.3  # the tone at -12 dB, then 25%
    assert not np.array_equal(big[2], big[3])  # the volume steps at block 3
    # the clip's first sample arrives at block 5, not before
    prog, vol, _ = make_program()
    vol.set_percent_volume(25.0, at_sample=WRAP - F)
    no_clip = render_chunk(prog, WRAP - 4 * F, 8)
    assert np.array_equal(no_clip[:5], big[:5]) and not np.array_equal(no_clip[5], big[5])


def test_big_epoch_matches_jax():
    """The window across 2^32 equals the JAX package's render of it."""
    big = render_window(*make_program(), WRAP - 4 * F)
    jbig = jax_clock.render_window(*jax_clock.make_program(), WRAP - 4 * F)
    np.testing.assert_allclose(big, jbig, atol=1e-6, rtol=0)


def test_session_server_crosses_the_boundary_mid_stream():
    """A fleet parked one chunk before 2^32 renders on across it, the tone
    phase-continuous."""
    prog, vol, _ = make_program()
    srv = ft.SessionServer(prog, capacity=2, chunk_blocks=4, device="cpu")
    h = srv.connect(lambda: vol.set_percent_volume(100.0))
    srv.sample = WRAP - 4 * F
    a = srv.render().numpy()  # ends exactly on the boundary
    b = srv.render().numpy()  # the new epoch's first chunk
    assert srv.sample == WRAP + 4 * F
    for out in (a, b):
        assert np.isfinite(out).all()
        assert np.abs(out[h.slot]).max() > 0.05
    # no sample-scale step between the last frame before 2^32 and the first
    assert abs(float(b[h.slot, 0, 0, 0]) - float(a[h.slot, -1, 0, -1])) < 0.05


def test_crossfade_shaped_ramps_across_the_boundary():
    """Two opposed scheduled volume ramps (a crossfade's primitive) land
    sample-exactly when the fade spans 2^32."""
    def render(epoch):
        g = ft.AudioGraph(ft.AudioGraphConfig(0, 2))
        va, vb = VolumeNode(100.0), VolumeNode(0.0)
        mix = g.add_node(4, 2, SumNode())
        for freq, v, base in ((440.0, va, 0), (220.0, vb, 2)):
            src = g.add_node(0, 2, BeepTestNode(freq, -12.0, True))
            vid = g.add_node(2, 2, v)
            for ch in range(2):
                g.connect(src, ch, vid, ch)
                g.connect(vid, ch, mix, base + ch)
        for ch in range(2):
            g.connect(mix, ch, g.graph_out_node(), ch)
        pkg = g.compile(SR, F)
        prog = ft.ScheduleProgram(pkg.schedule, dict(pkg.new_node_processors), SR,
                                  device="cpu")
        va.set_percent_volume(0.0, at_sample=epoch + 4 * F)
        vb.set_percent_volume(100.0, at_sample=epoch + 4 * F)
        return render_chunk(prog, epoch, 8)

    big, small = render(WRAP - 4 * F), render(1024 * F)
    np.testing.assert_array_equal(big, small)
    assert not np.array_equal(big[3], big[4])  # the fade engages at block 4


@pytest.mark.parametrize("chunk_blocks", [1, 4])
def test_stream_crosses_the_boundary(chunk_blocks):
    """The streaming processor (``GraphContext`` → ``GraphProcessor``) fed a
    stream time one buffer before 2^32, with a volume set scheduled just
    past it: the same buffers as the same stream in a small epoch, bit for
    bit."""
    def stream(epoch):
        cx = ft.GraphContext(ft.AudioGraphConfig(0, 2))
        vol = VolumeNode(100.0)
        beep = cx.graph.add_node(0, 2, BeepTestNode(440.0, -12.0, True))
        vid = cx.graph.add_node(2, 2, vol)
        for ch in range(2):
            cx.graph.connect(beep, ch, vid, ch)
            cx.graph.connect(vid, ch, cx.graph.graph_out_node(), ch)
        proc = cx.activate(SR, 0, 2, F, chunk_blocks=chunk_blocks, device="cpu")
        cx.update()
        vol.set_percent_volume(30.0, at_sample=epoch + 4 * F + 50)
        outs, sample = [], epoch
        for _ in range(2):
            out = np.zeros(4 * F * 2, np.float32)
            proc.process_interleaved(np.zeros(0, np.float32), out, 0, 2, 4 * F,
                                     sample / SR)
            outs.append(out)
            sample += 4 * F
        cx.deactivate(True, pump=lambda: proc.drop())
        return np.concatenate(outs)

    big, small = stream(WRAP - 4 * F), stream(64 * F)
    np.testing.assert_array_equal(big, small)
    assert np.abs(big[: 8 * F]).max() > 0.2 > np.abs(big[-2 * F:]).max()
