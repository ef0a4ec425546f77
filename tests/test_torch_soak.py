"""The soak cases of ``tests/test_soak.py`` on the port's streaming engine
(``FirewheelCtx`` on the CPU): a long-lived engine under continuous
mutation (repeated topology edits with state migration, parameter churn
every update, chains inserted and removed, a checkpoint saved mid-stream
and loaded ten updates later) that never errors and keeps its audio
finite; and activation cycles that leave no state behind.  The asserted
bounds are the JAX test's.
"""

import numpy as np

from firewheel_tpu_torch import ArraySink, FirewheelCtx, StreamConfig
from firewheel_tpu_torch.nodes import (
    BeepTestNode,
    CompressorNode,
    FilterNode,
    FilterType,
    FirFilterNode,
    LimiterNode,
    NoiseNode,
    StereoPanNode,
    VolumeNode,
    design_windowed_sinc,
)

SR = 48000


def test_soak_live_mutation(tmp_path):
    rng = np.random.default_rng(42)
    cx = FirewheelCtx(device="cpu")
    g = cx.graph

    beep = g.add_node(0, 2, BeepTestNode(330.0, -9.0, True))
    vol_node = VolumeNode(80.0)
    vol = g.add_node(2, 2, vol_node)
    g.connect(beep, 0, vol, 0)
    g.connect(beep, 1, vol, 1)
    g.connect(vol, 0, g.graph_out_node(), 0)
    g.connect(vol, 1, g.graph_out_node(), 1)

    sink = ArraySink()
    cx.activate(StreamConfig(SR, 2, buffer_frames=128), sink=sink)

    extra = []  # stack of (node_id, node) inserted chains
    pan_node = None

    for i in range(120):
        res = cx.update()
        assert res.error is None, res.error
        assert cx._active is None or cx._active.stream.error is None

        # param churn every iteration
        vol_node.set_percent_volume(float(rng.uniform(20.0, 100.0)))

        if i % 10 == 3:
            # insert a processing chain mid-stream (filter or pan)
            if len(extra) < 4:
                choice = (i // 10) % 3
                if choice == 0:
                    node = FilterNode(
                        FilterType.LOWPASS,
                        frequency_hz=float(rng.uniform(500, 8000)),
                    )
                elif choice == 1:
                    node = StereoPanNode(float(rng.uniform(-1, 1)))
                else:
                    node = FirFilterNode(
                        design_windowed_sinc(
                            "lowpass", 33, SR, float(rng.uniform(2000, 9000))
                        )
                    )
                nid = g.add_node(2, 2, node)
                # splice between the current tail and graph_out
                tail = extra[-1][0] if extra else vol
                g.disconnect(tail, 0, g.graph_out_node(), 0)
                g.disconnect(tail, 1, g.graph_out_node(), 1)
                g.connect(tail, 0, nid, 0)
                g.connect(tail, 1, nid, 1)
                g.connect(nid, 0, g.graph_out_node(), 0)
                g.connect(nid, 1, g.graph_out_node(), 1)
                extra.append((nid, node))
        if i % 10 == 8 and extra:
            # remove the newest chain link, rewire
            nid, node = extra.pop()
            g.remove_node(nid)
            tail = extra[-1][0] if extra else vol
            g.connect(tail, 0, g.graph_out_node(), 0)
            g.connect(tail, 1, g.graph_out_node(), 1)
        if i == 60:
            cx.save_checkpoint(str(tmp_path / "soak_ck"))
        if i == 70:
            cx.load_checkpoint(str(tmp_path / "soak_ck"))

    stats = cx._active.stream.stats()
    cx.deactivate()
    audio = sink.audio(2)
    assert audio.shape[1] >= 100 * 128
    assert np.all(np.isfinite(audio))
    assert np.abs(audio).max() > 0.01  # beep flowed the whole time
    # load_checkpoint rewinds the stream clock to the saved position, so
    # the sink holds MORE frames than the final counter by exactly the
    # save->load gap; the counter itself must be block-aligned
    assert stats["frames_rendered"] <= audio.shape[1]
    assert stats["frames_rendered"] % 128 == 0


def test_soak_repeated_activation_cycles():
    """Activate/deactivate many times; no state bleeds across cycles."""
    peaks = []
    for cycle in range(6):
        cx = FirewheelCtx(device="cpu")
        g = cx.graph
        n = g.add_node(0, 2, NoiseNode("white", gain_db=-12.0, seed=cycle))
        c = g.add_node(2, 2, CompressorNode(threshold_db=-20.0))
        lim = g.add_node(2, 2, LimiterNode(ceiling_db=-3.0))
        g.connect(n, 0, c, 0)
        g.connect(n, 1, c, 1)
        g.connect(c, 0, lim, 0)
        g.connect(c, 1, lim, 1)
        g.connect(lim, 0, g.graph_out_node(), 0)
        g.connect(lim, 1, g.graph_out_node(), 1)
        sink = ArraySink()
        cx.activate(
            StreamConfig(SR, 2, buffer_frames=256), sink=sink,
            duration_secs=0.1,
        )
        st = cx._active.stream
        while not st.finished:
            assert st.error is None, st.error
            cx.update()
        cx.deactivate()
        audio = sink.audio(2)
        assert np.all(np.isfinite(audio))
        assert np.abs(audio).max() <= 10 ** (-3.0 / 20) * 1.0001
        peaks.append(float(np.abs(audio).max()))
    assert all(p > 0.01 for p in peaks)
