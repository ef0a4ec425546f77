"""The transport-sequence fuzz of ``tests/test_music_fuzz.py`` on the
port's ``MusicPlayer`` (its streaming engine on the CPU), the same four
seeds: random interleavings of play/queue/crossfade/stop/stinger/update/
poll never raise, never emit non-finite or clipping audio, and keep the
player's bookkeeping invariants.  (Each primitive is held against the JAX
package's in ``tests/test_torch_music.py``.)"""

import numpy as np
import pytest

from firewheel_tpu_torch import ArraySink, FirewheelCtx, MusicPlayer, StreamConfig
from firewheel_tpu_torch.core.sample_resource import SampleResource
from firewheel_tpu_torch.nodes.streaming_sampler import CallbackStreamReader

SR = 48000


def const_reader(level, frames):
    def read_fn(start, n):
        out = np.zeros((2, n), np.float32)
        avail = max(0, min(frames - start, n))
        if avail > 0:
            out[:, :avail] = level
        return out

    return CallbackStreamReader(read_fn, 2, frames, SR)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_transport_sequences_stay_sane(seed):
    rng = np.random.default_rng(seed)
    cx = FirewheelCtx(device="cpu")
    player = MusicPlayer(cx.graph_mut(),
                         clock=lambda: cx.stream.frames_rendered)
    sink = ArraySink()
    cx.activate(StreamConfig(SR, 2, buffer_frames=512), sink=sink)
    player.set_tempo(140.0, beats_per_bar=4, origin_sample=0)
    tracks = [const_reader(0.1 + 0.05 * i, int(SR * (0.1 + 0.1 * i)))
              for i in range(4)]
    clip = SampleResource(np.full((2, 400), 0.1, np.float32),
                          sample_rate=SR)

    def op_play():
        player.play(rng.choice(tracks), loop=bool(rng.integers(2)),
                    fade_in_secs=float(rng.choice([0.0, 0.05])))

    def op_queue():
        player.queue(rng.choice(tracks),
                     crossfade_secs=float(rng.choice([0.0, 0.05, 0.2])))

    def op_xfade():
        q = [None, "beat", "bar"][int(rng.integers(3))]
        player.crossfade_to(rng.choice(tracks),
                            float(rng.choice([0.02, 0.1, 0.5])),
                            quantize=q)

    def op_stop():
        player.stop(fade_secs=float(rng.choice([0.0, 0.1])))

    def op_stinger():
        player.stinger(clip, quantize=[None, "beat"][int(rng.integers(2))])

    ops = [op_play, op_queue, op_xfade, op_stop, op_stinger]
    for step in range(25):
        ops[int(rng.integers(len(ops)))]()
        cx.render_offline(float(rng.choice([0.03, 0.08, 0.15])))
        player.update()
        player.poll(cx.poll_events())
        # bookkeeping invariants
        for d in player.decks:
            assert d.end_sample >= d.start_sample or d.start_sample < 0
        if player._current is not None:
            assert player._tail is not None
    cx.deactivate()
    L = sink.audio(2)
    assert np.isfinite(L).all()
    # tracks peak at 0.25; two decks + stinger can overlap but never blow up
    assert np.abs(L).max() < 1.0
