"""Per-block param timelines (``executor.PerBlock``) in the port, held
against the JAX package on the CPU.

A chunked dispatch renders K blocks with one param snapshot; a change
scheduled ``at_sample=`` rides a timeline leaf, so it lands on its own
block of the chunk.  Both packages get the same graph (built from their
own node classes), the same scheduled changes and the same chunk; the JAX
side renders with ``ScheduleProgram.render_packed`` (its streaming
processor's path), the port with ``ScheduleProgram.render_chunk``.
Tolerance 1e-6 absolute on outputs and float state.
"""

import jax
import numpy as np
import pytest
import torch

import firewheel_tpu as fw
from firewheel_tpu import nodes as jn
from firewheel_tpu.core.sample_resource import SampleResource as JSampleResource
import firewheel_tpu_torch as ft
from firewheel_tpu_torch import mixer
from firewheel_tpu_torch import nodes as tn
from firewheel_tpu_torch.convert import state_from_jax, state_to_numpy
from firewheel_tpu_torch.core.sample_resource import SampleResource as TSampleResource
from firewheel_tpu_torch.executor import PerBlock, split_timelines, splice_block
from firewheel_tpu_torch.executor_hybrid import HybridMegaRenderer
from firewheel_tpu_torch.executor_mega import MegaRenderer

SR, F, K = 48000, 128, 8
TOL = 1e-6
WRAP = 1 << 32
#: (package, node module, SampleResource, program keywords)
PACKAGES = {
    "jax": (fw, jn, JSampleResource, {}),
    "port": (ft, tn, TSampleResource, {"device": "cpu"}),
}


def tone_sfx_program(pkg):
    """beep → volume, plus a one-shot sampler (a seeded 200-frame clip),
    summed to the stereo output → ``(program, volume, sampler)``."""
    mod, nodes, sample_resource, kw = PACKAGES[pkg]
    g = mod.AudioGraph(mod.AudioGraphConfig(0, 2))
    vol = nodes.VolumeNode(100.0)
    sfx = nodes.SamplerNode(100.0)
    clip = (np.random.default_rng(7).standard_normal((2, 200)) * 0.2).astype(np.float32)
    sfx.set_sample(sample_resource(clip))
    tone = g.add_node(0, 2, nodes.BeepTestNode(440.0, -12.0, True))
    vid = g.add_node(2, 2, vol)
    sid = g.add_node(0, 2, sfx)
    mix = g.add_node(4, 2, nodes.SumNode())
    for ch in range(2):
        g.connect(tone, ch, vid, ch)
        g.connect(vid, ch, mix, ch)
        g.connect(sid, ch, mix, 2 + ch)
        g.connect(mix, ch, g.graph_out_node(), ch)
    pkg_ = g.compile(SR, F)
    return mod.ScheduleProgram(pkg_.schedule, dict(pkg_.new_node_processors), SR,
                               **kw), vol, sfx


def render_window(pkg, prog, start, k=K):
    """``k`` blocks from ``start`` with the program's timelines → (outputs
    f32[k, 2, F], state as numpy)."""
    params = prog.collect_params(blocks=k, start_sample=start)
    gi, im = np.zeros((k, 0, F), np.float32), np.ones((k, 0), bool)
    if pkg == "jax":
        outs, _, packed = prog.render_packed(
            params, prog.pack_state(prog.init_state()), gi, im, start, blocks=k)
        state = jax.tree.map(np.asarray, prog.unpack_state(packed))
        return np.asarray(outs), state_to_numpy(state_from_jax(state, "cpu"))
    outs, _, state = prog.render_chunk(params, prog.init_state(), torch.from_numpy(gi),
                                       torch.from_numpy(im), start)
    return outs.numpy(), state_to_numpy(state)


def _close(a, b):
    assert a.keys() == b.keys()
    for key in a:
        if isinstance(a[key], dict):
            _close(a[key], b[key])
        elif a[key].dtype.kind == "f":
            np.testing.assert_allclose(a[key], b[key], atol=TOL, rtol=0, err_msg=key)
        else:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_split_and_splice():
    tree = {"a": {"g": PerBlock(np.arange(4, dtype=np.float32)), "h": np.float32(2)},
            "b": {}, "c": {"s": {"t": PerBlock(np.array([1, 2, 3, 4], np.uint32))}}}
    static, timelines = split_timelines(tree)
    assert static == {"a": {"g": 0.0, "h": 2.0}, "b": {}, "c": {"s": {"t": 1}}}
    assert list(timelines) == [("a", "g"), ("c", "s", "t")]
    dev = {path: torch.from_numpy(v.astype(np.int64)) for path, v in timelines.items()}
    block2 = splice_block(static, dev, 2)
    assert int(block2["a"]["g"]) == 2 and int(block2["c"]["s"]["t"]) == 3
    assert static["a"]["g"] == 0.0  # the static tree is left as it was
    assert splice_block(static, {}, 2) is static


@pytest.mark.parametrize("case", ["mid_chunk", "past_due", "future", "no_consume"])
def test_volume_lands_on_the_jax_block(case):
    """A volume change ``at_sample=`` 3 blocks and 50 frames into an
    8-block chunk (it lands on block 3), one already due (block 0), one
    past the chunk (stays queued), and a collect that consumes nothing."""
    start = 40 * F
    at = {"mid_chunk": start + 3 * F + 50, "past_due": start - 7,
          "future": start + K * F + 1, "no_consume": start + 3 * F}[case]
    got = {}
    for pkg in PACKAGES:
        prog, vol, _ = tone_sfx_program(pkg)
        vol.set_percent_volume(25.0, at_sample=at)
        if case == "no_consume":
            params = prog.collect_params(blocks=K, start_sample=start, consume=False)
            gain = next(v for k, v in params.items() if k.startswith("volume"))
            assert isinstance(gain["raw_gain"], (PerBlock, fw.executor.PerBlock))
            assert len(vol._scheduled) == 1 and vol.percent_volume() == 100.0
        got[pkg] = render_window(pkg, prog, start)
        got[pkg + "_left"] = (len(vol._scheduled), vol.percent_volume())
    np.testing.assert_allclose(got["port"][0], got["jax"][0], atol=TOL, rtol=0)
    _close(got["port"][1], got["jax"][1])
    assert got["port_left"] == got["jax_left"]
    out = got["port"][0]
    if case in ("mid_chunk", "no_consume"):
        # the ramp starts at block 3: blocks 1 and 2 repeat block 0's gain
        assert np.abs(out[2] - out[3]).max() > 1e-3
    if case == "future":
        assert got["port_left"] == (1, 100.0)


def test_sampler_timelines_land_on_the_jax_blocks():
    """play() 37 frames into block 1 (silent before that sample), stop in
    block 3, a seek and a second play in block 4, a pause in block 6: the
    five timelines render the same blocks as JAX."""
    start = 16 * F
    got = {}
    for pkg in PACKAGES:
        prog, _, sfx = tone_sfx_program(pkg)
        sfx.play(at_sample=start + F + 37)
        sfx.stop(at_sample=start + 3 * F + 2)
        sfx.set_playhead(0.001, at_sample=start + 4 * F)
        sfx.play(at_sample=start + 4 * F + 9)
        sfx.pause(at_sample=start + 6 * F)
        got[pkg] = render_window(pkg, prog, start)
    np.testing.assert_allclose(got["port"][0], got["jax"][0], atol=TOL, rtol=0)
    _close(got["port"][1], got["jax"][1])
    # the clip enters at its trigger sample
    tone_only = tone_sfx_program("port")
    ref, _ = render_window("port", tone_only[0], start)
    diff = np.abs(got["port"][0] - ref).max(axis=1)  # [K, F]
    assert not diff[:1].any() and not diff[1, :37].any() and diff[1, 37] > 0


def test_clock_wrap_matches_jax():
    """Changes scheduled across the 2**32 boundary of the device clock land
    on the same blocks as the same schedule in a small epoch (bit for bit:
    the kernels key on per-block deltas), and match JAX there."""
    def window(pkg, epoch):
        prog, vol, sfx = tone_sfx_program(pkg)
        vol.set_percent_volume(25.0, at_sample=epoch + 3 * F)
        sfx.play(at_sample=epoch + 5 * F)
        return render_window(pkg, prog, epoch)

    big = window("port", WRAP - 4 * F)
    small = window("port", 64 * F)
    np.testing.assert_array_equal(big[0], small[0])
    assert not np.array_equal(big[0][2], big[0][3])
    jbig = window("jax", WRAP - 4 * F)
    np.testing.assert_allclose(big[0], jbig[0], atol=TOL, rtol=0)
    _close(big[1], jbig[1])


def test_partial_block_matches_jax():
    """Two blocks of 104 frames (a stream's tail) after a full one: the
    state advances by exactly the frames rendered, as in JAX."""
    got = {}
    for pkg in PACKAGES:
        mod = PACKAGES[pkg][0]
        prog, _, sfx = tone_sfx_program(pkg)
        sfx.play()
        params, state, outs = prog.collect_params(), prog.init_state(), []
        for i, frames in enumerate((F, 104, 104)):
            gi, im = np.zeros((0, frames), np.float32), np.ones((0,), bool)
            sample = i * F
            if pkg == "port":
                info = mod.BlockInfo.make(sample / SR, sample)
                out, _, state = prog.render_partial_block(
                    frames, params, state, torch.from_numpy(gi), torch.from_numpy(im),
                    info)
                outs.append(out.numpy())
            else:
                from firewheel_tpu.core.node import BlockInfo as JBlockInfo

                out, _, state = prog.render_partial_block(
                    frames, params, state, gi, im, JBlockInfo.make(sample / SR, sample))
                outs.append(np.asarray(out))
        state = (state_to_numpy(state) if pkg == "port" else
                 state_to_numpy(state_from_jax(jax.tree.map(np.asarray, state), "cpu")))
        got[pkg] = (np.concatenate(outs, -1), state)
    np.testing.assert_allclose(got["port"][0], got["jax"][0], atol=TOL, rtol=0)
    _close(got["port"][1], got["jax"][1])
    assert got["port"][0].shape == (2, F + 208)


@pytest.mark.parametrize("renderer", ["mega", "hybrid"])
def test_megakernels_refuse_timelines(renderer):
    """K2 and K3 take one value per param leaf a chunk: params that carry
    timelines raise instead of rendering a snapshot."""
    prog = mixer.mixer_graph(num_voices=2, device="cpu")
    cls = MegaRenderer if renderer == "mega" else HybridMegaRenderer
    r = cls(prog, 1, K, device="cpu")
    timeline = prog.collect_params(blocks=K, start_sample=0)
    assert split_timelines(timeline)[1]
    with pytest.raises(ValueError, match="timelines"):
        r.render_chunk(timeline, r.init_state())
    out, _, _ = r.render_chunk(r.stack_params(), r.init_state())
    assert out.shape == (1, K, 2, F)
