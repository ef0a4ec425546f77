"""The port's sampler (``firewheel_tpu_torch/nodes/sampler.py``) and sample
resources, held against the JAX package on the CPU.

Both packages get the same clip, made from a numpy seed, and the same
control calls between blocks; B instances differ in their playback rates
(and, where a case says so, in their state).  The JAX kernel runs under
``jit(vmap(...))``, as ``BatchRenderer`` runs it: XLA then contracts the
position sum ``frac + k·rate`` into a fused multiply-add, and the port
writes that FMA out.

Tolerance 1e-6 absolute on audio and float state; every uint32 leaf (the
playhead, sequence numbers, loop bounds, event counters), every bool leaf
and the masks equal.  The gathers pick the same samples; the
interpolation weights are the same f32 polynomials, which XLA may contract
into FMAs where torch rounds each product (≤ 7.2e-7 measured).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from firewheel_tpu.core import sample_resource as jsr
from firewheel_tpu.core.node import BlockInfo as JBlockInfo
from firewheel_tpu.nodes import LoopRange as JLoopRange
from firewheel_tpu.nodes import SamplerNode as JSamplerNode
from firewheel_tpu_torch.convert import params_from_jax, state_from_jax, state_to_numpy
from firewheel_tpu_torch.core import sample_resource as tsr
from firewheel_tpu_torch.core.node import BlockInfo as TBlockInfo
from firewheel_tpu_torch.nodes import LoopRange as TLoopRange
from firewheel_tpu_torch.nodes import SamplerNode as TSamplerNode

SR = 48000
F = 128
TOL = 1e-6
#: per-instance playback rates: 44.1/48 kHz, two that are not dyadic, and
#: two that are
RATES = np.array([0.91875, 1.1, 0.75, 2.0], np.float32)
B = len(RATES)


class Pair:
    """A JAX sampler and a port sampler driven by the same calls."""

    def __init__(self, clip, quality="linear", num_outputs=2, **node_kw):
        self.nodes = (JSamplerNode(100.0, quality=quality, **node_kw),
                      TSamplerNode(100.0, quality=quality, **node_kw))
        self.nodes[0].set_sample(jsr.SampleResource(clip))
        self.nodes[1].set_sample(tsr.SampleResource(clip))
        self.procs = [n.activate(SR, F, 0, num_outputs) for n in self.nodes]
        self.jkernel = jax.jit(jax.vmap(self.procs[0].kernel,
                                        in_axes=(0, 0, 0, 0, None)))
        st = jax.tree.map(np.asarray, self.procs[0].init_state())
        self.jstate = _batched(st)
        self.tstate = state_from_jax(self.jstate, "cpu")
        self.overrides = {"rate": RATES}
        self.worst = 0.0

    def call(self, name, *args):
        for n in self.nodes:
            getattr(n, name)(*args)

    def params(self):
        """Both packages' param snapshots, batched, with the per-instance
        overrides; they must be equal."""
        p = [_batched(jax.tree.map(np.asarray, proc.collect_params()))
             for proc in self.procs]
        for tree in p:
            for k, v in self.overrides.items():
                tree[k] = np.asarray(v, tree[k].dtype)
        tp = params_from_jax(p[1], "cpu")
        assert_state_equal(state_to_numpy(tp), _np(p[0]))
        return p[0], tp

    def blocks(self, n):
        """Render ``n`` blocks in both; compare every block and the state."""
        outs = []
        empty = np.zeros((B, 0, F), np.float32)
        emask = np.zeros((B, 0), bool)
        for _ in range(n):
            jp, tp = self.params()
            jo, self.jstate, jm = self.jkernel(
                jp, self.jstate, jnp.asarray(empty), jnp.asarray(emask),
                JBlockInfo.make())
            to, self.tstate, tm = self.procs[1].kernel(
                tp, self.tstate, torch.from_numpy(empty),
                torch.from_numpy(emask), TBlockInfo.make())
            err = float(np.abs(to.numpy() - np.asarray(jo)).max())
            self.worst = max(self.worst, err)
            assert err <= TOL, err
            np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
            assert_state_equal(state_to_numpy(self.tstate), _np(self.jstate))
            outs.append(to.numpy())
        return np.concatenate(outs, axis=-1)


def _batched(tree):
    return jax.tree.map(
        lambda x: np.broadcast_to(np.asarray(x), (B,) + np.shape(x)).copy(), tree)


def _np(tree):
    return state_to_numpy(state_from_jax(jax.tree.map(np.asarray, tree), "cpu"))


def assert_state_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            assert_state_equal(a[k], b[k])
        elif a[k].dtype.kind == "f":
            np.testing.assert_allclose(a[k], b[k], atol=TOL, rtol=0, err_msg=k)
        else:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _clip(frames=1000, channels=2, seed=7):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((channels, frames)).astype(np.float32)


@pytest.mark.parametrize("loop", ["one-shot", "full", "range"])
@pytest.mark.parametrize("quality", ["linear", "cubic", "sinc8"])
def test_playback_matches_jax(quality, loop):
    """Each interpolator, looped and not, at four rates, over 12 blocks:
    the one-shots at rates > 0.75 finish inside them."""
    pair = Pair(_clip(), quality)
    if loop != "one-shot":
        for n, lr in zip(pair.nodes, (JLoopRange, TLoopRange)):
            n.set_loop_range(lr.FULL if loop == "full"
                             else lr.range_secs(300 / SR, 900 / SR))
    pair.call("play")
    out = pair.blocks(12)
    assert np.abs(out).max() > 0.1
    st = state_to_numpy(pair.tstate)
    if loop == "one-shot":
        assert st["finish_count"].tolist() == [1, 1, 1, 1]
        assert st["ended"].all() and (out[..., -F:] == 0).all()
    else:
        assert (st["loop_count"] > 0).all() and not st["ended"].any()


def test_playhead_below_the_loop_plays_through():
    pair = Pair(_clip(), "cubic")
    for n, lr in zip(pair.nodes, (JLoopRange, TLoopRange)):
        n.set_loop_range(lr.range_secs(600 / SR, 900 / SR))
    pair.call("set_playhead", 100 / SR)
    pair.call("play")
    pair.blocks(10)
    st = state_to_numpy(pair.tstate)
    assert (st["loop_count"] > 0).all()
    assert ((st["playhead"] >= 600) & (st["playhead"] < 900)).all()


def test_seek_retrigger_pause_and_stop():
    pair = Pair(_clip(frames=700), "cubic")
    pair.call("play")
    pair.blocks(2)
    pair.call("set_playhead", 400 / SR)       # seek mid-playback
    pair.blocks(1)
    pair.call("pause")                         # freezes the playhead
    frozen = state_to_numpy(pair.tstate)["playhead"].copy()
    pair.blocks(2)
    np.testing.assert_array_equal(state_to_numpy(pair.tstate)["playhead"], frozen)
    pair.call("play")
    pair.blocks(6)                             # every instance finishes
    assert state_to_numpy(pair.tstate)["ended"].all()
    pair.call("play")                          # a message: retriggers
    out = pair.blocks(1)
    assert np.abs(out).max() > 0.1
    pair.call("stop")                          # rewinds to the loop start
    pair.blocks(1)
    st = state_to_numpy(pair.tstate)
    assert (st["seek_seq"] == 3).all() and (st["play_seq"] == 3).all()
    assert (st["finish_count"] == 1).all()


def test_envelope_and_gain_changes():
    pair = Pair(_clip(frames=4000), "linear")
    pair.call("set_envelope", 0.002, 0.003)
    pair.call("play")
    pair.blocks(3)
    pair.call("set_percent_volume", 40.0)
    pair.blocks(2)
    pair.call("pause")                         # a release fade, then frozen
    pair.blocks(4)
    assert pair.worst <= TOL


def test_mono_clip_into_stereo_and_extra_outputs():
    pair = Pair(_clip(channels=1), "sinc8", num_outputs=3)
    pair.call("play")
    pair.blocks(2)
    pair = Pair(_clip(channels=1), "linear", num_outputs=2)
    pair.call("play")
    out = pair.blocks(2)
    np.testing.assert_array_equal(out[:, 0], out[:, 1])


def test_uint32_playhead_wraps_like_jax():
    """A playhead near 2^32: the position sum wraps in uint32 (the port
    masks its int64 carrier), and one-shot positions past the wrap read the
    clip's head, as in the JAX package."""
    pair = Pair(_clip(), "cubic")
    pair.call("play")
    near = np.array([2**32 - 50, 2**32 - 1, 2**32 - 200, 5], np.uint32)
    pair.jstate["playhead"] = near
    pair.tstate["playhead"] = torch.from_numpy(near.astype(np.int64))
    pair.jstate["play_seq"] = pair.jstate["play_seq"] + 1
    pair.tstate["play_seq"] = pair.tstate["play_seq"] + 1
    pair.blocks(3)


def test_sample_resource_matches_jax():
    rng = np.random.default_rng(3)
    i16 = rng.integers(-32768, 32768, 64, dtype=np.int64).astype(np.int16)
    u16 = rng.integers(0, 65536, 64, dtype=np.int64).astype(np.uint16)
    for make in ("from_interleaved_i16", "from_interleaved_u16"):
        data = i16 if make.endswith("i16") else u16
        j = getattr(jsr.SampleResource, make)(data, 2, device=False)
        t = getattr(tsr.SampleResource, make)(data, 2)
        np.testing.assert_array_equal(t.host_data, j.host_data)
        np.testing.assert_array_equal(t.data.numpy(), j.host_data)
        assert (t.num_channels, t.len_frames) == (2, 32)
    x = np.concatenate([np.linspace(-1.2, 1.2, 301, dtype=np.float32),
                        np.float32([0.5 / 32767, 1.5 / 32767, -2.5 / 32767])])
    np.testing.assert_array_equal(tsr.pcm_f32_to_i16(x).numpy(),
                                  np.asarray(jsr.pcm_f32_to_i16(x)))
    clip = _clip(frames=50)
    jb, tb = np.ones((3, 64), np.float32), np.ones((3, 64), np.float32)
    jsr.SampleResource(clip, device=False).fill_buffers(jb, range(4, 64), 10)
    tsr.SampleResource(clip).fill_buffers(tb, range(4, 64), 10)
    np.testing.assert_array_equal(tb, jb)


def test_timeline_params_are_not_ported():
    """``collect_params(start_sample=...)`` folds the commands scheduled
    with ``at_sample=`` into the same five per-block timelines as the JAX
    package: a play mid-block (with its sample offset), a stop, a seek and
    a pause inside a 6-block dispatch, and a play past it that stays
    queued.  Without a start sample the commands stay queued."""
    from firewheel_tpu.executor import PerBlock as JPerBlock
    from firewheel_tpu_torch.executor import PerBlock as TPerBlock

    clip = _clip(frames=4 * F)
    procs = []
    for mod, node in ((jsr, JSamplerNode()), (tsr, TSamplerNode())):
        node.set_sample(mod.SampleResource(clip))
        node.set_loop_range(None)
        start = 10 * F
        node.play(at_sample=start + F + 37)
        node.stop(at_sample=start + 3 * F)
        node.set_playhead(0.001, at_sample=start + 3 * F + 5)
        node.play(at_sample=start + 4 * F)
        node.pause(at_sample=start + 5 * F + 1)
        node.play(at_sample=start + 6 * F)
        procs.append(node.activate(SR, F, 0, 2))
    jp, tp = (p.collect_params() for p in procs)
    assert len(procs[1]._node._scheduled) == 6
    jp, tp = (p.collect_params(blocks=6, start_sample=10 * F) for p in procs)
    for key, jv in jp.items():
        tv = tp[key]
        if isinstance(jv, JPerBlock):
            assert isinstance(tv, TPerBlock), key
            np.testing.assert_array_equal(tv.values, jv.values, err_msg=key)
        elif key != "sample":
            np.testing.assert_array_equal(np.asarray(tv), np.asarray(jv), err_msg=key)
    assert tp["start_offset"].values.tolist() == [0, 37, 0, 0, 0, 0]
    assert tp["playing"].values.tolist() == [False, True, True, False, True, False]
    assert procs[1]._node._scheduled == procs[0]._node._scheduled == [
        (16 * F, "play", None)]
