"""The spatial slice's ops and nodes, held against the JAX package on the
CPU.

* ``one_pole_scan``: the same associative scan in ``lax.associative_scan``'s
  combine order, with the fused multiply-adds XLA makes on the CPU written
  out: equal to JAX's under ``jit`` bit for bit at 127, 128, 256 and 1024
  frames; at 1 and 3 frames XLA fuses another way (``b·y_prev + a·x`` at
  1), an ulp apart, so 1e-6 there.  ``one_pole_coeffs`` and
  ``spatial_params`` exactly on the numpy path (the host staging), 1e-6 on
  the tensor path.
* ``Spatializer3DProcessor.kernel`` and ``BinauralSpatializerProcessor.
  kernel`` against JAX's under ``jit(vmap)`` over four blocks with the
  state carried: 1e-6 on audio and float state (XLA contracts the gather's
  interpolation and the shadow section into FMAs that torch rounds
  separately; torch's and XLA's sin/cos/exp may differ by an ulp), masks and
  integer state equal.  The doppler and binaural cases feed a 187.5 Hz
  sine (zero at every block boundary, where the input may fall silent),
  not noise: their taps sit a ramped delay back, and XLA's exp and torch's
  differ by an ulp in the ramp, which moves a doppler tap by ~1e-4 samples
  and an ear's by ~1e-5: on white noise that is up to 1e-4 of output, on a
  smooth input (the scene's beeps) below 1e-6.
* The staged params (``collect_params``, ``stage``) equal JAX's bit for bit.
* ``sequential_kernel`` (the megakernel's recurrence) against ``kernel``
  (the scan): 1e-6, the two round the one-pole differently.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from firewheel_tpu import nodes as jn
from firewheel_tpu.core import node as jnode
from firewheel_tpu.ops import iir as jiir
from firewheel_tpu.ops import pan as jpan
from firewheel_tpu_torch import nodes as tn
from firewheel_tpu_torch.convert import params_from_jax, state_from_jax, state_to_numpy
from firewheel_tpu_torch.core import node as tnode
from firewheel_tpu_torch.ops import iir as tiir
from firewheel_tpu_torch.ops import pan as tpan

SR, F, B = 48000, 128, 4
TOL = 1e-6
# float state also passes within one float32 ulp: the binaural delay
# smoothers hold samples (~20), where an ulp is 2e-6
STATE_RTOL = 2.0 ** -23
BLOCKS = 4


# -- ops ------------------------------------------------------------------------

@pytest.mark.parametrize("frames", [1, 3, 127, 128, 256, 1024])
@pytest.mark.parametrize("case", ["per_row", "ear_column", "scalar"])
@pytest.mark.parametrize("carried", [False, True])
def test_one_pole_scan_matches_jax(frames, case, carried):
    """``per_row``: one (a, b) per row, as the spatializer passes them
    (``[B, 1]`` in the port, a scalar under ``vmap`` in JAX); ``ear_column``:
    ``a = 1`` and ``b`` shaped ``[2, 1]``, as the binaural node passes
    ``-a1``; ``scalar``: Python floats."""
    rng = np.random.default_rng(frames)
    x = rng.standard_normal((B if case != "ear_column" else 2, frames)).astype(np.float32)
    y0 = (rng.standard_normal(x.shape[0]) if carried else np.zeros(x.shape[0])).astype(
        np.float32)
    if case == "per_row":
        b = rng.uniform(0.05, 0.99, x.shape[0]).astype(np.float32)
        a = np.float32(1.0) - b
        jy, jl = jax.jit(jax.vmap(jiir.one_pole_scan))(x, y0, a, b)
        ty, tl = tiir.one_pole_scan(torch.from_numpy(x), torch.from_numpy(y0),
                                    torch.from_numpy(a)[:, None],
                                    torch.from_numpy(b)[:, None])
    elif case == "ear_column":
        b = rng.uniform(-0.9, 0.9, (2, 1)).astype(np.float32)
        jy, jl = jax.jit(lambda x, y, b: jiir.one_pole_scan(x, y, jnp.float32(1.0), b))(
            x, y0, b)
        ty, tl = tiir.one_pole_scan(torch.from_numpy(x), torch.from_numpy(y0), 1.0,
                                    torch.from_numpy(b))
    else:
        jy, jl = jax.jit(lambda x, y: jiir.one_pole_scan(x, y, 0.25, 0.75))(x, y0)
        ty, tl = tiir.one_pole_scan(torch.from_numpy(x), torch.from_numpy(y0), 0.25, 0.75)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL, rtol=0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    if frames not in (1, 3):
        np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    # and it is the recurrence
    ref, y = np.zeros(x.shape, np.float64), y0.astype(np.float64)
    aa = (np.float64(1.0) - b.astype(np.float64)) if case == "per_row" else (
        1.0 if case == "ear_column" else 0.25)
    bb = b.astype(np.float64) if case != "scalar" else 0.75
    for n in range(frames):
        y = np.reshape(aa, (-1,)) * x[:, n] + np.reshape(bb, (-1,)) * y
        ref[:, n] = y
    np.testing.assert_allclose(ty.numpy(), ref, atol=1e-5, rtol=0)


def test_one_pole_coeffs_match_jax():
    cut = np.float32([20.0, 350.0, 1200.0, 20000.0])
    for c in cut:
        ja, jb = jiir.one_pole_coeffs(c, SR)
        ta, tb = tiir.one_pole_coeffs(c, SR)
        assert (ta, tb) == (ja, jb) and ta.dtype == np.float32
    ja, jb = jiir.one_pole_coeffs(jnp.asarray(cut), SR)
    ta, tb = tiir.one_pole_coeffs(torch.from_numpy(cut), SR)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=TOL, rtol=0)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=TOL, rtol=0)


POSITIONS = [(0.0, 0.0, -1.0), (3.0, 0.0, -4.0), (-2.5, 1.0, 6.0), (0.0, 5.0, 0.0),
             (0.0, 0.0, 0.0), (0.05, 0.0, 0.02), (40.0, -3.0, -90.0), (-1.0, 0.0, 0.0)]


@pytest.mark.parametrize("pos", POSITIONS)
@pytest.mark.parametrize("law", [(1.0, 1.0), (2.0, 0.5)])
def test_spatial_params_match_jax(pos, law):
    ref, roll = law
    p = np.asarray(pos, np.float32)
    want = jpan.spatial_params(p, ref_distance=ref, rolloff=roll)
    got = tpan.spatial_params(p, ref_distance=ref, rolloff=roll)
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g == w, (got, want)
    want = jpan.spatial_params(jnp.asarray(p), ref_distance=ref, rolloff=roll)
    got = tpan.spatial_params(torch.from_numpy(p), ref_distance=ref, rolloff=roll)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=0)
    # a batch of positions at once, as the host staging of a batch does
    batch = tpan.spatial_params(np.stack([p, p[::-1]]), ref_distance=ref, rolloff=roll)
    for g, w in zip(batch, tpan.spatial_params(p, ref_distance=ref, rolloff=roll)):
        assert g[0] == w


def test_mid_side_round_trip():
    rng = np.random.default_rng(5)
    l, r = (torch.from_numpy(rng.standard_normal(64).astype(np.float32)) for _ in range(2))
    m, s = tpan.mid_side_split(l, r)
    jm, js = jpan.mid_side_split(jnp.asarray(l.numpy()), jnp.asarray(r.numpy()))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    l2, r2 = tpan.mid_side_merge(m, s)
    np.testing.assert_allclose(l2.numpy(), l.numpy(), atol=TOL)
    np.testing.assert_allclose(r2.numpy(), r.numpy(), atol=TOL)


# -- nodes ----------------------------------------------------------------------

def _normalize(tree):
    return state_to_numpy(state_from_jax(jax.tree.map(np.asarray, tree), "cpu"))


def _assert_trees_close(a, b, path=()):
    assert a.keys() == b.keys(), path
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_close(a[k], b[k], path + (k,))
        elif a[k].dtype.kind == "f":
            np.testing.assert_allclose(a[k], b[k], atol=TOL, rtol=STATE_RTOL,
                                       err_msg=str(path + (k,)))
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=str(path + (k,)))


def _stack(trees):
    return jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *trees)


def _drive(make, moves, silent_from=None, blocks=BLOCKS, seed=0, smooth=False):
    """Render ``blocks`` blocks of B instances through the JAX kernel
    (``jit(vmap)``) and the port's, the state carried in each; before block
    ``k`` each instance's node takes ``moves(node, b, k)``, then its params
    are collected.  The input is noise, or with ``smooth`` a 187.5 Hz sine;
    from block ``silent_from`` it is zero and flagged silent.  Returns the port's outputs, masks and states per block and the
    port's processors."""
    rng = np.random.default_rng(seed)
    pairs = [(make(jn), make(tn)) for _ in range(B)]
    jprocs = [j.activate(SR, F, 1, 2) for j, _ in pairs]
    tprocs = [t.activate(SR, F, 1, 2) for _, t in pairs]
    jstate = _stack([p.init_state() for p in jprocs])
    tstate = state_from_jax(_normalize(jstate), "cpu")
    _assert_trees_close(state_to_numpy(tstate), _normalize(
        _stack([p.init_state() for p in tprocs])))
    jk = jax.jit(jax.vmap(jprocs[0].kernel, in_axes=(0, 0, 0, 0, None)))
    runs = []
    for k in range(blocks):
        for b, (jnode_, tnode_) in enumerate(pairs):
            moves(jnode_, b, k)
            moves(tnode_, b, k)
        jparams = _stack([p.collect_params() for p in jprocs])
        tparams = _stack([p.collect_params() for p in tprocs])
        for leaf in jparams:
            np.testing.assert_array_equal(tparams[leaf], jparams[leaf], err_msg=leaf)
        x = (0.5 * rng.standard_normal((B, 1, F))).astype(np.float32)
        if smooth:
            t = (k * F + np.arange(F)) / SR
            x[:] = (0.25 * np.sin(2 * np.pi * 187.5 * t)).astype(np.float32)
        mask = np.zeros((B, 1), bool)
        if silent_from is not None and k >= silent_from:
            x[:] = 0.0
            mask[:] = True
        jo, jstate, jm = jk(jparams, jstate, jnp.asarray(x), jnp.asarray(mask),
                            jnode.BlockInfo.make())
        to, tstate, tm = tprocs[0].kernel(params_from_jax(tparams, "cpu"), tstate,
                                          torch.from_numpy(x), torch.from_numpy(mask),
                                          tnode.BlockInfo.make())
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=TOL, rtol=0,
                                   err_msg=f"block {k}")
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm), err_msg=f"block {k}")
        _assert_trees_close(state_to_numpy(tstate), _normalize(jstate), (f"block {k}",))
        runs.append((to, tm, tstate, tparams, x, mask))
    return runs, tprocs


def _orbit(node, b, k):
    """Instance b's emitter, moved a little each block (the smoothers ramp)."""
    a = 0.4 * b + 0.3 * k
    r = 2.0 + b
    node.set_position((r * np.sin(a), 0.25 * k, -r * np.cos(a)))


def _still(node, b, k):
    if k == 0:
        node.set_position(POSITIONS[1 + b])


SPATIAL_CASES = {
    "static": (lambda m: m.Spatializer3DNode(), _still, None),
    "moving": (lambda m: m.Spatializer3DNode(volume_gain=0.8), _orbit, None),
    "occluded": (lambda m: m.Spatializer3DNode(occlusion_db=24.0),
                 lambda n, b, k: (n.set_occlusion(0.25 * b + 0.1 * k), _orbit(n, b, k)),
                 None),
    "silent_tail": (lambda m: m.Spatializer3DNode(ref_distance=2.0, rolloff=0.5),
                    _orbit, 2),
    "doppler": (lambda m: m.Spatializer3DNode(doppler=True, max_distance_m=20.0),
                lambda n, b, k: n.set_position((0.0, 0.0, -(1.0 + b + 3.0 * k))), None),
    "doppler_drains": (lambda m: m.Spatializer3DNode(doppler=True, max_distance_m=4.0),
                       _still, 2),
}


@pytest.mark.parametrize("case", list(SPATIAL_CASES))
def test_spatializer_kernel_matches_jax(case):
    make, moves, silent_from = SPATIAL_CASES[case]
    runs, procs = _drive(make, moves, silent_from, blocks=6 if "drains" in case else BLOCKS,
                         smooth=case.startswith("doppler"))
    outs = torch.stack([r[0] for r in runs])
    masks = torch.stack([r[1] for r in runs])
    assert float(outs.abs().max()) > 0.01
    statuses = [r[2]["gain"]["status"] for r in runs]
    if case in ("moving", "occluded", "doppler"):
        assert any(bool((s == 1).any()) for s in statuses)  # the smoothers ramp
    if silent_from is None:
        assert not bool(masks.any())
    elif case == "silent_tail":
        # the block after the input falls silent still rings; then silence
        assert not bool(masks[silent_from].any()) and bool(masks[-1].all())
        assert float(outs[silent_from].abs().max()) > 0.0
        assert float(runs[-1][2]["lp"].abs().max()) == 0.0
    else:
        # the doppler line keeps the sound in flight until it drains
        assert not bool(masks[silent_from].any())
        assert procs[0]._ring_len == 1024


def test_doppler_opts_out_of_the_megakernel_and_pools_apart():
    plain = tn.Spatializer3DNode().activate(SR, F, 1, 2)
    dop = tn.Spatializer3DNode(doppler=True).activate(SR, F, 1, 2)
    jdop = jn.Spatializer3DNode(doppler=True).activate(SR, F, 1, 2)
    assert plain.supports_megakernel and not dop.supports_megakernel
    assert type(dop).supports_megakernel  # an instance attribute, as in JAX
    assert dop.group_key() == jdop.group_key() != plain.group_key()
    assert dop._ring_len == jdop._ring_len == 16384


def test_stage_is_collect_params_elementwise():
    """``stage`` over a batch gives, instance by instance, what the node's
    ``collect_params`` gives once it is set to that instance's values, and
    both are the JAX package's ``collect_params`` bit for bit."""
    rng = np.random.default_rng(7)
    for doppler in (False, True):
        node, jnode_ = tn.Spatializer3DNode(doppler=doppler), jn.Spatializer3DNode(
            doppler=doppler)
        proc, jproc = node.activate(SR, F, 1, 2), jnode_.activate(SR, F, 1, 2)
        pos = rng.uniform(-30.0, 30.0, (16, 3)).astype(np.float32)
        vol = rng.uniform(0.0, 2.0, 16)
        occ = rng.uniform(0.0, 1.0, 16) * (np.arange(16) % 2)
        staged = proc.stage(pos, vol, occ)
        for i in range(16):
            for n in (node, jnode_):
                n.set_position(pos[i])
                n.set_volume_gain(vol[i])
                n.set_occlusion(occ[i])
            want = jproc.collect_params()
            got = proc.collect_params()
            assert got.keys() == want.keys()
            for leaf in want:
                assert got[leaf] == want[leaf] == staged[leaf][i], (leaf, i)


BINAURAL_CASES = {
    "static": (lambda m: m.BinauralSpatializerNode(), _still, None),
    "moving": (lambda m: m.BinauralSpatializerNode(volume_gain=0.7), _orbit, None),
    "silent_tail": (lambda m: m.BinauralSpatializerNode(head_radius=0.1), _orbit, 2),
}


@pytest.mark.parametrize("case", list(BINAURAL_CASES))
def test_binaural_kernel_matches_jax(case):
    make, moves, silent_from = BINAURAL_CASES[case]
    runs, procs = _drive(make, moves, silent_from, blocks=6 if silent_from else BLOCKS,
                         smooth=True)
    outs = torch.stack([r[0] for r in runs])
    masks = torch.stack([r[1] for r in runs])
    assert float(outs.abs().max()) > 0.01
    assert not procs[0].supports_megakernel
    if silent_from is not None:
        assert not bool(masks[silent_from].any()) and bool(masks[-1].all())
    else:
        # the two ears differ (ITD and head shadow)
        assert not torch.equal(outs[..., 0, :], outs[..., 1, :])


@pytest.mark.parametrize("case", ["moving", "silent_tail"])
def test_sequential_kernel_matches_kernel(case):
    """The megakernel's recurrence against the scan on the same inputs and
    state, block by block: 1e-6 on audio and state, masks equal."""
    make, moves, silent_from = SPATIAL_CASES[case]
    runs, procs = _drive(make, moves, silent_from)
    proc = procs[0]
    state = state_from_jax(_normalize(_stack([p.init_state() for p in procs])), "cpu")
    for to, tm, tstate, tparams, x, mask in runs:
        args = (params_from_jax(tparams, "cpu"), state, torch.from_numpy(x),
                torch.from_numpy(mask), tnode.BlockInfo.make())
        so, sst, sm = proc.sequential_kernel(*args)
        ko, kst, km = proc.kernel(*args)
        np.testing.assert_allclose(so.numpy(), ko.numpy(), atol=TOL, rtol=0)
        assert torch.equal(sm, km)
        _assert_trees_close(state_to_numpy(sst), state_to_numpy(kst))
        state = kst


def test_one_pole_seq_is_the_recurrence():
    """``one_pole_seq`` steps ``y = fma(a, x, b·y_prev)``: against the same
    steps in float64 rounded as the kernel rounds them."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, F)).astype(np.float32)
    b = rng.uniform(0.05, 0.95, 3).astype(np.float32)
    a = np.float32(1.0) - b
    y0 = rng.standard_normal(3).astype(np.float32)
    y, last = tn.spatial.one_pole_seq(torch.from_numpy(x), torch.from_numpy(y0),
                                      torch.from_numpy(a), torch.from_numpy(b))
    ref = np.zeros_like(x)
    yy = y0.copy()
    for n in range(F):
        bz = (b * yy).astype(np.float32)
        yy = (a.astype(np.float64) * x[:, n] + bz).astype(np.float32)
        ref[:, n] = yy
    np.testing.assert_array_equal(y.numpy(), ref)
    np.testing.assert_array_equal(last.numpy(), ref[:, -1])


def test_activation_checks_ports():
    for cls in (tn.Spatializer3DNode, tn.BinauralSpatializerNode):
        with pytest.raises(tnode.NodeActivationError):
            cls().activate(SR, F, 2, 2)
