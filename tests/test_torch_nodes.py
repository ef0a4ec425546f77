"""The port's node kernels and core helpers, held against the JAX package
on the CPU.

Each node kernel gets the same inputs, params and state (made from a numpy
seed) in both packages, with a leading batch axis of instances (``vmap`` on
the JAX side, a plain leading dimension in the port), under silent,
audible and mixed input masks.  Tolerance 1e-6 absolute: the arithmetic is
the same float32 ops in the same order; torch's and XLA's f32 transcendentals
(sin, cos, exp) may differ by an ulp on values of magnitude ≤ 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reference_dsp as ref
from firewheel_tpu.core import node as jnode
from firewheel_tpu.core import smoother as jsm
from firewheel_tpu import nodes as jn
from firewheel_tpu_torch import nodes as tn
from firewheel_tpu_torch.convert import params_from_jax, state_from_jax, state_to_numpy
from firewheel_tpu_torch.core import node as tnode
from firewheel_tpu_torch.core import smoother as tsm

SR = 48000
F = 128
B = 4
TOL = 1e-6
MASKS = ["audible", "silent", "mixed"]


def _mask(kind, rng, shape):
    if kind == "audible":
        return np.zeros(shape, bool)
    if kind == "silent":
        return np.ones(shape, bool)
    m = rng.random(shape) < 0.5
    m.reshape(-1)[0] = False  # at least one audible and one silent channel
    m.reshape(-1)[-1] = True
    return m


def _batched(tree):
    """One instance's JAX tree → B identical copies as numpy leaves."""
    return jax.tree.map(
        lambda x: np.broadcast_to(np.asarray(x), (B,) + np.shape(x)).copy(), tree
    )


def _normalize(tree):
    """Either package's state → nested dicts of numpy (the port's form)."""
    return state_to_numpy(state_from_jax(jax.tree.map(np.asarray, tree), "cpu"))


def _assert_trees_close(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_close(a[k], b[k])
        else:
            assert a[k].dtype == b[k].dtype, (k, a[k].dtype, b[k].dtype)
            np.testing.assert_allclose(a[k], b[k], atol=TOL, rtol=0, err_msg=k)


def run_both(jnode_obj, tnode_obj, nin, nout, params, state, x, mask):
    """Run one block through both kernels; compare outputs, masks, state."""
    jp = jnode_obj.activate(SR, F, nin, nout)
    tp = tnode_obj.activate(SR, F, nin, nout)
    jout, jst, jmask = jax.vmap(jp.kernel, in_axes=(0, 0, 0, 0, None))(
        params, state, jnp.asarray(x), jnp.asarray(mask), jnode.BlockInfo.make()
    )
    tout, tst, tmask = tp.kernel(
        params_from_jax(params, "cpu"), state_from_jax(state, "cpu"),
        torch.from_numpy(x), torch.from_numpy(mask), tnode.BlockInfo.make(),
    )
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=TOL, rtol=0)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    _assert_trees_close(state_to_numpy(tst), _normalize(jst))
    return tout.numpy(), state_to_numpy(tst), tmask.numpy()


def _smoother_states(rng, base):
    """Per-instance smoother states: settled, ramping, deactivating."""
    target = np.array([base, base * 0.5, base, 0.0], np.float32)
    last = np.array([base, base * 0.9, base, 0.3], np.float32)
    status = np.array([0, 1, 2, 1], np.int32)
    return jsm.SmootherState(target=target, last=last, status=status)


@pytest.mark.parametrize("mask_kind", MASKS)
def test_beep(mask_kind):
    rng = np.random.default_rng(1)
    node = jn.BeepTestNode(440.0, -12.0, True)
    params = _batched(node.activate(SR, F, 0, 2).collect_params())
    params["enabled"] = np.array([True, False, True, True])
    params["inc"] = rng.integers(0, 2**32, B, dtype=np.uint64).astype(np.uint32)
    params["gain"] = rng.uniform(0.0, 1.0, B).astype(np.float32)
    state = {"phase": rng.integers(0, 2**32, B, dtype=np.uint64).astype(np.uint32)}
    x = np.zeros((B, 0, F), np.float32)
    out, st, om = run_both(node, tn.BeepTestNode(440.0, -12.0, True), 0, 2,
                           params, state, x, np.zeros((B, 0), bool))
    # and against the golden fixed-point reference, instance by instance
    for b in range(B):
        rout, rphase, rmask = ref.ref_beep(
            int(state["phase"][b]), bool(params["enabled"][b]),
            float(params["gain"][b]), int(params["inc"][b]), 2, F,
        )
        np.testing.assert_allclose(out[b], rout, atol=TOL, rtol=0)
        assert int(st["phase"][b]) == rphase
        np.testing.assert_array_equal(om[b], rmask)


@pytest.mark.parametrize("mask_kind", MASKS)
def test_volume(mask_kind):
    rng = np.random.default_rng(2)
    node = jn.VolumeNode(80.0)
    params = {"raw_gain": np.array([0.64, 0.0, 0.3, 1e-6], np.float32)}
    state = {"gain": _smoother_states(rng, 0.64)}
    x = rng.standard_normal((B, 2, F)).astype(np.float32)
    run_both(node, tn.VolumeNode(80.0), 2, 2, params, state, x,
             _mask(mask_kind, rng, (B, 2)))


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("nin", [1, 2])
def test_stereo_pan(mask_kind, nin):
    rng = np.random.default_rng(3)
    params = {"pan": np.array([-1.0, 0.3, 1.0, 0.0], np.float32)}
    state = {"pan": _smoother_states(rng, 0.25)}
    x = rng.standard_normal((B, nin, F)).astype(np.float32)
    run_both(jn.StereoPanNode(0.25), tn.StereoPanNode(0.25), nin, 2, params,
             state, x, _mask(mask_kind, rng, (B, nin)))


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("nin", [38, 2])
def test_sum(mask_kind, nin):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, nin, F)).astype(np.float32)
    mask = _mask(mask_kind, rng, (B, nin))
    out, _, om = run_both(jn.SumNode(), tn.SumNode(), nin, 2, {}, {}, x, mask)
    for b in range(B):  # the golden left-to-right sum, exactly
        rout, rmask = ref.ref_sum(np.where(mask[b][:, None], 0, x[b]), mask[b], 2)
        if mask[b].all():
            np.testing.assert_array_equal(out[b], rout)
        np.testing.assert_array_equal(om[b], rmask)


@pytest.mark.parametrize("mask_kind", MASKS)
def test_filter(mask_kind):
    """JAX's Pallas backend (interpret mode) against the port's sequential
    biquad, with a different cutoff and Q per instance."""
    rng = np.random.default_rng(5)
    params = {
        "freq": np.array([8000.0, 500.0, 12000.0, 60.0], np.float32),
        "q": np.array([0.7071, 4.0, 1.0, 0.5], np.float32),
        "gain_db": np.zeros(B, np.float32),
    }
    z = (0.05 * rng.standard_normal((2, B, 2))).astype(np.float32)
    z[:, 0] = 0.0  # a settled instance: silent input stays flagged silent
    state = {"z1": z[0], "z2": z[1]}
    x = rng.standard_normal((B, 2, F)).astype(np.float32)
    run_both(jn.FilterNode(jn.FilterType.LOWPASS, 8000.0, backend="pallas"),
             tn.FilterNode(tn.FilterType.LOWPASS, 8000.0, backend="pallas"),
             2, 2, params, state, x, _mask(mask_kind, rng, (B, 2)))


FILTER_TYPES = ["lowpass", "highpass", "bandpass", "notch", "allpass", "peaking",
                "low_shelf", "high_shelf"]


@pytest.mark.parametrize("filter_type", FILTER_TYPES)
def test_filter_scan_backend_is_not_ported(filter_type):
    """The associative-scan biquad (``FilterNode`` backends ``"scan"`` and
    ``"auto"``) against the JAX package's.  ``biquad_scan`` composes the
    same affine maps in ``lax.associative_scan``'s order, so with the same
    coefficients it equals JAX's op by op at 8 kHz and at 20 Hz (poles at
    the unit circle, where the scan amplifies every rounding), over 128 and
    127 frames.  ``FilterNode("scan")`` and ``"auto"`` then match JAX's
    node with per-instance cutoffs and Qs, and select the same backend
    (``group_key``)."""
    from firewheel_tpu.ops import iir as jiir
    from firewheel_tpu_torch.ops import iir as tiir

    rng = np.random.default_rng(9)
    shelf = filter_type in ("peaking", "low_shelf", "high_shelf")
    for freq in (8000.0, 20.0):
        args = (np.float32(freq), np.float32(0.7071)) + (
            (np.float32(6.0),) if shelf else ())
        coeffs = tuple(np.float32(c) for c in
                       getattr(jiir, "biquad_" + filter_type)(*args, SR))
        for frames in (128, 127):
            x = rng.standard_normal((B, 2, frames)).astype(np.float32)
            z = (0.1 * rng.standard_normal((2, B, 2))).astype(np.float32)
            jy, jz = jiir.biquad_scan(jnp.asarray(x), (jnp.asarray(z[0]), jnp.asarray(z[1])),
                                      jiir.BiquadCoeffs(*coeffs))
            ty, tz = tiir.biquad_scan(torch.from_numpy(x),
                                      (torch.from_numpy(z[0]), torch.from_numpy(z[1])),
                                      tiir.BiquadCoeffs(*map(torch.tensor, coeffs)))
            np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=TOL, rtol=0)
            for t, j in zip(tz, jz):
                np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=TOL, rtol=0)

    params = {
        "freq": np.array([8000.0, 500.0, 12000.0, 60.0], np.float32),
        "q": np.array([0.7071, 4.0, 1.0, 0.5], np.float32),
        "gain_db": np.array([0.0, 6.0, -6.0, 3.0], np.float32),
    }
    z = (0.05 * rng.standard_normal((2, B, 2))).astype(np.float32)
    x = rng.standard_normal((B, 2, F)).astype(np.float32)
    for backend in ("scan", "auto"):
        run_both(jn.FilterNode(filter_type, 8000.0, backend=backend),
                 tn.FilterNode(filter_type, 8000.0, backend=backend), 2, 2, params,
                 {"z1": z[0], "z2": z[1]}, x, _mask("mixed", rng, (B, 2)))
        assert (tn.FilterNode(filter_type, backend=backend).activate(SR, F, 2, 2)
                .group_key() == (filter_type, "scan"))
    assert (tn.FilterNode(filter_type, backend="pallas").activate(SR, F, 2, 2)
            .group_key() == (filter_type, "pallas"))


SCAN_DESIGNS = {
    "lowpass_8k": ("lowpass", (8000.0, 0.7071)),
    "low_shelf_150": ("low_shelf", (150.0, 0.8, 4.0)),
    "highpass_20": ("highpass", (20.0, 0.7071)),
}


@pytest.mark.parametrize("frames", [1, 3, 127, 128, 256])
@pytest.mark.parametrize("design", list(SCAN_DESIGNS))
def test_biquad_scan_reference_is_jax_bit_for_bit(design, frames):
    """``biquad_scan_reference`` (K7's plain version, ``ops/iir.py``)
    against JAX's ``biquad_scan`` op by op: the same compositions in
    ``lax.associative_scan``'s order give the same bits, output and state,
    for odd and even lengths, a resonant low shelf and a 20 Hz high-pass
    included."""
    from firewheel_tpu.ops import iir as jiir
    from firewheel_tpu_torch.ops import iir as tiir

    kind, args = SCAN_DESIGNS[design]
    rng = np.random.default_rng(frames)
    coeffs = tuple(np.float32(c) for c in getattr(jiir, "biquad_" + kind)(*args, SR))
    x = rng.standard_normal((B, 2, frames)).astype(np.float32)
    z = (0.1 * rng.standard_normal((2, B, 2))).astype(np.float32)
    jy, jz = jiir.biquad_scan(jnp.asarray(x), (jnp.asarray(z[0]), jnp.asarray(z[1])),
                              jiir.BiquadCoeffs(*coeffs))
    ty, tz = tiir.biquad_scan_reference(torch.from_numpy(x),
                                        (torch.from_numpy(z[0]), torch.from_numpy(z[1])),
                                        tiir.BiquadCoeffs(*map(torch.tensor, coeffs)))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    for t, j in zip(tz, jz):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("mask_kind", MASKS)
def test_echo(mask_kind):
    rng = np.random.default_rng(6)
    params = {
        "feedback": np.array([0.3, 0.0, 0.9, 0.5], np.float32),
        "wet": np.array([0.5, 1.0, 0.2, 0.0], np.float32),
        "dry": np.array([1.0, 0.5, 0.0, 1.0], np.float32),
    }
    line = rng.standard_normal((B, 2, 480)).astype(np.float32)
    line[0] = 0.0  # a quiet line: silent input stays flagged silent
    x = rng.standard_normal((B, 2, F)).astype(np.float32)
    run_both(jn.EchoNode(delay_secs=0.01), tn.EchoNode(delay_secs=0.01), 2, 2,
             params, {"line": line}, x, _mask(mask_kind, rng, (B, 2)))


@pytest.mark.parametrize("mask_kind", MASKS)
def test_hard_clip(mask_kind):
    rng = np.random.default_rng(7)
    params = {"threshold": np.array([1.0, 0.5, 0.0, 2.0], np.float32)}
    state = {"clip_count": rng.integers(0, 1000, B).astype(np.int32)}
    x = (2.0 * rng.standard_normal((B, 2, F))).astype(np.float32)
    run_both(jn.HardClipNode(0.0), tn.HardClipNode(0.0), 2, 2, params, state,
             x, _mask(mask_kind, rng, (B, 2)))


@pytest.mark.parametrize("mask_kind", MASKS)
def test_db_meter(mask_kind):
    rng = np.random.default_rng(8)
    state = {
        "peak": rng.uniform(0.0, 1.0, (B, 2)).astype(np.float32),
        "rms_sq": rng.uniform(0.0, 0.5, (B, 2)).astype(np.float32),
    }
    x = rng.standard_normal((B, 2, F)).astype(np.float32)
    run_both(jn.DbMeterNode(), tn.DbMeterNode(), 2, 2, {}, state, x,
             _mask(mask_kind, rng, (B, 2)))


@pytest.mark.parametrize("mask_kind", MASKS)
def test_db_meter_sink(mask_kind):
    """``DbMeterNode`` with 0 outputs (a metering sink) meters its inputs
    and outputs nothing, as the JAX package's ``_SinkMeterProcessor``."""
    rng = np.random.default_rng(10)
    state = {
        "peak": rng.uniform(0.0, 1.0, (B, 2)).astype(np.float32),
        "rms_sq": rng.uniform(0.0, 0.5, (B, 2)).astype(np.float32),
    }
    x = rng.standard_normal((B, 2, F)).astype(np.float32)
    run_both(jn.DbMeterNode(), tn.DbMeterNode(), 2, 0, {}, state, x,
             _mask(mask_kind, rng, (B, 2)))


def test_node_kernels_take_no_batch_axis():
    """The same kernels with no leading axis (one instance, as
    ``ScheduleProgram.render_block`` runs them)."""
    node = tn.VolumeNode(50.0)
    proc = node.activate(SR, F, 2, 2)
    x = torch.ones((2, F))
    out, st, om = proc.kernel(
        params_from_jax(proc.collect_params(), "cpu"), proc.init_state(), x,
        torch.zeros(2, dtype=torch.bool), tnode.BlockInfo.make(),
    )
    assert out.shape == (2, F) and om.shape == (2,)
    np.testing.assert_allclose(out.numpy(), 0.25, atol=TOL)


# -- core helpers ---------------------------------------------------------------

def test_smoother_matches_golden_reference_and_jax():
    """A run of blocks with target changes, settling and deactivation,
    against ``ref_smoother_set_and_process`` and the JAX kernel."""
    coeffs = tsm.smoother_coeffs(SR)
    targets = [0.5, 0.5, 0.5, 0.1, 0.1, 0.9] + [0.9] * 60
    t_state = tsm.smoother_init(torch.tensor(0.0))
    j_state = jsm.smoother_init(np.float32(0.0))
    r_state = ref.ref_smoother_init(0.0)
    for val in targets:
        tv, t_state, t_sm = tsm.smoother_set_and_process(
            t_state, torch.tensor(val, dtype=torch.float32), F, coeffs)
        jv, j_state, j_sm = jsm.smoother_set_and_process(
            j_state, jnp.float32(val), F, coeffs)
        rv, r_state, r_sm = ref.ref_smoother_set_and_process(r_state, val, F, SR)
        np.testing.assert_allclose(tv.numpy(), rv, atol=TOL, rtol=0)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=TOL, rtol=0)
        assert bool(t_sm) == bool(j_sm)
        assert int(t_state["status"]) == int(j_state.status) == r_state[2]
        np.testing.assert_allclose(float(t_state["last"]), float(r_state[1]),
                                   atol=TOL, rtol=0)
    assert int(t_state["status"]) == tsm.SMOOTHER_INACTIVE


@pytest.mark.parametrize("sample", [0, 1, 65535, 65536, 2**30 + 7, 2**32 - 1])
def test_stream_clock_matches_jax(sample):
    t = tnode.stream_time_from_sample(
        torch.tensor([tnode.wrap_stream_sample(sample)]), 48000.0)
    j = jnode.stream_time_from_sample(jnode.wrap_stream_sample(sample), 48000.0)
    assert float(t[0]) == float(j)  # same 16-bit split, same f32 ops


def test_wrap_stream_sample_wraps_like_jax():
    for s in (0, 2**32 - 1, 2**32, 2**40 + 123):
        assert tnode.wrap_stream_sample(s) == int(jnode.wrap_stream_sample(s))
    t = tnode.wrap_stream_sample(torch.tensor([2**32 + 5, -1]))
    assert t.tolist() == [5, 2**32 - 1]


def test_gate_is_a_real_select():
    x = torch.tensor([[float("nan"), 1.0], [2.0, float("inf")]])
    out = tnode.gate(x, torch.tensor([True, False]))
    assert out[0].tolist() == [0.0, 0.0]  # NaN never leaks through silence
    assert out[1, 0] == 2.0 and torch.isinf(out[1, 1])


def test_db_meter_read_matches_jax():
    state = {"peak": np.array([0.5, 0.0], np.float32),
             "rms_sq": np.array([0.04, 1e-12], np.float32)}
    j = jn.DbMeterNode.read(state)
    t = tn.DbMeterNode.read(state_from_jax(state, "cpu"))
    for k in ("peak_db", "rms_db"):
        np.testing.assert_allclose(t[k], np.asarray(j[k]), atol=TOL, rtol=0)
    assert t["rms_db"][1] == -100.0
