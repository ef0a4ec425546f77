"""The FX palette's nodes (``nodes/{eq,waveshaper,stereo_width,channel,
mod_effects,pitch_shift}.py``) and ``mixer.fx_palette_graph`` held against
the JAX package on the CPU.

Each node kernel gets the same seeded inputs, params and state in both
packages, B=4 instances (``vmap`` on the JAX side), under audible, silent
and mixed input masks (``test_torch_nodes.run_both``): outputs and float
state within 1e-6 absolute, masks and the rest equal.  The scans run
through the plain versions of K7 (``ops/iir.py``); the gathers, the LFOs
and the curves are the same float32 ops, torch's and XLA's tanh, atan and
cos an ulp apart at most.

The graph (``fx_palette_graph``: the voices, the example's six inserts in
series, a DC-blocked fold, stereo width and a pitch-shifted mono leg) is
rendered batched by both packages' ``BatchRenderer`` from the same params
and state (``convert.params_from_jax``/``state_from_jax``), and the
example's engine is streamed through both packages' ``FirewheelCtx`` across
FX switches: 1e-5, the repo's correctness limit.  JAX jits its renders and
XLA contracts some products into fused multiply-adds there; the EQ's scan,
whose low shelf amplifies that, runs op by op on both sides (see
``unfused_jax_eq``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import firewheel_tpu as fw
from firewheel_tpu import nodes as jn
from firewheel_tpu.parallel import BatchRenderer as JaxBatchRenderer
import firewheel_tpu_torch as ft
from firewheel_tpu_torch import mixer
from firewheel_tpu_torch import nodes as tn
from firewheel_tpu_torch.convert import params_from_jax, state_from_jax, state_to_numpy
from test_torch_examples import fresh_jax_programs
from test_torch_nodes import B, F, MASKS, SR, _batched, _mask, run_both

GRAPH_TOL = 1e-5


def _stack(snaps):
    return jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *snaps)


def _bands(nodes):
    return [
        nodes.EQBand(nodes.FilterType.LOW_SHELF, 150.0, 0.8, 4.0),
        nodes.EQBand(nodes.FilterType.PEAKING, 1500.0, 1.2, -6.0),
        nodes.EQBand(nodes.FilterType.HIGH_SHELF, 6000.0, 0.7, 3.0),
    ]


# -- the nodes -----------------------------------------------------------------

EQ_DISABLED = {"enabled": (), "one_disabled": (1,), "all_disabled": (0, 1, 2)}


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("case", list(EQ_DISABLED))
def test_parametric_eq(case, mask_kind):
    """The example's 3-band EQ, every instance with its own gains (its own
    staged coefficients); a disabled band is the identity section, and with
    every band disabled the node passes its input through."""
    rng = np.random.default_rng(21)
    jnode, tnode = jn.ParametricEQNode(_bands(jn)), tn.ParametricEQNode(_bands(tn))
    for i in EQ_DISABLED[case]:
        jnode.set_enabled(i, False)
        tnode.set_enabled(i, False)
    jp = jnode.activate(SR, F, 2, 2)
    snaps = []
    for b in range(B):
        for i in range(3):
            jnode.set_band(i, gain_db=float(rng.uniform(-12.0, 12.0)))
        snaps.append(jp.collect_params())
    params = _stack(snaps)
    z = (0.05 * rng.standard_normal((6, B, 2))).astype(np.float32)
    z[:, 0] = 0.0  # a settled instance: silent input stays flagged silent
    state = {f"z{k}_{i}": z[2 * i + k - 1] for i in range(3) for k in (1, 2)}
    x = rng.standard_normal((B, 2, F)).astype(np.float32)
    mask = _mask(mask_kind, rng, (B, 2))
    out, _, _ = run_both(jnode, tnode, 2, 2, params, state, x, mask)
    if case == "all_disabled":
        # the identity sections drain their state in two frames, then pass
        gated = mask & (np.abs(z).max(axis=0) < 1e-10)
        np.testing.assert_array_equal(out[..., 2:], np.where(gated[..., None], 0.0, x)[..., 2:])


BAND_TYPES = ["lowpass", "highpass", "bandpass", "notch", "allpass", "peaking",
              "low_shelf", "high_shelf"]


@pytest.mark.parametrize("band_type", BAND_TYPES)
def test_parametric_eq_stages_coefficients_like_jax(band_type):
    """Both packages stage each band's coefficients on the host in numpy
    float32 (torch's float32 sin, cos and pow differ from numpy's by an ulp
    or a few, which the low shelf's scan amplifies to ~3e-5 of output): bit
    for bit over random settings, under the same keys, a disabled band the
    identity."""
    rng = np.random.default_rng(BAND_TYPES.index(band_type))
    settings = [(float(rng.uniform(20.0, 20000.0)), float(rng.uniform(0.3, 5.0)),
                 float(rng.uniform(-15.0, 15.0))) for _ in range(20)]
    jnode = jn.ParametricEQNode([jn.EQBand(band_type, *v) for v in settings])
    tnode = tn.ParametricEQNode([tn.EQBand(band_type, *v) for v in settings])
    jnode.set_enabled(3, False)
    tnode.set_enabled(3, False)
    jb = jnode.activate(SR, F, 2, 2).collect_params()["bands"]
    tb = tnode.activate(SR, F, 2, 2).collect_params()["bands"]
    assert list(tb) == [str(i) for i in range(len(settings))]
    for i, band in enumerate(jb):
        assert tb[str(i)].keys() == band.keys()
        for k, v in band.items():
            assert tb[str(i)][k].dtype == np.float32
            assert tb[str(i)][k] == np.float32(v), (i, k)
    assert {k: float(v) for k, v in tb["3"].items()} == {
        "b0": 1.0, "b1": 0.0, "b2": 0.0, "a1": 0.0, "a2": 0.0}


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("dc_block", [False, True])
@pytest.mark.parametrize("curve", list(jn.waveshaper.SHAPES))
def test_waveshaper(curve, dc_block, mask_kind):
    """Every curve, with and without its DC blocker (the one-pole scan), a
    drive of 0 to 24 dB a instance (the fold wraps past ±3)."""
    rng = np.random.default_rng(22)
    node = (jn.WaveshaperNode(curve, 6.0, -3.0, 0.7, dc_block),
            tn.WaveshaperNode(curve, 6.0, -3.0, 0.7, dc_block))
    params = _batched(node[0].activate(SR, F, 2, 2).collect_params())
    params["drive"] = (10.0 ** (np.array([0.0, 6.0, 12.0, 24.0]) / 20.0)).astype(np.float32)
    params["mix"] = np.array([1.0, 0.7, 0.0, 0.4], np.float32)
    if dc_block:
        st = (0.1 * rng.standard_normal((2, B, 2))).astype(np.float32)
        st[:, 0] = 0.0
        state = {"x1": st[0], "y1": st[1]}
    else:
        state = ()
    x = rng.standard_normal((B, 2, F)).astype(np.float32)
    run_both(*node, 2, 2, params, state, x, _mask(mask_kind, rng, (B, 2)))


MOD_DELAYS = {
    "chorus": lambda n: n.ModDelayNode.chorus(rate_hz=0.9, mix=0.5),
    "vibrato": lambda n: n.ModDelayNode.vibrato(),
    "flanger": lambda n: n.ModDelayNode.flanger(feedback=0.6),
}


def _sine(rng, lead, start, frames):
    """187.5 Hz at a random phase a row, samples ``start .. start + frames``.
    The modulated taps sit a swept delay back, and XLA's cos and torch's
    differ by an ulp in the sweep, which moves a tap by ~1e-5 samples: on
    white noise up to ~2e-5 of output, on a smooth input below 1e-6."""
    ph = rng.uniform(0.0, 2.0 * np.pi, lead + (1,))
    n = np.arange(start, start + frames)
    return (0.5 * np.sin(2.0 * np.pi * 187.5 * n / SR + ph)).astype(np.float32)


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("frames", [128, 127])
@pytest.mark.parametrize("preset", list(MOD_DELAYS))
def test_mod_delay(preset, frames, mask_kind):
    """Chorus, vibrato and the flanger (its feedback loop over sub-blocks of
    32 frames; at 127 frames the tail sub-block is padded), rate, depth and
    feedback a instance, a line full of history (the input's own past) and
    an LFO mid-cycle."""
    rng = np.random.default_rng(23)
    jnode, tnode = MOD_DELAYS[preset](jn), MOD_DELAYS[preset](tn)
    jp = jnode.activate(SR, F, 2, 2)
    params = _batched(jp.collect_params())
    params["rate"] = (rng.uniform(0.1, 8.0, B) / SR).astype(np.float32)
    params["depth"] = (params["depth"] * rng.uniform(0.2, 1.0, B)).astype(np.float32)
    params["spread"] = np.array([0.0, 0.25, 0.5, 1.0], np.float32)
    if preset == "flanger":
        params["feedback"] = np.array([0.6, -0.9, 0.0, 0.95], np.float32)
    w = jp._window
    sig = _sine(rng, (B, 2), -w, w + frames)
    line, x = sig[..., :w].copy(), sig[..., w:].copy()
    line[0] = 0.0  # a quiet line: silent input stays flagged silent
    state = {"line": line, "phase": rng.uniform(0.0, 1.0, B).astype(np.float32)}
    run_both(jnode, tnode, 2, 2, params, state, x, _mask(mask_kind, rng, (B, 2)))


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("bipolar", [False, True])
def test_tremolo(bipolar, mask_kind):
    """The unipolar tremolo and the ring modulator, rate, depth and spread a
    instance."""
    rng = np.random.default_rng(24)
    node = (jn.TremoloNode(5.0, 0.8, 0.0, bipolar), tn.TremoloNode(5.0, 0.8, 0.0, bipolar))
    params = {
        "rate": (rng.uniform(0.5, 200.0, B) / SR).astype(np.float32),
        "depth": np.array([0.8, 1.0, 0.0, 0.3], np.float32),
        "spread": np.array([0.0, 0.25, 0.5, 1.0], np.float32),
    }
    state = {"phase": rng.uniform(0.0, 1.0, B).astype(np.float32)}
    x = rng.standard_normal((B, 2, F)).astype(np.float32)
    run_both(*node, 2, 2, params, state, x, _mask(mask_kind, rng, (B, 2)))


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("nch", [1, 2])
def test_pitch_shift(nch, mask_kind):
    """−12 to +12 semitones a instance over a ring full of history; instance
    0's ring is quiet, so a silent block resets its ring and phase (the
    all-silent reset) while the others ring on."""
    rng = np.random.default_rng(25)
    jnode, tnode = jn.PitchShiftNode(7.0, 0.5), tn.PitchShiftNode(7.0, 0.5)
    jp = jnode.activate(SR, F, nch, nch)
    params = _batched(jp.collect_params())
    params["ratio"] = (2.0 ** (np.array([7.0, -12.0, 12.0, 0.5]) / 12.0)).astype(np.float32)
    params["mix"] = np.array([0.5, 1.0, 0.3, 1.0], np.float32)
    ring = (0.2 * rng.standard_normal((B, nch, jp._window))).astype(np.float32)
    ring[0] = 0.0
    phase = rng.uniform(0.0, 1.0, B).astype(np.float32)
    x = rng.standard_normal((B, nch, F)).astype(np.float32)
    _, st, om = run_both(jnode, tnode, nch, nch, params, {"ring": ring, "phase": phase},
                         x, _mask(mask_kind, rng, (B, nch)))
    if mask_kind == "silent":
        assert om[0].all() and not om[1:].any()
        assert st["phase"][0] == 0.0 and not st["ring"][0].any()
        assert st["ring"][1:].any()


@pytest.mark.parametrize("mask_kind", MASKS)
def test_stereo_width(mask_kind):
    """Widths 0 (mono), 1, 2 and a ramp from 0.5; an all-silent block resets
    the smoother to its target."""
    from test_torch_nodes import _smoother_states

    rng = np.random.default_rng(26)
    params = {"width": np.array([0.0, 1.0, 2.0, 1.5], np.float32)}
    state = {"width": _smoother_states(rng, 0.5)}
    x = rng.standard_normal((B, 2, F)).astype(np.float32)
    run_both(jn.StereoWidthNode(1.0), tn.StereoWidthNode(1.0), 2, 2, params, state, x,
             _mask(mask_kind, rng, (B, 2)))


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("direction", ["mono_to_stereo", "stereo_to_mono"])
def test_channel_nodes(direction, mask_kind):
    rng = np.random.default_rng(27)
    nin, nout = (1, 2) if direction == "mono_to_stereo" else (2, 1)
    cls = "MonoToStereoNode" if direction == "mono_to_stereo" else "StereoToMonoNode"
    x = rng.standard_normal((B, nin, F)).astype(np.float32)
    run_both(getattr(jn, cls)(), getattr(tn, cls)(), nin, nout, {}, {}, x,
             _mask(mask_kind, rng, (B, nin)))


def test_fx_nodes_opt_out_of_the_megakernel():
    """Of the FX nodes only the flanger (the mod delay's feedback program)
    opts out of K2/K3, as in the JAX package: ``MegaRenderer`` refuses the
    palette for it and takes the palette without it."""
    from firewheel_tpu_torch.executor_mega import MegaRenderer

    prog = mixer.fx_palette_graph(num_voices=2, device="cpu")
    out = [type(p).__name__ for p in prog._procs.values() if not p.supports_megakernel]
    assert out == ["ModDelayProcessor"]
    (flanger,) = [p for p in prog._procs.values() if not p.supports_megakernel]
    assert flanger._fb_mode
    with pytest.raises(ValueError, match="not eligible for the megakernel"):
        MegaRenderer(prog, 1, 1, device="cpu")
    kinds = tuple(k for k in mixer.FX_KINDS if k != "flanger")
    MegaRenderer(mixer.fx_palette_graph(num_voices=2, device="cpu", kinds=kinds), 1, 1,
                 device="cpu")


# -- the graph, batched --------------------------------------------------------
#
# Under jit XLA contracts the products of JAX's associative-scan biquad into
# fused multiply-adds, and the EQ's 150 Hz low shelf (poles next to 1)
# amplifies those roundings to ~4e-4 of output (measured).  The port's plain
# scan is JAX's op by op (``lax.associative_scan`` unjitted), so in these
# renders the JAX EQ's ``biquad_scan`` runs op by op too: a host callback
# calls it with jit disabled, one instance at a time, inside the jitted
# render.  The rest of the graph stays jitted (≤ 4e-7 from the port).

@pytest.fixture
def unfused_jax_eq(monkeypatch):
    from firewheel_tpu.nodes import eq as jeq
    from firewheel_tpu.ops import iir as jiir

    def host(x, z1, z2, *coeffs):
        with jax.disable_jit():
            y, (o1, o2) = jiir.biquad_scan(
                jnp.asarray(x), (jnp.asarray(z1), jnp.asarray(z2)),
                jiir.BiquadCoeffs(*map(jnp.asarray, coeffs)))
        return np.asarray(y), np.asarray(o1), np.asarray(o2)

    def biquad_scan(x, z_prev, coeffs):
        shapes = (jax.ShapeDtypeStruct(x.shape, x.dtype),
                  *(jax.ShapeDtypeStruct(z.shape, z.dtype) for z in z_prev))
        y, o1, o2 = jax.pure_callback(host, shapes, x, *z_prev, *coeffs,
                                      vmap_method="sequential")
        return y, (o1, o2)

    fresh_jax_programs(monkeypatch)
    monkeypatch.setattr(jeq, "biquad_scan", biquad_scan)

def _fx_programs(num_voices):
    out = {}
    for pkg, mod, nodes in (("jax", fw, jn), ("port", ft, None)):
        g = mod.AudioGraph(mod.AudioGraphConfig(0, 2))
        mixer.add_fx_palette(g, num_voices, nodes=nodes)
        pk = g.compile(SR, F)
        kw = {} if pkg == "jax" else {"device": "cpu"}
        out[pkg] = mod.ScheduleProgram(pk.schedule, dict(pk.new_node_processors), SR, **kw)
    return out


def _vary(params, rng):
    """Per-instance voice frequencies, chorus rate, drives, width and pitch
    on a JAX param tree (numpy leaves, instances first), in place."""
    for key, p in params.items():
        if key.startswith("beep_test"):
            b = len(p["inc"])
            p["inc"] = (p["inc"] * rng.uniform(0.75, 1.25, b)).astype(np.uint32)
        elif key.startswith("mod_delay") and not p["feedback"].any():
            p["rate"] = (rng.uniform(0.3, 3.0, len(p["rate"])) / SR).astype(np.float32)
        elif key.startswith("waveshaper"):
            p["drive"] = (p["drive"] * rng.uniform(0.5, 2.0, len(p["drive"]))).astype(
                np.float32)
        elif key.startswith("stereo_width"):
            p["width"] = rng.uniform(0.5, 2.0, len(p["width"])).astype(np.float32)
        elif key.startswith("pitch_shift"):
            p["ratio"] = (2.0 ** (rng.uniform(-12.0, 12.0, len(p["ratio"])) / 12.0)
                          ).astype(np.float32)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def test_fx_palette_graph_batched_equals_jax(unfused_jax_eq):
    """Two voices, B=2, two chunks of K=2 blocks, per-instance params: every
    output sample, mask and state leaf against JAX's ``BatchRenderer``."""
    b, k = 2, 2
    progs = _fx_programs(2)
    jbr = JaxBatchRenderer(progs["jax"], b)
    tbr = ft.BatchRenderer(progs["port"], b, device="cpu")
    jp = jax.tree.map(np.asarray, jbr.stack_params())
    _vary(jp, np.random.default_rng(28))
    js = jbr.init_state()
    tp = params_from_jax(jp, "cpu")
    ts = state_from_jax(jax.tree.map(np.asarray, js), "cpu")
    for c in range(2):
        jo, jm, js = jbr.render_chunk(jp, js, start_sample=c * k * F, num_blocks=k)
        to, tm, ts = tbr.render_chunk(tp, ts, start_sample=c * k * F, num_blocks=k)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=GRAPH_TOL, rtol=0,
                                   err_msg=f"chunk {c}")
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert np.abs(to.numpy()).max() > 0.05
    want = dict(_leaves(state_to_numpy(state_from_jax(jax.tree.map(np.asarray, js),
                                                      "cpu"))))
    got = dict(_leaves(state_to_numpy(ts)))
    assert got.keys() == want.keys()
    for path, v in want.items():
        np.testing.assert_allclose(got[path], v, atol=GRAPH_TOL, rtol=0, err_msg=str(path))


def test_vary_fx_params_gives_every_instance_its_own_values():
    prog = mixer.fx_palette_graph(num_voices=2, device="cpu")
    br = ft.BatchRenderer(prog, 3, device="cpu")
    params = mixer.vary_fx_params(prog, br.stack_params(), seed=1)
    varied = sum(bool((t != t[0]).any()) for _, t in _leaves(params) if t.ndim)
    # two voices, three EQ bands (four of five coefficients each at least),
    # the chorus, two waveshapers, the width and the pitch
    assert varied >= 2 + 3 * 4 + 1 + 2 + 1 + 1
    out, _, _ = br.render_chunk(params, br.init_state(), num_blocks=2)
    assert torch.isfinite(out).all() and not torch.equal(out[0], out[1])


# -- the example's engine, streamed across FX switches -------------------------

def _stream(pkg, switches, pumps):
    """The example's engine through ``FirewheelCtx``: 1024 frames a pump,
    an FX switch (a topology edit) before the pumps in ``switches``."""
    mod, nodes = (fw, jn) if pkg == "jax" else (ft, None)
    cx = mod.FirewheelCtx(**({} if pkg == "jax" else {"device": "cpu"}))
    ids = mixer.add_fx_engine(cx.graph_mut(), nodes=nodes)
    sink = mod.ArraySink()
    cfg = (dict(buffer_frames=F, chunk_buffers=8) if pkg == "jax"
           else dict(buffer_frames=1024, block_frames=F))
    cx.activate(mod.StreamConfig(**cfg), sink=sink)
    for i in range(pumps):
        if i in switches:
            mixer.set_fx(cx.graph_mut(), ids, switches[i], nodes=nodes)
        cx.update(max_pump_buffers=0)
        cx.stream.pump(8 if pkg == "jax" else 1)
    cx.stream.flush()
    audio = sink.audio(2)
    cx.deactivate()
    return audio


def test_fx_engine_streamed_equals_jax(unfused_jax_eq):
    """Two voices, the EQ inserted, then swapped for the flanger (state
    migration across both topology edits): the stream's audio against the
    JAX stream's (its EQ op by op, as above)."""
    switches, pumps = {1: "eq", 3: "flanger"}, 5
    ja = _stream("jax", switches, pumps)
    ta = _stream("port", switches, pumps)
    assert ta.shape == ja.shape and ta.shape[1] >= pumps * 1024
    np.testing.assert_allclose(ta, ja, atol=GRAPH_TOL, rtol=0)
    assert np.abs(ta).max() > 0.05
