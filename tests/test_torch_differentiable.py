"""Differentiable rendering on the port: the counterpart of
``tests/test_differentiable.py``.

A scalar loss of rendered audio differentiates with respect to node params
through the compiled graph, as ``jax.grad`` does through the JAX
package's.  On the CPU autograd differentiates the plain versions of the
port's kernels (the associative scans, the sample scans); on the card the
same graph goes through K7/K8 and K5/K9 (``chip_smoke.py`` phase 17).

Both of the JAX package's tests run here on the port.  Beside them the
port's gradient is held against ``jax.grad`` of the JAX package on the same
graph and params (made from a seed with numpy), each graph built with its
package's own nodes: the mixer at 3 voices (beep → volume → pan ×3 → sum →
lowpass ``"auto"`` → echo → clip → meter) with respect to every voice's gain
and pan and the filter's frequency and Q, and a dynamics chain (compressor
→ limiter → gate) with respect to threshold, ratio, makeup, ceiling and
floor, each over 3 blocks of 128 frames.  ``GRAD_RTOL`` 1e-4, relative to
each gradient's largest magnitude (float32 renders summed in another order:
3.3e-7 and 3.4e-7 measured).  The kernels with no backward (K1, K2, K3) refuse a
gradient, as ``jax.grad`` through the JAX package's ``pallas_call`` raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import firewheel_tpu as fw
import firewheel_tpu_torch as ft
from firewheel_tpu import nodes as jn
from firewheel_tpu_torch import mixer, nodes as tn
from firewheel_tpu_torch.convert import params_from_jax, tree_map
from firewheel_tpu_torch.core.node import BlockInfo
from firewheel_tpu_torch.executor import node_key
from firewheel_tpu_torch.executor_hybrid import HybridMegaRenderer
from firewheel_tpu_torch.executor_mega import MegaRenderer
from firewheel_tpu_torch.ops import iir, seq_iir

SR = 48000
F = 256
GRAD_RTOL = 1e-4
BLOCKS = 3


def build():
    """The JAX test's graph on the port: beep → volume → pan → out."""
    g = ft.AudioGraph(ft.AudioGraphConfig(0, 2))
    beep = g.add_node(0, 2, tn.BeepTestNode(440.0, -12.0, True))
    vol = g.add_node(2, 2, tn.VolumeNode(100.0))
    pan = g.add_node(2, 2, tn.StereoPanNode(0.0))
    for src, dst in ((beep, vol), (vol, pan), (pan, g.graph_out_node())):
        g.connect(src, 0, dst, 0)
        g.connect(src, 1, dst, 1)
    pkg = g.compile(SR, F)
    prog = ft.ScheduleProgram(pkg.schedule, dict(pkg.new_node_processors), SR,
                              device="cpu")
    return prog, vol, pan


def _silence(frames=F):
    return torch.zeros((0, frames)), torch.zeros((0,), dtype=torch.bool)


def test_gradient_through_render():
    prog, vol, pan = build()
    params = prog.collect_params()
    state = prog.init_state()
    gi, im = _silence()
    info = BlockInfo.make()
    vk = node_key(vol)

    def loss(raw_gain):
        p = dict(params)
        p[vk] = {"raw_gain": raw_gain}
        # two blocks, from a state whose smoother sits at the node's value
        out, _, st = prog.render_block(p, state, gi, im, info)
        out2, _, _ = prog.render_block(p, st, gi, im, info)
        return (out2 ** 2).mean()

    # away from the smoother's settled point (a plateau there)
    gain = torch.tensor(0.7, requires_grad=True)
    (g,) = torch.autograd.grad(loss(gain), gain)
    assert torch.isfinite(g)
    assert float(g) > 0  # energy grows with gain


def test_fit_pan_to_target_balance():
    """Fit the pan position to a target left/right energy ratio by plain
    gradient descent through the render."""
    prog, vol, pan = build()
    params = prog.collect_params()
    gi, im = _silence()
    info = BlockInfo.make()
    pk = node_key(pan)
    target_ratio = 0.25  # left energy / total

    def loss(pan_pos):
        p = dict(params)
        p[pk] = {"pan": pan_pos}
        st = prog.init_state()
        for _ in range(3):  # the pan smoother approaches the position
            out, _, st = prog.render_block(p, st, gi, im, info)
        le = (out[0] ** 2).mean()
        re = (out[1] ** 2).mean()
        ratio = le / (le + re + 1e-12)
        return (ratio - target_ratio) ** 2

    pos = torch.tensor(0.3)  # off the smoother's settled point (0.0)
    for _ in range(60):
        p = pos.clone().requires_grad_()
        (g,) = torch.autograd.grad(loss(p), p)
        pos = pos - 2.0 * g
    final = float(loss(pos))
    assert final < 1e-4, f"did not converge: loss={final}, pan={float(pos)}"
    assert float(pos) > 0.1  # panned right of center to dim the left


# -- the port's gradient against jax.grad ----------------------------------------

def _compile_both(add):
    """``add(g, nodes)`` wires a graph; compiled with each package's own
    graph and nodes → ``(jax program, port program, node ids)``."""
    jg = fw.AudioGraph(fw.AudioGraphConfig(0, 2))
    ids = add(jg, jn)
    jpkg = jg.compile(mixer.SR, mixer.BLOCK)
    jprog = fw.ScheduleProgram(jpkg.schedule, dict(jpkg.new_node_processors), mixer.SR)
    tg = ft.AudioGraph(ft.AudioGraphConfig(0, 2))
    assert add(tg, tn) == ids
    tpkg = tg.compile(mixer.SR, mixer.BLOCK)
    tprog = ft.ScheduleProgram(tpkg.schedule, dict(tpkg.new_node_processors), mixer.SR,
                               device="cpu")
    return jprog, tprog, ids


def _put(p, key, v):
    """Set the param ``key = (node key, param)`` of ``p`` to ``v``."""
    p[key[0]][key[1]] = v


def _grads_both(jprog, tprog, leaves, warm=0, put=_put):
    """The gradient of the mean square of ``BLOCKS`` rendered blocks (each
    package's ``chunk_fn``, the state carried) with respect to ``leaves``
    (``{(node key, param): value}``), by ``jax.grad`` on the JAX package
    and by autograd on the port, from the same float32 values, after
    ``warm`` blocks rendered at the graph's own params outside the gradient
    → two dicts of floats.  ``put(params, key, value)`` places a leaf in
    either package's params (a JAX tracer or a torch tensor)."""
    keys = sorted(leaves)
    values = [np.float32(leaves[k]) for k in keys]
    jparams = jprog.collect_params()
    tparams = params_from_jax(tprog.collect_params(), "cpu")
    f = mixer.BLOCK

    def jchunk(p, st, k, start):
        return jprog.chunk_fn(k)(p, st, jnp.zeros((k, 0, f)), jnp.zeros((k, 0), bool),
                                 start, 0)

    def tchunk(p, st, k, start):
        return tprog.chunk_fn(k)(p, st, torch.zeros((k, 0, f)),
                                 torch.zeros((k, 0), dtype=torch.bool), start, 0)

    jstate, tstate = jprog.init_state(), tprog.init_state()
    if warm:
        jstate = jax.jit(lambda p, st: jchunk(p, st, warm, 0)[2])(jparams, jstate)
        with torch.no_grad():
            tstate = tchunk(tparams, tstate, warm, 0)[2]

    def jloss(vals):
        p = {k: dict(v) for k, v in jparams.items()}
        for key, v in zip(keys, vals):
            put(p, key, v)
        outs = jchunk(p, jstate, BLOCKS, warm * f)[0]
        return jnp.sum(jnp.mean(outs ** 2, axis=(1, 2)))

    vals = [jnp.float32(v) for v in values]
    # XLA's backend optimisation off: half the compile time, ulps of rounding
    jg = jax.jit(jax.grad(jloss)).lower(vals).compile(
        compiler_options={"xla_backend_optimization_level": 0})(vals)
    tvals = [torch.tensor(v, requires_grad=True) for v in values]
    p = {k: dict(v) for k, v in tparams.items()}
    for key, v in zip(keys, tvals):
        put(p, key, v)
    outs = tchunk(p, tstate, BLOCKS, warm * f)[0]
    tg = torch.autograd.grad((outs ** 2).mean(dim=(1, 2)).sum(), tvals)
    return ({k: float(v) for k, v in zip(keys, jg)},
            {k: float(v) for k, v in zip(keys, tg)})


def _held(jgrad, tgrad):
    scale = max(abs(v) for v in jgrad.values())
    assert scale > 0
    for k in jgrad:
        assert abs(tgrad[k] - jgrad[k]) <= GRAD_RTOL * scale, (k, tgrad[k], jgrad[k])
    # the gradient reaches every leaf (none cut off by a kernel)
    assert sum(v != 0.0 for v in tgrad.values()) == sum(v != 0.0 for v in jgrad.values())


def test_mixer_gradient_matches_jax():
    def add(g, nodes):
        _, voices = mixer.add_mixer(g, num_voices=3, filter_backend="auto", nodes=nodes)
        return [tuple(map(repr, v)) for v in voices]

    jprog, tprog, voices = _compile_both(add)
    rng = np.random.default_rng(18)
    leaves = {}
    for beep, vol, pan in voices:
        leaves[(vol, "raw_gain")] = rng.uniform(0.3, 1.2)
        leaves[(pan, "pan")] = rng.uniform(-0.8, 0.8)
    (filt,) = [k for k, proc in tprog._procs.items()
               if type(proc).__name__ == "FilterProcessor"]
    leaves[(filt, "freq")] = rng.uniform(3000.0, 12000.0)
    leaves[(filt, "q")] = rng.uniform(0.5, 1.5)
    jgrad, tgrad = _grads_both(jprog, tprog, leaves)
    _held(jgrad, tgrad)
    assert all(tgrad[(filt, k)] != 0.0 for k in ("freq", "q"))


def test_dynamics_chain_gradient_matches_jax():
    def add(g, nodes):
        beep = g.add_node(0, 2, nodes.BeepTestNode(330.0, -3.0, True))
        comp = g.add_node(2, 2, nodes.CompressorNode(threshold_db=-20.0, ratio=4.0,
                                                     attack_secs=0.002, release_secs=0.05,
                                                     makeup_db=2.0))
        lim = g.add_node(2, 2, nodes.LimiterNode(ceiling_db=-6.0, lookahead_secs=0.001))
        gate = g.add_node(2, 2, nodes.GateNode(threshold_db=-9.0, range_db=-20.0,
                                               attack_secs=0.0005, release_secs=0.002,
                                               hold_secs=0.0, hysteresis_db=3.0))
        for src, dst in ((beep, comp), (comp, lim), (lim, gate), (gate, g.graph_out_node())):
            g.connect(src, 0, dst, 0)
            g.connect(src, 1, dst, 1)
        return [repr(i) for i in (comp, lim, gate)]

    jprog, tprog, (comp, lim, gate) = _compile_both(add)
    rng = np.random.default_rng(5)
    leaves = {(comp, "threshold_db"): rng.uniform(-24.0, -16.0),
              (comp, "ratio"): rng.uniform(2.0, 6.0),
              (comp, "makeup"): rng.uniform(1.0, 1.6),
              (lim, "ceiling"): rng.uniform(0.12, 0.2),
              (gate, "floor"): rng.uniform(0.05, 0.3)}
    # one block first: the compressor's envelope starts at 0, −inf dB, where
    # either package's gradient of the knee's unselected branch is NaN
    jgrad, tgrad = _grads_both(jprog, tprog, leaves, warm=1)
    _held(jgrad, tgrad)
    assert all(v != 0.0 for v in tgrad.values()), tgrad


def test_eq_gate_gradient_matches_jax():
    """``chip_smoke.py`` 17(h)'s path at one instance: the FX palette's
    voices → its three-band EQ (one cascade of K7 a block on the card, K8
    backwards) → a gate that opens and closes within each block (K5, K9),
    with respect to each band's gain in dB (its coefficients designed from
    the gain inside the gradient, by each package's own filter designs) and
    the gate's floor."""
    def add(g, nodes):
        ids = mixer.add_eq_gate(g, nodes=nodes)
        return repr(ids["eq"]), repr(ids["gate"])

    jprog, tprog, (eq, gate) = _compile_both(add)
    bands = tprog._procs[eq]._node._bands

    def put(p, key, v):
        node, name = key
        if not name.startswith("gain"):
            return _put(p, key, v)
        i = int(name[4:])
        band = bands[i]
        if isinstance(v, torch.Tensor):
            c = tn.filter._DESIGNS[band.band_type](band.frequency_hz, band.q, v, mixer.SR)
            p[node] = {"bands": {**p[node]["bands"], str(i): dict(zip(iir.BiquadCoeffs._fields, c))}}
        else:
            c = jn.filter._BUILDERS[band.band_type](band.frequency_hz, band.q, v, mixer.SR)
            new = list(p[node]["bands"])
            new[i] = dict(zip(iir.BiquadCoeffs._fields, c))
            p[node] = {"bands": tuple(new)}

    rng = np.random.default_rng(19)
    leaves = {(eq, f"gain{i}"): band.gain_db + rng.uniform(-6.0, 6.0)
              for i, band in enumerate(bands)}
    leaves[(gate, "floor")] = rng.uniform(0.05, 0.3)
    jgrad, tgrad = _grads_both(jprog, tprog, leaves, put=put)
    _held(jgrad, tgrad)
    assert all(v != 0.0 for v in tgrad.values()), tgrad


def test_batched_chunk_gradients_per_instance():
    """Per-instance leaves ``[B]`` differentiate under ``chunk_fn`` at B
    instances: each instance's gradient is the one it gets rendered alone."""
    prog = ft.mixer_graph(3, "auto", device="cpu")
    base = prog.collect_params()
    gains = [k for k, v in base.items() if "raw_gain" in v]
    (filt,) = [k for k, v in base.items() if "q" in v]
    b, k = 3, 2
    rng = np.random.default_rng(7)
    g_np = rng.uniform(0.3, 1.2, (len(gains), b)).astype(np.float32)
    q_np = rng.uniform(0.5, 1.5, b).astype(np.float32)

    def render(rows):
        n = len(rows)
        leaves = [torch.tensor(g_np[i, rows], requires_grad=True) for i in range(len(gains))]
        q = torch.tensor(q_np[rows], requires_grad=True)
        p = tree_map(lambda t: t.broadcast_to((n,) + t.shape).clone(),
                     params_from_jax(base, "cpu"))
        for key, leaf in zip(gains, leaves):
            p[key]["raw_gain"] = leaf
        p[filt]["q"] = q
        st = tree_map(lambda t: t.broadcast_to((n,) + t.shape).clone(), prog.init_state())
        out, _, _ = prog.chunk_fn(k)(p, st, torch.zeros(n, k, 0, mixer.BLOCK),
                                     torch.zeros(n, k, 0, dtype=torch.bool), 0, 0)
        loss = (out ** 2).mean(dim=(1, 2, 3)).sum()
        return torch.autograd.grad(loss, leaves + [q])

    together = render(list(range(b)))
    for i in range(b):
        alone = render([i])
        for t, a in zip(together, alone):
            assert torch.allclose(t[i], a[0], rtol=1e-5, atol=1e-9), (i, t[i], a[0])


def test_timeline_leaves_pass_gradients():
    """A per-block timeline (``chunk_fn``'s ``timelines``, spliced by
    ``executor.splice_block``) that requires a gradient gets, block by
    block, the gradient it gets when each block renders alone with its
    value."""
    prog, vol, pan = build()
    params = params_from_jax(prog.collect_params(), "cpu")
    path = (node_key(vol), "raw_gain")
    values = torch.tensor([0.4, 0.9, 0.6])
    gi, im = _silence()

    tl = values.clone().requires_grad_()
    out, _, _ = prog.chunk_fn(3)(params, prog.init_state(), gi.expand(3, 0, F),
                                 im.expand(3, 0), 0, 0, {path: tl})
    (chunked,) = torch.autograd.grad((out ** 2).mean(), tl)

    tl = values.clone().requires_grad_()
    st, total = prog.init_state(), 0.0
    for b in range(3):
        p = dict(params)
        p[path[0]] = {"raw_gain": tl[b]}
        o, _, st = prog.render_block(p, st, gi, im, BlockInfo.make(stream_sample=b * F))
        total = total + (o ** 2).mean() / 3
    (alone,) = torch.autograd.grad(total, tl)
    assert bool((chunked != 0).all())
    torch.testing.assert_close(chunked, alone, rtol=1e-6, atol=0.0)


def test_kernels_without_backward_refuse_gradients():
    """K1 (``biquad_seq``), K2 (``MegaRenderer``) and K3
    (``HybridMegaRenderer``) raise under grad mode when an operand requires
    a gradient, on the CPU too, and run as before under ``torch.no_grad``."""
    x = torch.randn(2, 16)
    c = iir.BiquadCoeffs(*(torch.full((2,), v) for v in (0.2, 0.3, 0.1, -0.5, 0.2)))
    z = (torch.zeros(2), torch.zeros(2))
    want, _ = seq_iir.biquad_seq(x, z, c)
    with pytest.raises(NotImplementedError, match="no backward"):
        seq_iir.biquad_seq(x.clone().requires_grad_(), z, c)
    with torch.no_grad():
        got, _ = seq_iir.biquad_seq(x.clone().requires_grad_(), z, c)
    assert torch.equal(got, want)

    def leaf_grad(params, name):
        (key,) = [k for k, v in params.items() if name in v]
        params[key][name] = params[key][name].clone().requires_grad_()

    mega = MegaRenderer(ft.mixer_graph(2, "pallas", device="cpu"), 2, 2, device="cpu")
    p, s = mega.stack_params(), mega.init_state()
    want = mega.render_chunk(p, s)[0]
    leaf_grad(p, "q")
    with pytest.raises(NotImplementedError, match="no backward"):
        mega.render_chunk(p, s)
    with torch.no_grad():
        assert torch.equal(mega.render_chunk(p, s)[0], want)

    hybrid = HybridMegaRenderer(ft.effects_chain_graph(device="cpu"), 2, 2, device="cpu")
    p, s = hybrid.stack_params(), hybrid.init_state()
    want = hybrid.render_chunk(p, s)[0]
    leaf_grad(p, "freq")
    with pytest.raises(NotImplementedError, match="no backward"):
        hybrid.render_chunk(p, s)
    with torch.no_grad():
        assert torch.equal(hybrid.render_chunk(p, s)[0], want)
