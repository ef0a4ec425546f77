"""The plain backwards of K7 and K5 (``ops/iir.py``'s
``one_pole_scan_backward_reference`` and ``biquad_cascade_backward_reference``,
``ops/dynamics.py``'s ``scan_lanes_backward_reference``), which K8 and K9
compute on the card and which ``chip_smoke.py`` (phase 17) holds them
against there.

Each is held, on the same seeded inputs, against autograd through the
port's plain forward and against ``jax.vjp`` of the JAX op it stands for
(``firewheel_tpu/ops/iir.py:one_pole_scan``, ``biquad_scan`` in series,
``firewheel_tpu/ops/dynamics.py:sample_scan`` with each node's step), with
non-zero state-out gradients, coefficients as numbers, one a row and
broadcast ``[..., 1]``, cascades of 1, 3 and 9 sections, and the ties of
the limiter's ``minimum`` (a constant gain) and the gate's hold.  Then the
``torch.autograd.Function``s that bind K7/K8 and K5/K9 on the card are run
here with their forward launches replaced by the plain forwards: their
backward (the plain backward on CPU tensors) equals autograd through the
plain forward, operands summed back to their shapes, state gradients
flowing across calls.

Tolerances, each relative to the largest magnitude of the gradient held:
``TOL`` 1e-4 for the biquads (float32 sums of a few hundred terms of both
signs, taken frame by frame here and over ``lax.associative_scan``'s tree
by autodiff: 7e-5 measured for a 200 Hz lowpass at Q 3.5), ``DYN_TOL``
1e-5 for the one-pole and the recurrences (1e-6 to 4e-6 measured).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from firewheel_tpu.ops import dynamics as jdyn
from firewheel_tpu.ops import iir as jiir
from firewheel_tpu_torch.ops import cuda_build
from firewheel_tpu_torch.ops import dynamics as tdyn
from firewheel_tpu_torch.ops import iir

TOL = 1e-4
DYN_TOL = 1e-5
SHAPES = ((3, 127), (2, 256), (5, 128))


def _run_jax(fn, *args):
    """``jax.jit(fn)(*args)``, compiled with XLA's backend optimisation off:
    the JAX package's functions as they are, in half the compile time (their
    roundings move by ulps, far inside the tolerances)."""
    lowered = jax.jit(fn).lower(*args)
    return lowered.compile(compiler_options={"xla_backend_optimization_level": 0})(*args)


def _close(got, want, tol, what, scale=None):
    """``got`` within ``tol`` of ``want``, relative to the largest magnitude
    of ``want`` (or ``scale``: a sum's terms, for a gradient summed over the
    rows an operand was broadcast to)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if scale is None:
        scale = float(np.abs(want).max(initial=0.0))
    scale = max(float(scale), 1e-12)
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= tol * scale, f"{what}: {err} against {scale}"


@pytest.fixture(autouse=True)
def no_kernel(monkeypatch):
    """Any attempt to build or load a kernel library fails the test."""
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel library was built or loaded for a CPU tensor")

    for lib in (iir.LIBRARY, iir.BWD_LIBRARY, tdyn.LIBRARY, tdyn.BWD_LIBRARY):
        monkeypatch.setattr(lib, "load", refuse)
    monkeypatch.setattr(cuda_build, "_nvcc", refuse)


# -- K7's backwards -------------------------------------------------------------

#: (sections, form) of each cascade case: the coefficients of the even
#: sections per row, as numbers or one an instance broadcast over two
#: channels (``[rows, 1]`` over rows ``[rows, 2]``), the odd ones per row
CASCADE_CASES = ((1, "row"), (1, "number"), (1, "broadcast"), (3, "row"), (3, "number"),
                 (9, "broadcast"))
PAD = 9  # sections of the batched JAX call: a case's own, then identities


def _coeffs(form, rng, lead):
    """A lowpass 1–12 kHz at Q 0.5–2: one a row, one an instance
    (``"broadcast"``), or numbers."""
    if form == "number":
        f, q = rng.uniform(1000.0, 12000.0), rng.uniform(0.5, 2.0)
        return iir.biquad_lowpass(np.float32(f), np.float32(q), 48000)
    shape = (lead[0], 1) if form == "broadcast" else lead
    f = rng.uniform(1000.0, 12000.0, shape).astype(np.float32)
    q = rng.uniform(0.5, 2.0, shape).astype(np.float32)
    return iir.biquad_lowpass(torch.from_numpy(f), torch.from_numpy(q), 48000)


def _as_np(c):
    return np.asarray(c.detach() if isinstance(c, torch.Tensor) else c, np.float32)


def _cascade_case(shape, sections, form):
    rng = np.random.default_rng([shape[1], sections, len(form)])
    rows, frames = shape
    lead = (rows, 2) if form == "broadcast" else (rows,)
    x = rng.standard_normal(lead + (frames,)).astype(np.float32)
    cs = [_coeffs(form if s % 2 == 0 else "row", rng, lead) for s in range(sections)]
    zs = [tuple(0.1 * rng.standard_normal(lead).astype(np.float32) for _ in range(2))
          for _ in range(sections)]
    gy = rng.standard_normal(x.shape).astype(np.float32)
    gz = [tuple(rng.standard_normal(lead).astype(np.float32) for _ in range(2))
          for _ in range(sections)]
    return x, cs, zs, gy, gz


@functools.lru_cache(maxsize=None)
def _jax_cascades(shape):
    """``jax.vjp`` of ``firewheel_tpu``'s ``biquad_scan`` in series for every
    case of ``CASCADE_CASES`` at ``shape``, in one jitted call: the cases'
    rows side by side, each coefficient broadcast to its rows, every case
    padded to ``PAD`` sections with identities (``b0 = 1``, zero state),
    the sections under ``lax.scan``.  Returns, per case, ``(g_x, g_coefs
    [S, 5, *lead], g_z [S, 2, *lead])``, one coefficient gradient a row (the
    vjp of a broadcast operand is their sum)."""
    cases = [_cascade_case(shape, s, f) for s, f in CASCADE_CASES]
    xs, cs, zs, gys, gzs, leads = [], [], [], [], [], []
    for x, c, z, gy, gz in cases:
        lead = x.shape[:-1]
        n = int(np.prod(lead))
        rows = lambda v: np.broadcast_to(_as_np(v), lead).reshape(n)  # noqa: E731
        pad = PAD - len(c)
        xs.append(x.reshape(n, -1))
        gys.append(gy.reshape(n, -1))
        cs.append(np.stack([np.stack([rows(v) for v in sec]) for sec in c]
                           + [np.stack([np.ones(n)] + [np.zeros(n)] * 4)] * pad))
        zs.append(np.stack([np.stack([rows(v) for v in zz]) for zz in z]
                           + [np.zeros((2, n))] * pad))
        gzs.append(np.stack([np.stack([rows(v) for v in g]) for g in gz]
                            + [np.zeros((2, n))] * pad))
        leads.append(lead)
    x, gy = np.concatenate(xs), np.concatenate(gys)
    c, z, gz = (np.concatenate(a, axis=-1).astype(np.float32) for a in (cs, zs, gzs))

    def cascade(x, c, z):
        def section(x, cz):
            y, (z1, z2) = jiir.biquad_scan(x, (cz[1][0], cz[1][1]),
                                           jiir.BiquadCoeffs(*cz[0]))
            return y, jnp.stack([z1, z2])

        return jax.lax.scan(section, x, (c, z))

    g = _run_jax(lambda *a: jax.vjp(cascade, *a[:3])[1](a[3:]), x, c, z, gy, gz)
    g_x, g_c, g_z = (np.asarray(v) for v in g)
    out, at = [], 0
    for (s, _), lead in zip(CASCADE_CASES, leads):
        n = int(np.prod(lead))
        cut = slice(at, at + n)
        out.append((g_x[cut].reshape(lead + (-1,)), g_c[:s, :, cut].reshape((s, 5) + lead),
                    g_z[:s, :, cut].reshape((s, 2) + lead)))
        at += n
    return out


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("case", range(len(CASCADE_CASES)))
def test_biquad_cascade_backward(shape, case):
    sections, form = CASCADE_CASES[case]
    x, cs, zs, gy, gz = _cascade_case(shape, sections, form)
    tx = torch.from_numpy(x).requires_grad_()
    tcs = [iir.BiquadCoeffs(*(v.clone().requires_grad_() if isinstance(v, torch.Tensor)
                              else v for v in c)) for c in cs]
    tzs = [tuple(torch.from_numpy(z).requires_grad_() for z in zz) for zz in zs]
    y, zo = iir.biquad_cascade_reference(tx, tzs, tcs)
    g_x, g_z, g_c = iir.biquad_cascade_backward_reference(
        tx.detach(), y.detach(), [tuple(z.detach() for z in zz) for zz in tzs],
        [iir.BiquadCoeffs(*(v.detach() if isinstance(v, torch.Tensor) else v for v in c))
         for c in tcs],
        torch.from_numpy(gy), [tuple(map(torch.from_numpy, g)) for g in gz])
    loss = (y * torch.from_numpy(gy)).sum() + sum(
        (z * torch.from_numpy(g)).sum() for zz, gg in zip(zo, gz) for z, g in zip(zz, gg))
    leaves = [tx] + [z for zz in tzs for z in zz]
    coef_leaves = [(s, k, v) for s, c in enumerate(tcs) for k, v in enumerate(c)
                   if isinstance(v, torch.Tensor)]
    auto = torch.autograd.grad(loss, leaves + [v for _, _, v in coef_leaves])
    j_x, j_c, j_z = _jax_cascades(shape)[case]

    _close(g_x, auto[0], TOL, "g_x vs autograd")
    _close(g_x, j_x, TOL, "g_x vs jax.vjp")
    for s in range(sections):
        for k in range(2):
            _close(g_z[s][k], auto[1 + 2 * s + k], TOL, f"g_z[{s}][{k}] vs autograd")
            _close(g_z[s][k], j_z[s, k], TOL, f"g_z[{s}][{k}] vs jax.vjp")
    for (s, k, v), a in zip(coef_leaves, auto[1 + 2 * sections:]):
        g = iir._sum_to(g_c[s][k], v)  # per row → the operand's shape
        terms = g_c[s][k].abs().max()
        _close(g, a, TOL, f"coefficient {s}.{k} vs autograd", terms)
        _close(g, iir._sum_to(torch.tensor(j_c[s, k]), v), TOL,
               f"coefficient {s}.{k} vs jax.vjp", terms)


ONE_POLE_FORMS = ("row", "number", "scalar_tensor")


def _one_pole_case(shape, form):
    rng = np.random.default_rng([shape[1], len(form)])
    rows, frames = shape
    x = rng.standard_normal(shape).astype(np.float32)
    if form == "row":
        b = rng.uniform(0.05, 0.999, (rows, 1)).astype(np.float32)
        a = (1.0 - b).astype(np.float32)
    else:  # the DC blocker's
        b, a = np.float32(0.9973857), np.float32(1.0)
    y0 = rng.standard_normal(rows).astype(np.float32)
    gy = rng.standard_normal(shape).astype(np.float32)
    gl = rng.standard_normal(rows).astype(np.float32)
    return x, y0, a, b, gy, gl


@functools.lru_cache(maxsize=None)
def _jax_one_poles(shape):
    """``jax.vjp`` of ``firewheel_tpu``'s ``one_pole_scan`` for every form at
    ``shape`` in one jitted call (rows side by side, ``a`` and ``b`` one a
    row) → per form ``(g_x, g_y0, g_a, g_b)``, one coefficient gradient a
    row."""
    cases = [_one_pole_case(shape, f) for f in ONE_POLE_FORMS]
    rows = shape[0]
    col = lambda v: np.broadcast_to(v, (rows, 1))  # noqa: E731
    x, y0, a, b, gy, gl = (np.concatenate(v) for v in zip(*[
        (x, y0, col(a), col(b), gy, gl) for x, y0, a, b, gy, gl in cases]))
    g = _run_jax(lambda x, y0, a, b, gy, gl: jax.vjp(jiir.one_pole_scan, x, y0, a, b)[1](
        (gy, gl)), x, y0, a, b, gy, gl)
    g = [np.asarray(v) for v in g]
    return [tuple(v[i * rows:(i + 1) * rows] for v in g) for i in range(len(cases))]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("form", ONE_POLE_FORMS)
def test_one_pole_scan_backward(shape, form):
    x, y0, a, b, gy, gl = _one_pole_case(shape, form)
    ta, tb = ((float(v) if form == "number" else torch.tensor(v).requires_grad_())
              for v in (a, b))
    tx, ty0 = (torch.from_numpy(v).requires_grad_() for v in (x, y0))
    y, y_last = iir.one_pole_scan_reference(tx, ty0, ta, tb)
    g_x, g_prev, (g_a, g_b) = iir.one_pole_scan_backward_reference(
        tx.detach(), y.detach(), ty0.detach(),
        *(v.detach() if isinstance(v, torch.Tensor) else v for v in (ta, tb)),
        torch.from_numpy(gy), torch.from_numpy(gl))
    loss = (y * torch.from_numpy(gy)).sum() + (y_last * torch.from_numpy(gl)).sum()
    coefs = [v for v in (ta, tb) if isinstance(v, torch.Tensor)]
    auto = torch.autograd.grad(loss, [tx, ty0] + coefs)
    j_x, j_y0, j_a, j_b = _jax_one_poles(shape)[ONE_POLE_FORMS.index(form)]

    _close(g_x, auto[0], DYN_TOL, "g_x vs autograd")
    _close(g_x, j_x, DYN_TOL, "g_x vs jax.vjp")
    _close(g_prev, auto[1], DYN_TOL, "g_y_prev vs autograd")
    _close(g_prev, j_y0, DYN_TOL, "g_y_prev vs jax.vjp")
    for got, v, a_, j in zip((g_a, g_b), coefs, auto[2:], (j_a, j_b)):
        per_row = iir._per_row(v, tx)
        g = iir._sum_to(got, per_row).reshape(v.shape)
        terms = got.abs().max()
        _close(g, a_, DYN_TOL, "coefficient vs autograd", terms)
        _close(g, iir._sum_to(torch.tensor(j[:, 0]), per_row).reshape(v.shape),
               DYN_TOL, "coefficient vs jax.vjp", terms)


# -- K5's backward --------------------------------------------------------------

def _jax_envelope(x, carry, coefs):
    env, env_last = jdyn.envelope_follow(x, carry[0], *coefs)
    return (env_last,), env


def _jax_limiter(x, carry, coefs):
    (rel,) = coefs

    def step(env, g):
        env = jnp.minimum(g, rel * env + (1.0 - rel) * g)
        return env, env

    env_last, y = jdyn.sample_scan(step, carry[0], x)
    return (env_last,), y


def _jax_gate(x, carry, coefs):
    open_lin, close_lin, floor, att_b, rel_b, hold_n = coefs

    def step(carry, lvl):
        opn, hold, g = carry
        above = lvl >= open_lin
        below = lvl < close_lin
        expired = hold <= 0.0
        opn = jnp.where(above, 1.0, jnp.where(below & expired, 0.0, opn))
        hold = jnp.where(above, hold_n, jnp.maximum(hold - 1.0, 0.0))
        target = opn + (1.0 - opn) * floor
        b = jnp.where(target > g, att_b, rel_b)
        g = b * g + (1.0 - b) * target
        return (opn, hold, g), g

    out, y = jdyn.sample_scan(step, tuple(carry), x)
    return out, y


def _jax_pink(x, carry, coefs):
    def pink_step(z, w):
        b0 = 0.99765 * z[:, 0] + w * 0.0990460
        b1 = 0.96300 * z[:, 1] + w * 0.2965164
        b2 = 0.57000 * z[:, 2] + w * 1.0526913
        y = (b0 + b1 + b2 + w * 0.1848) * 0.25
        return jnp.stack([b0, b1, b2], axis=-1), y

    out, y = jdyn.sample_scan(pink_step, carry, x)
    return out, y


_JAX_STEPS = {tdyn.ENVELOPE: _jax_envelope, tdyn.LIMITER: _jax_limiter,
              tdyn.GATE: _jax_gate, tdyn.PINK: _jax_pink}
KINDS = {"envelope": tdyn.ENVELOPE, "limiter": tdyn.LIMITER, "gate": tdyn.GATE,
         "pink": tdyn.PINK}


def _scan_case(kind, shape, seed):
    """``(x, carry, coefs)`` in numpy for ``kind`` over ``shape``, each
    coefficient inside its range: a constant limiter gain on row 0 (the
    envelope lands on it: ties), and on the gate's row 0 a level under the
    closing threshold with the hold reaching 1 at the last frame (its tie)."""
    rng = np.random.default_rng(seed)
    lanes, frames = shape
    u = lambda lo, hi, s=(lanes,): rng.uniform(lo, hi, s).astype(np.float32)  # noqa: E731
    if kind == tdyn.ENVELOPE:
        return u(0, 1, shape), (u(0, 1),), (u(0.9, 0.99), np.float32(0.995))
    if kind == tdyn.LIMITER:
        x = u(0.2, 1.0, shape)
        x[0] = 0.5
        return x, (u(0.2, 1.0),), (u(0.9, 0.99),)
    if kind == tdyn.GATE:
        x = u(0.0, 0.06, shape)
        x[0] = 0.001
        hold = rng.integers(0, 60, lanes).astype(np.float32)
        hold[0] = frames
        carry = ((rng.random(lanes) < 0.5).astype(np.float32), hold, u(0.0, 1.0))
        coefs = (u(0.02, 0.05), u(0.005, 0.02), u(0.0, 0.5), u(0.9, 0.99),
                 np.float32(0.9995), np.full(lanes, 48.0, np.float32))
        return x, carry, coefs
    return u(-1, 1, shape), u(-2.0, 2.0, (lanes, 3)), ()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", list(KINDS))
def test_scan_lanes_backward(name, shape):
    kind = KINDS[name]
    x, carry, coefs = _scan_case(kind, shape, seed=shape[1] + kind)
    stacked = kind == tdyn.PINK
    tx = torch.from_numpy(x).requires_grad_()
    tcarry = (torch.from_numpy(carry).requires_grad_() if stacked else
              tuple(torch.from_numpy(c).requires_grad_() for c in carry))
    tcoefs = tuple(torch.from_numpy(c).requires_grad_() if c.ndim else float(c)
                   for c in coefs)
    co, y = tdyn.scan_reference(kind, tx, tcarry, tcoefs)
    rng = np.random.default_rng(1)
    gy = rng.standard_normal(x.shape).astype(np.float32)
    gco = (rng.standard_normal(co.shape).astype(np.float32) if stacked else
           tuple(rng.standard_normal(c.shape).astype(np.float32) for c in co))
    g_x, g_carry, g_coefs = tdyn.scan_lanes_backward_reference(
        kind, tx.detach(), tcarry.detach() if stacked else tuple(c.detach() for c in tcarry),
        tuple(c.detach() if isinstance(c, torch.Tensor) else c for c in tcoefs),
        y.detach(), torch.from_numpy(gy),
        torch.from_numpy(gco) if stacked else tuple(map(torch.from_numpy, gco)))
    out = (co,) if stacked else co
    gouts = (gco,) if stacked else gco
    loss = (y * torch.from_numpy(gy)).sum() + sum(
        (o * torch.from_numpy(g)).sum() for o, g in zip(out, gouts))
    carry_leaves = [tcarry] if stacked else list(tcarry)
    coef_leaves = [c for c in tcoefs if isinstance(c, torch.Tensor)]
    auto = torch.autograd.grad(loss, [tx] + carry_leaves + coef_leaves, allow_unused=True)
    auto = [torch.zeros_like(v) if a is None else a
            for a, v in zip(auto, [tx] + carry_leaves + coef_leaves)]

    j_carry = carry if stacked else tuple(carry)
    j_x, j_c, j_k = _run_jax(
        lambda x, c, k, g: jax.vjp(lambda *a: _JAX_STEPS[kind](*a), x, c, k)[1](g),
        x, j_carry, tuple(coefs), (gco if stacked else tuple(gco), gy))

    mine_carry = [g_carry] if stacked else list(g_carry)
    jax_carry = [j_c] if stacked else list(j_c)
    mine_coefs = [g for g, c in zip(g_coefs, tcoefs) if isinstance(c, torch.Tensor)]
    jax_coefs = [j for j, c in zip(j_k, tcoefs) if isinstance(c, torch.Tensor)]
    for what, mine, a, j in zip(
            ["g_x"] + [f"g_carry[{k}]" for k in range(len(mine_carry))]
            + [f"g_coef[{k}]" for k in range(len(mine_coefs))],
            [g_x] + mine_carry + mine_coefs, auto, [j_x] + jax_carry + jax_coefs):
        _close(mine, a, DYN_TOL, f"{name} {what} vs autograd")
        _close(mine, j, DYN_TOL, f"{name} {what} vs jax.vjp")


def test_limiter_and_gate_ties_split_the_gradient():
    """At a tie the limiter's minimum and the gate's hold maximum pass half
    the gradient each way, as torch's and JAX's do: one frame, one lane."""
    g, env0, rel = 0.5, 0.5, 0.9  # env = min(g, rel·env0 + (1−rel)·g) ties at g
    x = torch.tensor([[g]])
    (_,), y = tdyn.scan_reference(tdyn.LIMITER, x, (torch.tensor([env0]),),
                                  (torch.tensor([rel]),))
    g_x, (g_env,), (g_rel,) = tdyn.scan_lanes_backward_reference(
        tdyn.LIMITER, x, (torch.tensor([env0]),), (torch.tensor([rel]),), y,
        torch.ones(1, 1), (torch.zeros(1),))
    assert float(g_env) == pytest.approx(0.5 * rel)
    assert float(g_x) == pytest.approx(0.5 + 0.5 * (1.0 - rel))
    carry = tuple(torch.tensor([v]) for v in (0.0, 1.0, 0.0))  # hold 1 → max(0, 0)
    coefs = tuple(torch.tensor([v]) for v in (0.5, 0.1, 0.2, 0.9, 0.99, 48.0))
    _, (_, g_hold, _), _ = tdyn.scan_lanes_backward_reference(
        tdyn.GATE, torch.tensor([[0.3]]), carry, coefs, torch.zeros(1, 1),
        torch.zeros(1, 1), (torch.zeros(1), torch.ones(1), torch.zeros(1)))
    assert float(g_hold) == 0.5


# -- the autograd Functions of the card, their launches replaced ----------------

def _plain_launches(monkeypatch):
    """Replace the forward launches by the plain forwards: the Functions'
    backwards then run the plain backwards (CPU tensors)."""
    def cascade(x, states, sections):
        y, zs = iir.biquad_cascade_reference(x, states, sections)
        return y, torch.stack([t.broadcast_to(x.shape[:-1]) for z in zs for t in z])

    def one_pole(x, y_prev, a, b):
        a, b = (c[..., None] if isinstance(c, torch.Tensor) and c.ndim else c for c in (a, b))
        return iir.one_pole_scan_reference(x, y_prev, a, b)

    def scan(kind, x, leaves, coefs, stacked):
        out, y = tdyn.scan_reference(kind, x, leaves, coefs)
        lead = x.shape[:-1]
        out = [t.broadcast_to(lead) for t in out]
        return y, torch.stack(out, dim=-1 if stacked else 0)

    monkeypatch.setattr(iir, "_cascade_launch", cascade)
    monkeypatch.setattr(iir, "_one_pole_launch", one_pole)
    monkeypatch.setattr(tdyn, "_scan_launch", scan)


def test_cascade_function_chains_blocks(monkeypatch):
    """Three blocks of a 2-section cascade with per-instance coefficients
    ``[B, 1]`` over ``[B, 2]`` rows, the states handed from block to block:
    through ``_CascadeFn`` (whose backward is ``biquad_cascade_backward``)
    as through autograd of the plain forward."""
    _plain_launches(monkeypatch)
    rng = np.random.default_rng(3)
    B, F = 4, 64
    xs = [torch.from_numpy(rng.standard_normal((B, 2, F)).astype(np.float32))
          for _ in range(3)]
    freq = torch.from_numpy(rng.uniform(2000, 9000, (B, 1)).astype(np.float32))
    q = torch.from_numpy(rng.uniform(0.6, 1.5, (B, 1)).astype(np.float32))

    def run(apply):
        f, qq = freq.clone().requires_grad_(), q.clone().requires_grad_()
        ins = [x.clone().requires_grad_() for x in xs]
        states = [(torch.zeros(B, 2), torch.zeros(B, 2))] * 2
        loss = 0.0
        for x in ins:
            c = iir.biquad_lowpass(f, qq, 48000)
            sections = (c, iir.BiquadCoeffs(*(0.5 * v for v in c)))
            y, states = apply(x, states, sections)
            loss = loss + (y ** 2).mean()
        loss = loss + sum((z ** 2).sum() for s in states for z in s)
        return torch.autograd.grad(loss, [f, qq] + ins)

    def through_fn(x, states, sections):
        flat = [v for c, z in zip(sections, states) for v in (*c, *z)]
        y, z_out = iir._CascadeFn.apply(x, *flat)
        zs = z_out.unbind(0)
        return y, tuple(zip(zs[0::2], zs[1::2]))

    for got, want in zip(run(through_fn), run(iir.biquad_cascade_reference)):
        _close(got, want, TOL, "cascade through _CascadeFn")


def test_one_pole_function(monkeypatch):
    _plain_launches(monkeypatch)
    rng = np.random.default_rng(4)
    x0 = torch.from_numpy(rng.standard_normal((3, 2, 128)).astype(np.float32))
    b0 = torch.from_numpy(rng.uniform(0.1, 0.99, (3, 2, 1)).astype(np.float32))

    def run(through_fn):
        x, b = x0.clone().requires_grad_(), b0.clone().requires_grad_()
        y_prev = torch.zeros(3, 2, requires_grad=True)
        a = 1.0 - b
        if through_fn:
            y, last = iir._OnePoleFn.apply(x, y_prev, iir._per_row(a, x), iir._per_row(b, x))
        else:
            y, last = iir.one_pole_scan_reference(x, y_prev, a, b)
        return torch.autograd.grad((y ** 3).sum() + (last * 2.0).sum(), [x, b, y_prev])

    for got, want in zip(run(True), run(False)):
        _close(got, want, DYN_TOL, "one-pole through _OnePoleFn")


@pytest.mark.parametrize("name", list(KINDS))
def test_scan_function(monkeypatch, name):
    """``_ScanFn`` over two blocks, the carry handed on, coefficients one an
    instance ``[B]`` and numbers, the pink's carry stacked ``[B, 3]``."""
    _plain_launches(monkeypatch)
    kind = KINDS[name]
    x, carry, coefs = _scan_case(kind, (4, 64), seed=11 + kind)
    stacked = kind == tdyn.PINK

    def run(through_fn):
        tx = torch.from_numpy(x).requires_grad_()
        tcoefs = tuple(torch.from_numpy(c).requires_grad_() if c.ndim else float(c)
                       for c in coefs)
        c = (torch.from_numpy(carry).requires_grad_() if stacked
             else tuple(torch.from_numpy(v).requires_grad_() for v in carry))
        leaves0 = [c] if stacked else list(c)
        loss = 0.0
        for block in (tx, tx.flip(-1) * 0.5):
            if through_fn:
                leaves = tuple(c[..., k] for k in range(3)) if stacked else c
                y, out = tdyn._ScanFn.apply(kind, stacked, block, *leaves, *tcoefs)
                c = out if stacked else out.unbind(0)
            else:
                c, y = tdyn.scan_reference(kind, block, c, tcoefs)
            loss = loss + (y * torch.linspace(0.5, 1.5, y.shape[-1])).sum()
        loss = loss + sum(((t if stacked else t) ** 2).sum() for t in ([c] if stacked else c))
        leaves = [tx] + leaves0 + [v for v in tcoefs if isinstance(v, torch.Tensor)]
        return torch.autograd.grad(loss, leaves, allow_unused=True)

    for got, want in zip(run(True), run(False)):
        if want is None:
            assert got is None or not got.any()
            continue
        _close(got, want, DYN_TOL, f"{name} through _ScanFn")


def test_wrappers_on_cpu_use_autograd_of_the_plain_forward():
    """A CPU tensor runs the plain forward under autograd (never the
    Functions, never a library: ``no_kernel``); the backward wrappers run
    the plain backwards; K8 takes at most ``MAX_SECTIONS`` a launch only on
    the card."""
    x = torch.randn(2, 32, requires_grad=True)
    c = iir.biquad_lowpass(torch.tensor([3000.0, 5000.0]), torch.tensor([0.7, 0.9]), 48000)
    y, (z,) = iir.biquad_cascade(x, [(torch.zeros(2), torch.zeros(2))], [c])
    assert "CascadeFn" not in type(y.grad_fn).__name__
    y.sum().backward()
    assert x.grad is not None
    sections = [c] * 9
    states = [(torch.zeros(2), torch.zeros(2))] * 9
    y9, _ = iir.biquad_cascade_reference(x.detach(), states, sections)
    got = iir.biquad_cascade_backward(x.detach(), y9, states, sections, torch.ones(2, 32),
                                      [(torch.zeros(2), torch.zeros(2))] * 9)
    assert len(got[1]) == len(got[2]) == 9
    assert iir.biquad_cascade_backward.launches == 0
    assert tdyn.scan_lanes_backward.launches == 0
