"""The port's differentiable-mixing example (``firewheel_tpu_torch.
examples.autotune_mix``) on the CPU beside the JAX package's
(``examples/autotune_mix.py``, loaded from its file): three voices' gains
fitted by 80 steps of gradient descent at rate 8.0, clipped to [0, 4],
``jax.jit(jax.grad(loss))`` there and torch autograd through
``ScheduleProgram.chunk_fn`` here (the three probes as instances of one
batch).  The gains after every step and the loss curve (the initial loss
and the loss every 20 steps) within ``GRAD_TOL`` = 1e-4 of their largest
magnitude: the tolerance ``chip_smoke.py``'s phase 17 holds the card's
gradients to.  80 steps amplify rounding; both packages reach the same
f32 fixed point here (loss 0.0).  The JAX side's two compiles take most of
this test's time (~40 s).
"""

import re

import jax.numpy as jnp
import numpy as np

from firewheel_tpu_torch.examples import autotune_mix
from test_torch_examples import _load_jax_example

GRAD_TOL = 1e-4


class _RecordingJnp:
    """``jax.numpy`` with every ``clip`` (the example's step) recorded."""

    def __init__(self, log):
        self._log = log

    def __getattr__(self, name):
        return getattr(jnp, name)

    def clip(self, *a, **kw):
        out = jnp.clip(*a, **kw)
        self._log.append(np.asarray(out))
        return out


def test_autotune_mix_matches_jax(monkeypatch, capsys):
    jax_mod = _load_jax_example("autotune_mix")
    steps = []
    monkeypatch.setattr(jax_mod, "jnp", _RecordingJnp(steps))
    jax_mod.main()
    printed = capsys.readouterr().out
    got = autotune_mix.main(device="cpu")
    mine = capsys.readouterr().out

    want = np.stack(steps)
    assert want.shape == got["trajectory"].shape == (autotune_mix.STEPS, 3)
    scale = float(np.abs(want).max())
    assert np.abs(got["trajectory"] - want).max() <= GRAD_TOL * scale
    losses = [float(v) for v in re.findall(r"loss:? ([-0-9.e+]+)", printed)]
    curve = [got["initial_loss"], *got["curve"].values()]
    assert len(losses) == len(curve) == 5 and list(got["curve"]) == [20, 40, 60, 80]
    assert np.abs(np.asarray(curve) - losses).max() <= GRAD_TOL * max(losses)
    assert got["loss"] < 1e-6 and "auto-mix converged ✓" in mine
    np.testing.assert_allclose(got["rms"], autotune_mix.TARGET, atol=1e-3, rtol=0)
    # the same lines, each number to its printed precision
    assert [re.sub(r"[-0-9.e+]+", "#", ln) for ln in mine.splitlines()] == \
        [re.sub(r"[-0-9.e+]+", "#", ln) for ln in printed.splitlines()]
