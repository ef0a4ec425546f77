"""The port's public API against the JAX package's, name by name, and the
port's parity tests against JAX's program cache.

For every ``__all__`` name of the eight namespaces that
``test_torch_serialize.py`` compares, the keyword arguments (of a class's
constructor, a function, or a class's public method) and the public
methods that the JAX package has and the port lacks are exactly the list
in ``ROADMAP.md`` after its "JAX keyword arguments and methods left out by
design" line, one bullet each: ```Class(kwarg=)```, ```Class.method```,
```Class.method(kwarg=)``` or ```function(kwarg=)```.

A JAX ``ScheduleProgram`` reuses the compiled steps of a cached program of
the same graph (``firewheel_tpu/executor.py:_PROGRAM_CACHE``), traced under
whatever the node modules held then.  The parity tests that patch a JAX
module read at trace time set the cache aside first
(``test_torch_examples.fresh_jax_programs``): here the mastering bus's
comparison runs right after the JAX example ran unpatched in the same
process, and holds.
"""

import importlib
import inspect
import os
import re

from test_torch_examples import _load_jax_example
from test_torch_serialize import MODULES, REPO
import test_torch_examples_bus


def _kwargs(fn) -> set:
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return set()
    return {p.name for p in sig.parameters.values()
            if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY) and p.name != "self"}


def api_gaps() -> set:
    """What the JAX package's ``__all__`` names offer and the port's lack."""
    gaps = set()
    for mod in MODULES:
        j = importlib.import_module("firewheel_tpu" + mod)
        t = importlib.import_module("firewheel_tpu_torch" + mod)
        for name in getattr(j, "__all__", ()):
            jo, to = getattr(j, name), getattr(t, name)
            if inspect.isclass(jo):
                gaps |= {f"{name}({k}=)" for k in _kwargs(jo.__init__) - _kwargs(to.__init__)}
                for m in dir(jo):
                    if m.startswith("_"):
                        continue
                    if not hasattr(to, m):
                        gaps.add(f"{name}.{m}")
                    elif callable(getattr(jo, m)) and callable(getattr(to, m)):
                        gaps |= {f"{name}.{m}({k}=)"
                                 for k in _kwargs(getattr(jo, m)) - _kwargs(getattr(to, m))}
            elif callable(jo):
                gaps |= {f"{name}({k}=)" for k in _kwargs(jo) - _kwargs(to)}
    return gaps


def roadmap_left_out() -> dict:
    """``{name: reason}`` from ROADMAP.md's list of JAX keyword arguments
    and methods left out by design."""
    with open(os.path.join(REPO, "ROADMAP.md")) as f:
        text = f.read()
    block = text.split("JAX keyword arguments and methods left out by design", 1)[1]
    block = block.split("\n\n", 2)[1]
    out = {}
    for line in block.splitlines():
        m = re.match(r"- `([\w.()=]+)`: (.+)", line.strip())
        if m:
            out[m.group(1)] = m.group(2)
    return out


def test_api_gaps_are_roadmaps_list():
    listed = roadmap_left_out()
    assert listed and all(reason.strip() for reason in listed.values())
    assert api_gaps() == set(listed)


def test_mastering_bus_after_an_unpatched_jax_run(monkeypatch, tmp_path, capsys):
    """The JAX mastering bus runs unpatched for 0.3 s (its programs enter
    JAX's cache, traced with XLA's fused scan); then the patched comparison
    of ``test_torch_examples_bus.py`` runs in the same process and holds
    the meter's readings to 1e-3 LU.  Before its helper set the cache
    aside, the second run reused the first's programs and 5 of 36
    readings were off by up to 1.81e-3 LU."""
    monkeypatch.setattr("sys.argv", ["mastering_bus.py", str(tmp_path / "unpatched.wav")])
    jax_mod = _load_jax_example("mastering_bus")

    class Ctx(jax_mod.FirewheelCtx):
        def activate(self, *a, duration_secs=None, **kw):
            return super().activate(*a, duration_secs=0.3, **kw)

    monkeypatch.setattr(jax_mod, "FirewheelCtx", Ctx)
    jax_mod.main()
    capsys.readouterr()
    (tmp_path / "patched").mkdir()
    test_torch_examples_bus.test_mastering_bus_matches_jax(monkeypatch, tmp_path / "patched",
                                                           capsys)
