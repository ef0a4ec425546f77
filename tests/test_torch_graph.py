"""The port's copy of the graph layer runs the reference compiler suite.

``tests/test_compiler.py`` holds the reference engine's schedule tests
(schedule.rs:392-711) against the JAX package's graph layer.  Here each of
those tests runs again with its graph classes rebound to
``firewheel_tpu_torch``'s, and every graph it builds must also compile to
the same schedule (the same ``repr``) in both packages.
"""

import types

import pytest

import test_compiler as reference
from firewheel_tpu import graph as jgraph
from firewheel_tpu import nodes as jnodes
from firewheel_tpu_torch import graph as tgraph
from firewheel_tpu_torch import nodes as tnodes

CASES = sorted(n for n in vars(reference) if n.startswith("test_"))


def _rebound(fn, graph_mod, nodes_mod, compiled):
    """``fn`` with its module globals pointed at one package; every
    ``compile_internal`` result is appended to ``compiled``."""

    class RecordingGraph(graph_mod.AudioGraph):
        def compile_internal(self, max_block_frames):
            schedule = super().compile_internal(max_block_frames)
            compiled.append(repr(schedule))
            return schedule

    env = dict(fn.__globals__)
    env.update(
        AudioGraph=RecordingGraph,
        AudioGraphConfig=graph_mod.AudioGraphConfig,
        InputPortAlreadyConnected=graph_mod.InputPortAlreadyConnected,
        DummyAudioNode=nodes_mod.DummyAudioNode,
    )
    return types.FunctionType(fn.__code__, env, fn.__name__, fn.__defaults__,
                              fn.__closure__)


@pytest.mark.parametrize("name", CASES)
def test_reference_compiler_case_on_the_port(name):
    fn = getattr(reference, name)
    port_schedules, jax_schedules = [], []
    _rebound(fn, tgraph, tnodes, port_schedules)()
    _rebound(fn, jgraph, jnodes, jax_schedules)()
    assert port_schedules == jax_schedules
