"""The mastering bus (``mixer.mastering_bus_graph``, the chain of
``examples/mastering_bus.py``) held against the JAX package's own bus on
the CPU, both built by ``mixer.add_mastering_bus`` from their own nodes.

The bus renders batched (B=2, K=4) through both packages'
``BatchRenderer`` and streamed (256-frame buffers, the dialogue toggled)
through both ``GraphProcessor``s: every output sample and every state leaf
within 1e-6, but for the loudness meter's filter states and ring.  Under
``jit`` XLA contracts the biquad scan's compositions into fused
multiply-adds, and the K-weighting's 38 Hz high-pass, a pole next to 1,
amplifies those roundings in its state (~1e-4 measured, on states of
~0.07); there the meter is held by its reading (momentary and short-term
loudness within 1e-3 LU) and its counts, position and index (equal).  The
meter's kernel itself is held op for op in ``test_torch_loudness.py``.
"""

import jax
import numpy as np
import pytest

import firewheel_tpu as fw
from firewheel_tpu import nodes as jn
from firewheel_tpu.parallel import BatchRenderer as JaxBatchRenderer
import firewheel_tpu_torch as ft
from firewheel_tpu_torch import mixer
from firewheel_tpu_torch import nodes as tn
from firewheel_tpu_torch.convert import state_from_jax, state_to_numpy
from firewheel_tpu_torch.executor_mega import MegaRenderer

SR, F = 48000, 128
TOL = 1e-6
LU_TOL = 1e-3
#: the meter's leaves that these tests hold by the meter's reading
METER_FILTERED = ("shelf_z", "hp_z", "ring")


def _normalize(tree):
    return state_to_numpy(state_from_jax(jax.tree.map(np.asarray, tree), "cpu"))


def _bus_program(pkg, block=F):
    g = (fw if pkg == "jax" else ft).AudioGraph(
        (fw if pkg == "jax" else ft).AudioGraphConfig(0, 2))
    ids = mixer.add_mastering_bus(g, nodes=jn if pkg == "jax" else None)
    pk = g.compile(SR, block)
    if pkg == "jax":
        return fw.ScheduleProgram(pk.schedule, dict(pk.new_node_processors), SR), ids
    return ft.ScheduleProgram(pk.schedule, dict(pk.new_node_processors), SR,
                              device="cpu"), ids


def _to_jax_params(template, tree):
    """The port's stacked params (numpy) in the JAX tree's structure and
    dtypes; a JAX leaf the port has no value for (a stateless node's ``()``)
    is kept."""
    if isinstance(template, dict):
        return {k: _to_jax_params(v, tree.get(k, v)) for k, v in template.items()}
    if isinstance(tree, np.ndarray):
        return tree.astype(np.asarray(template).dtype)
    return template


def assert_bus_close(got, want, meter_key):
    """Two bus states (numpy trees): every leaf within 1e-6 or equal, the
    meter held by its reading (see the module docstring)."""
    assert got.keys() == want.keys()
    for key in want:
        for leaf in want[key]:
            a, b = got[key][leaf], want[key][leaf]
            assert a.dtype == b.dtype and a.shape == b.shape, (key, leaf)
            if key == meter_key and leaf in METER_FILTERED:
                continue
            if a.dtype.kind == "f":
                np.testing.assert_allclose(a, b, atol=TOL, rtol=0, err_msg=f"{key}/{leaf}")
            else:
                np.testing.assert_array_equal(a, b, err_msg=f"{key}/{leaf}")
    g = np.asarray([list(tn.LoudnessMeterNode.read(
        {k: v[i] for k, v in got[meter_key].items()}).values())
        for i in range(len(got[meter_key]["idx"]))])
    w = np.asarray([list(jn.LoudnessMeterNode.read(
        {k: v[i] for k, v in want[meter_key].items()}).values())
        for i in range(len(want[meter_key]["idx"]))])
    np.testing.assert_allclose(g, w, atol=LU_TOL, rtol=0)


def test_mastering_bus_batched_equals_jax():
    """B=2, K=4, three chunks, per-instance seeds, thresholds, duck depth and
    makeup, the dialogue on in instance 1 (``vary_mastering_params``)."""
    b, k = 2, 4
    tprog, ids = _bus_program("port")
    jprog, _ = _bus_program("jax")
    tbr = ft.BatchRenderer(tprog, b, device="cpu")
    jbr = JaxBatchRenderer(jprog, b)
    tp = mixer.vary_mastering_params(tprog, tbr.stack_params(), seed=3)
    jp = _to_jax_params(jax.tree.map(np.asarray, jbr.stack_params()), state_to_numpy(tp))
    ts, js = tbr.init_state(), jbr.init_state()
    for c in range(3):
        start = c * k * F
        to, tm, ts = tbr.render_chunk(tp, ts, start_sample=start, num_blocks=k)
        jo, jm, js = jbr.render_chunk(jp, js, start_sample=start, num_blocks=k)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=TOL, rtol=0,
                                   err_msg=f"chunk {c}")
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert np.abs(to.numpy()).max() > 0.05
    assert_bus_close(state_to_numpy(ts), _normalize(js), ft.node_key(ids["meter"]))


def test_mastering_bus_refuses_the_megakernel():
    """The noise and the FIR have no row in K2 (nor in the JAX package's
    megakernel), so ``MegaRenderer`` refuses the bus with its existing error,
    before any launch; the hybrid renders the other six nodes in two K3
    islands (``test_torch_bus_megakernel.py``)."""
    prog, _ = _bus_program("port")
    with pytest.raises(ValueError, match="not eligible for the megakernel"):
        MegaRenderer(prog, 1, 1, device="cpu")


class BusStream:
    """One package's mastering bus through its ``GraphContext`` and
    ``GraphProcessor``, in 256-frame buffers and blocks, as the example
    streams it."""

    FRAMES = 256

    def __init__(self, pkg):
        mod = fw if pkg == "jax" else ft
        self.cx = mod.GraphContext(mod.AudioGraphConfig(0, 2))
        self.ids = mixer.add_mastering_bus(self.cx.graph, jn if pkg == "jax" else None)
        kw = {} if pkg == "jax" else {"device": "cpu"}
        self.proc = self.cx.activate(SR, 0, 2, self.FRAMES, **kw)
        self.cx.update()
        self.sample = 0

    def render(self, dialogue: bool):
        self.cx.graph.node(self.ids["voice"]).set_enabled(dialogue)
        out = np.zeros(self.FRAMES * 2, np.float32)
        self.proc.process_interleaved(np.zeros(0, np.float32), out, 0, 2, self.FRAMES,
                                      self.sample / SR)
        self.sample += self.FRAMES
        return out

    def state(self):
        st = self.proc.state_dict()
        return _normalize(st) if isinstance(self.proc, fw.GraphProcessor) else \
            state_to_numpy(st)


def test_mastering_bus_streamed_equals_jax():
    """Eight 256-frame buffers, the dialogue on for buffers 2..5: every
    buffer within 1e-6, the final states and the meter's reading as
    above."""
    jax_s, port_s = BusStream("jax"), BusStream("port")
    for i in range(8):
        on = 2 <= i < 6
        np.testing.assert_allclose(port_s.render(on), jax_s.render(on), atol=TOL,
                                   rtol=0, err_msg=f"buffer {i}")
    key = ft.node_key(port_s.ids["meter"])
    wrap = lambda s: {k: {leaf: v[None] for leaf, v in st.items()}  # noqa: E731
                      for k, st in s.items()}
    assert_bus_close(wrap(port_s.state()), wrap(jax_s.state()), key)
    assert port_s.state()[key]["idx"] == 0 and port_s.state()[key]["pos"] == 8 * 256
