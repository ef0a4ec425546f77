"""Checkpoints in the port (``_msgpack.py``, ``checkpoint.py``,
``FirewheelCtx.save_checkpoint``/``load_checkpoint`` and the fleet's),
held against msgpack-python, ``flax.serialization`` and the JAX package.

The port writes the JAX package's file format with its own codec: the
codec's bytes equal msgpack-python's and flax's (flax's wherever the tree
holds no NamedTuple, which JAX writes in field order and the port sorted),
and its leaves are equal everywhere, chunked leaves included.  A stream
saved by either package resumes in the other, and continues as the saving
package's own stream does, to 1e-6 abs.  Fleet checkpoints place each
rank's rows by the offsets the port records (fixing the JAX package's rank
order assumption, ``firewheel_tpu/checkpoint.py:215``).
"""

import json
import os
from typing import NamedTuple

import flax.serialization as fs
import jax
import msgpack
import numpy as np
import pytest
import torch

import firewheel_tpu as fw
from firewheel_tpu import nodes as jn
import firewheel_tpu_torch as ft
from firewheel_tpu_torch import _msgpack, checkpoint, mixer
from firewheel_tpu_torch import nodes as tn
from firewheel_tpu_torch.convert import state_from_jax, state_to_numpy

SR = 48000
TOL = 1e-6
PACKAGES = {"jax": (fw, jn, {}), "port": (ft, tn, {"device": "cpu"})}


# -- the codec --------------------------------------------------------------------

MSGPACK_VALUES = [
    None, True, False, 0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
    2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1,
    -2**63, 1.5, -0.25, 1e300, "", "a" * 31, "b" * 32, "c" * 255, "d" * 256,
    "é" * 40000, b"", b"x" * 300, b"y" * 70000, [], list(range(15)),
    list(range(16)), list(range(70000)), {}, {str(i): i for i in range(15)},
    {str(i): [i, {"k": None}] for i in range(16)},
    {str(i): i for i in range(70000)},
]


@pytest.mark.parametrize("i", range(len(MSGPACK_VALUES)))
def test_msgpack_bytes_equal_msgpack_python(i):
    """Every msgpack type and length form the files use: the port's bytes
    equal msgpack-python's, and each side reads the other's."""
    obj = MSGPACK_VALUES[i]
    data = msgpack.packb(obj)
    assert _msgpack.packb(obj) == data
    back = _msgpack.unpackb(data)
    assert (bytes(back) if isinstance(back, memoryview) else back) == obj
    assert msgpack.unpackb(_msgpack.packb(obj)) == obj


class Pair(NamedTuple):
    target: np.ndarray
    last: np.ndarray


def sample_tree():
    rng = np.random.default_rng(7)
    return {
        "b": {"z": np.float32(3.5), "a": rng.standard_normal((3, 4)).astype(np.float32)},
        "a": np.arange(5, dtype=np.uint32),
        "c": np.array(True),
        "d": (),
        "e": np.zeros((0, 3), np.int32),
        "f": {"x": np.int32(-7), "y": np.array([2**32 - 1], np.uint32)},
        "g": rng.standard_normal((2, 2, 3)).astype(np.float32),
    }


def same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def test_codec_round_trip_and_flax_bytes():
    """A tree of every leaf kind (0-d, empty, bool, uint32, int32, f32, a
    numpy scalar, ``()``) round-trips, equals flax's bytes, and each side
    reads the other's; a NamedTuple is a dict of its fields."""
    tree = sample_tree()
    data = _msgpack.to_bytes(tree)
    assert data == fs.to_bytes(jax.tree.map(lambda x: x, tree))
    back = _msgpack.from_bytes(_msgpack.to_state_dict(tree), data)
    assert jax.tree.all(jax.tree.map(same, back, _msgpack.to_state_dict(tree)))
    theirs = fs.from_bytes(jax.tree.map(lambda x: x, tree), data)
    assert jax.tree.all(jax.tree.map(same, theirs, jax.tree.map(lambda x: x, tree)))
    nt = {"s": Pair(np.ones(2, np.float32), np.zeros(2, np.float32))}
    assert _msgpack.to_bytes(nt) == fs.to_bytes(nt)
    assert set(_msgpack.from_bytes({"s": {"target": 0, "last": 0}},
                                   fs.to_bytes(nt))["s"]) == {"target", "last"}
    with pytest.raises(ValueError, match="missing"):
        _msgpack.from_bytes({"zz": 0}, data)


def test_chunked_leaves_both_ways(monkeypatch):
    """With the chunk limit patched small on both sides, large leaves are
    written in flax's chunked form: equal bytes, read by either side."""
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 40)
    monkeypatch.setattr(_msgpack, "MAX_CHUNK_SIZE", 40)
    rng = np.random.default_rng(3)
    tree = {"big": rng.standard_normal((5, 7)).astype(np.float32),
            "mid": np.arange(11, dtype=np.uint32).reshape(11, 1),
            "small": np.arange(3, dtype=np.int32)}
    data = _msgpack.to_bytes(tree)
    assert data == fs.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in data
    for got in (_msgpack.from_bytes(tree, data), fs.from_bytes(tree, data)):
        assert all(same(got[k], tree[k]) for k in tree)


# -- state files between the packages ----------------------------------------------

def beep_echo(pkg):
    """The JAX package's fleet-checkpoint graph: beep → echo 50 ms → out."""
    mod, nodes, kw = PACKAGES[pkg]
    g = mod.AudioGraph(mod.AudioGraphConfig(0, 2))
    b = g.add_node(0, 2, nodes.BeepTestNode(440.0, -12.0, True))
    e = g.add_node(2, 2, nodes.EchoNode(0.05, 0.4))
    for ch in range(2):
        g.connect(b, ch, e, ch)
        g.connect(e, ch, g.graph_out_node(), ch)
    pk = g.compile(SR, 64)
    return mod.ScheduleProgram(pk.schedule, dict(pk.new_node_processors), SR, **kw)


def mixer3(pkg):
    mod, nodes, kw = PACKAGES[pkg]
    g = mod.AudioGraph(mod.AudioGraphConfig(0, 2))
    mixer.add_mixer(g, 3, "auto", nodes=nodes)
    pk = g.compile(SR, 128)
    return mod.ScheduleProgram(pk.schedule, dict(pk.new_node_processors), SR, **kw)


@pytest.mark.parametrize("build", [beep_echo, mixer3])
def test_state_files_cross_between_packages(build, tmp_path):
    """A rendered JAX state written by flax is read by the port, and the
    port's file by flax: equal leaves (uint32 in the file, int64 in the
    port); equal bytes on the graph without smoothers."""
    jprog = build("jax")
    br = fw.parallel.BatchRenderer(jprog, batch=3)
    _, _, jstate = br.render_chunk(br.stack_params(), br.init_state(), num_blocks=2)
    jhost = jax.tree.map(np.asarray, jstate)
    port = state_from_jax(jhost, "cpu")
    theirs = fs.to_bytes(jhost)
    mine = _msgpack.to_bytes(state_to_numpy(port))
    if build is beep_echo:
        assert mine == theirs
    read = _msgpack.from_bytes(port, theirs)
    assert jax.tree.all(jax.tree.map(same, read, state_to_numpy(port)))
    back = fs.from_bytes(jhost, mine)
    assert jax.tree.all(jax.tree.map(same, back, jhost))
    # the port's file functions, on the same tree
    path = str(tmp_path / "fleet")
    checkpoint.save_sharded_checkpoint(path, port)
    local, meta = checkpoint.load_sharded_local(path, port)
    assert meta["rank_offsets"] == [0] and meta["process_count"] == 1
    assert jax.tree.all(jax.tree.map(same, local, state_to_numpy(port)))
    with open(os.path.join(path, "state.rank0.msgpack"), "rb") as f:
        assert jax.tree.all(jax.tree.map(same, fs.from_bytes(jhost, f.read()), jhost))


def stream(pkg):
    """A ``FirewheelCtx`` on ``pkg`` over the mixer at three voices (its
    filter on "auto", the associative scan on both sides)."""
    mod, nodes, kw = PACKAGES[pkg]
    cx = mod.FirewheelCtx(**kw)
    mixer.add_mixer(cx.graph_mut(), 3, "auto", nodes=nodes)
    sink = mod.ArraySink()
    cx.activate(mod.StreamConfig(SR, 2, buffer_frames=512), sink=sink)
    return cx, sink


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax"),
                                           ("port", "port")])
def test_stream_checkpoint_resumes_across_packages(tmp_path, writer, reader):
    """A stream saved mid-way by ``writer`` resumes in a fresh ``reader``
    ctx at the saved position and continues as ``writer``'s own stream."""
    ck = str(tmp_path / "ck")
    cx1, sink1 = stream(writer)
    cx1.render_offline(0.2)
    frames1 = cx1.stream.frames_rendered
    cx1.save_checkpoint(ck)
    cx1.render_offline(0.2)
    cx1.deactivate()
    truth = sink1.audio(2)

    cx2, sink2 = stream(reader)
    meta = cx2.load_checkpoint(ck)
    assert meta["frames_rendered"] == frames1 == cx2.stream.frames_rendered
    cx2.render_offline(0.2)
    cx2.deactivate()
    resumed = sink2.audio(2)
    n = min(resumed.shape[1], truth.shape[1] - frames1)
    assert n >= 9000
    np.testing.assert_allclose(resumed[:, :n], truth[:, frames1:frames1 + n],
                               atol=TOL, rtol=0)
    assert np.abs(resumed).max() > 0.05
    if "port" in (writer, reader):
        with open(os.path.join(ck, "meta.json")) as f:
            assert set(json.load(f)) == {"sample_rate", "max_block_frames",
                                         "node_keys", "frames_rendered"}


def saved_stream(tmp_path):
    ck = str(tmp_path / "ck")
    cx, _ = stream("port")
    cx.render_offline(0.05)
    cx.save_checkpoint(ck)
    cx.deactivate()
    return ck


@pytest.mark.parametrize("case,match", [
    ("graph", "checkpoint/graph mismatch"),
    ("sample_rate", "sample-rate mismatch"),
    ("block", "max_block_frames mismatch"),
])
def test_checkpoint_mismatch_rejected(tmp_path, case, match):
    ck = saved_stream(tmp_path)
    cx = ft.FirewheelCtx(device="cpu")
    if case == "graph":
        mixer.add_mixer(cx.graph_mut(), 2, "auto")
    else:
        mixer.add_mixer(cx.graph_mut(), 3, "auto")
    cfg = ft.StreamConfig(44100 if case == "sample_rate" else SR, 2,
                          buffer_frames=256 if case == "block" else 512)
    cx.activate(cfg, sink=ft.ArraySink())
    try:
        with pytest.raises(ValueError, match=match):
            cx.load_checkpoint(ck)
    finally:
        cx.deactivate()
    with pytest.raises(RuntimeError, match="activate"):
        ft.FirewheelCtx(device="cpu").save_checkpoint(ck)


# -- fleet checkpoints ----------------------------------------------------------------

def write_ranks(path, rows: dict, offsets):
    """A fleet checkpoint by hand: rank k holds ``rows[k]``; ``offsets``
    (or None, as the JAX package writes) in meta.json."""
    os.makedirs(path, exist_ok=True)
    for k, tree in rows.items():
        with open(os.path.join(path, f"state.rank{k}.msgpack"), "wb") as f:
            f.write(fs.to_bytes(tree))
    meta = {"sharded": True, "process_count": len(rows), "node_keys": ["n"]}
    if offsets is not None:
        meta["rank_offsets"] = offsets
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)


def test_resharded_restore_places_rows_by_rank_offsets(tmp_path):
    """Two ranks whose rows are not in rank order (rank 0 holds rows 4..7,
    rank 1 rows 0..3): the port reads every row where its offset puts it;
    without offsets (a JAX package file) it reads rank order; offsets that
    do not tile the batch are refused."""
    rows = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    counts = np.arange(8, dtype=np.uint32)
    tree = lambda lo, hi: {"n": {"x": rows[lo:hi], "c": counts[lo:hi]}}  # noqa: E731
    template = {"n": {"x": torch.empty((8, 3), device="meta"),
                      "c": torch.empty((8,), dtype=torch.int64, device="meta")}}
    swapped = str(tmp_path / "swapped")
    write_ranks(swapped, {0: tree(4, 8), 1: tree(0, 4)}, [4, 0])
    local, _ = checkpoint.load_sharded_local(swapped, template, global_batch=8)
    np.testing.assert_array_equal(local["n"]["x"], rows)
    np.testing.assert_array_equal(local["n"]["c"], counts)
    jaxfile = str(tmp_path / "rank_order")
    write_ranks(jaxfile, {0: tree(0, 4), 1: tree(4, 8)}, None)
    local, _ = checkpoint.load_sharded_local(jaxfile, template, global_batch=8)
    np.testing.assert_array_equal(local["n"]["x"], rows)
    with pytest.raises(ValueError, match="global_batch"):
        checkpoint.load_sharded_local(jaxfile, template)
    for bad in ([0, 0], [4, 2], [0], [0, 4.0]):
        path = str(tmp_path / f"bad{len(os.listdir(tmp_path))}")
        write_ranks(path, {0: tree(0, 4), 1: tree(4, 8)}, bad)
        with pytest.raises(ValueError, match="rank_offsets"):
            checkpoint.load_sharded_local(path, template, global_batch=8)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_fleet_checkpoint_roundtrip(tmp_path, writer):
    """A BatchRenderer fleet saved by either package restores in the port
    (and the port's in JAX): the next chunk equals the saving renderer's
    continuation, bit for bit within the port, 1e-6 across; event
    baselines re-set; a batch mismatch is refused."""
    ck = str(tmp_path / "fleet")
    prog = beep_echo(writer)
    mod = fw.parallel if writer == "jax" else ft
    br = mod.BatchRenderer(prog, batch=4, **PACKAGES[writer][2])
    params, state = br.stack_params(), br.init_state()
    _, _, state = br.render_chunk(params, state, num_blocks=2)
    br.save_checkpoint(ck, state, extra_meta={"app": {"tick": 17}})
    truth, _, _ = br.render_chunk(params, state, num_blocks=2)
    for reader in ("port", "jax"):
        rb = (ft.BatchRenderer(beep_echo("port"), 4, device="cpu") if reader == "port"
              else fw.parallel.BatchRenderer(beep_echo("jax"), batch=4))
        state2, meta = rb.restore_checkpoint(ck)
        assert meta["app"] == {"tick": 17} and meta["batch"] == 4
        out, _, _ = rb.render_chunk(rb.stack_params(), state2, num_blocks=2)
        got, want = np.asarray(out), np.asarray(truth)
        if reader == writer:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    wrong = ft.BatchRenderer(beep_echo("port"), 8, device="cpu")
    with pytest.raises(ValueError, match="batch mismatch"):
        wrong.restore_checkpoint(ck)
