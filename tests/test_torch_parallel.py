"""The port's scale-out (``parallel/mesh.py``) against the JAX package's.

``VoiceParallelMixer`` unmeshed against JAX's on ``tests/test_parallel.py``'s
voice and master programs, and with state carried over chunks; the
ownership rules of a sharded ``BatchRenderer`` on one process (a mesh
stand-in); and one spawn of four gloo ranks on the CPU that reads the
topology through the process group and holds the sharded paths against
JAX: ``BatchRenderer`` at dp=4 with per-instance
splices, resets and events, the hybrid lowering over the ``"dp"`` axis of
a 2-D mesh, ``VoiceParallelMixer`` at vp=4 and over the 2-D mesh's ``"vp"``
axis, and a four-rank fleet checkpoint read back in one process by the
port and by JAX.  The ranks import torch and the port only; this process
computes the JAX side meanwhile.
"""

import types

import jax
import numpy as np
import pytest
import torch

import firewheel_tpu as fw
from firewheel_tpu.parallel import BatchRenderer as JaxBatchRenderer
from firewheel_tpu.parallel import VoiceParallelMixer as JaxMixer
from firewheel_tpu.parallel import make_mesh as jax_mesh
from firewheel_tpu_torch.convert import params_from_jax, state_from_jax, tree_map
from firewheel_tpu_torch.parallel import BatchRenderer, VoiceParallelMixer, make_mesh
from test_torch_distributed import start_ranks, wait_ranks

SR = 48000

#: the graphs and sessions both packages build, from either package's
#: names (``pk``): exec'd here with the JAX package's and the port's, and
#: imported by the ranks with the port's
COMMON = r'''
import numpy as np

SR = 48000
FLEET_B, FLEET_K, FLEET_F = 8, 2, 64
VOICES, MIX_K = 16, 2


def fleet_program(pk):
    """tests/test_fleet_resume.py's template: a tone through a volume and a
    256-frame sampler one-shot, summed; 64-frame blocks."""
    g = pk.AudioGraph(pk.AudioGraphConfig(0, 2))
    n = {"tone": pk.nodes.BeepTestNode(440.0, -12.0, True),
         "vol": pk.nodes.VolumeNode(0.0), "sfx": pk.nodes.SamplerNode(100.0)}
    n["sfx"].set_sample(pk.SampleResource(
        np.linspace(0.2, 0.0, 256, dtype=np.float32)[None, :] * np.ones((2, 1), np.float32),
        device=False))
    tid, vid = g.add_node(0, 2, n["tone"]), g.add_node(2, 2, n["vol"])
    sid, mix = g.add_node(0, 2, n["sfx"]), g.add_node(4, 2, pk.nodes.SumNode())
    for c in range(2):
        g.connect(tid, c, vid, c)
        g.connect(vid, c, mix, c)
        g.connect(sid, c, mix, 2 + c)
        g.connect(mix, c, g.graph_out_node(), c)
    return pk.program(g.compile(SR, FLEET_F)), n


def fleet_snapshots(prog, n):
    """One snapshot per instance: volume 10·(i+1) %, the one-shot playing
    on instances 1 and 6; then instance 3's splice (50 %, playing)."""
    snaps = []
    for i in range(FLEET_B):
        n["vol"].set_percent_volume(10.0 * (i + 1))
        if i in (1, 6):
            n["sfx"].play()
        snaps.append(prog.collect_params())
    n["vol"].set_percent_volume(50.0)
    n["sfx"].play()
    return snaps, prog.collect_params()


def fleet_session(br, prog, n, save=None):
    """Four chunks of the fleet: two, a poll, instance 3 spliced and
    instance 6 reset, one more, (a checkpoint to ``save``), one more and a
    poll → the chunks, the polls' events and the params."""
    snaps, splice = fleet_snapshots(prog, n)
    params, state = br.stack_params(snaps), br.init_state()
    outs, polls, s = [], [], 0
    for c in range(4):
        if c == 2:
            polls.append(events(br.poll_events(state)))
            params = br.update_instance(params, 3, splice)
            state = br.reset_instance(state, 6)
        if c == 3 and save is not None:
            br.save_checkpoint(save, state, extra_meta={"app": {"tick": 7}})
        out, _, state = br.render_chunk(params, state, start_sample=s, num_blocks=FLEET_K)
        outs.append(np.asarray(out))
        s += FLEET_K * FLEET_F
    polls.append(events(br.poll_events(state)))
    return outs, polls, params


def events(evs):
    return sorted((e.instance, e.name, e.count, e.total, -1 if e.lane is None else e.lane)
                  for e in evs)


def voice_program(pk):
    """tests/test_parallel.py's voice: a beep (-24 dB) through a pan."""
    g = pk.AudioGraph(pk.AudioGraphConfig(0, 2))
    v = {"beep": pk.nodes.BeepTestNode(440.0, -24.0, True), "pan": pk.nodes.StereoPanNode(0.0)}
    beep, pan = g.add_node(0, 2, v["beep"]), g.add_node(2, 2, v["pan"])
    for c in range(2):
        g.connect(beep, c, pan, c)
        g.connect(pan, c, g.graph_out_node(), c)
    return pk.program(g.compile(SR, 128)), v


def master_program(pk):
    """tests/test_parallel.py's master: a hard clip at 0 dB."""
    g = pk.AudioGraph(pk.AudioGraphConfig(num_graph_inputs=2, num_graph_outputs=2))
    clip = g.add_node(2, 2, pk.nodes.HardClipNode(0.0))
    for c in range(2):
        g.connect(g.graph_in_node(), c, clip, c)
        g.connect(clip, c, g.graph_out_node(), c)
    return pk.program(g.compile(SR, 128))


def voice_snapshots(prog, v, voices):
    """Voice i: 110·(1 + i mod 12) Hz, panned across [-1, 1]."""
    snaps = []
    for i in range(voices):
        v["beep"].set_frequency(110.0 * (1 + i % 12))
        v["pan"].set_pan(2.0 * i / max(voices - 1, 1) - 1.0)
        snaps.append(prog.collect_params())
    return snaps


def mix_session(mixer, snaps, chunks=2):
    """``chunks`` chunks of MIX_K blocks carrying state → the outputs and
    the final state."""
    params, state = mixer.stack_voice_params(snaps), mixer.init_state()
    outs = []
    for c in range(chunks):
        out, _, state = mixer.render_chunk(params, state, start_sample=c * MIX_K * 128,
                                           num_blocks=MIX_K)
        outs.append(np.asarray(out))
    return outs, state
'''

RANKS = r'''
import firewheel_tpu_torch as ft
from firewheel_tpu_torch.convert import tree_map
from firewheel_tpu_torch.parallel import BatchRenderer, VoiceParallelMixer, make_mesh
from firewheel_tpu_torch.parallel import distributed, local_batch_slice
from common import *
from firewheel_tpu_torch.checkpoint import read_meta

pk = port_names()
got = {}

# the topology read through the process group
assert (distributed.process_count(), distributed.process_index()) == (4, rank)
assert local_batch_slice(8) == slice(2 * rank, 2 * rank + 2)

# BatchRenderer at dp=4: 2 rows a rank, splices, resets and polls by
# global instance, a four-rank checkpoint before chunk 3
prog, n = fleet_program(pk)
br = BatchRenderer(prog, FLEET_B, device="cpu", mesh=make_mesh({"dp": 4}, "cpu"))
assert br.local_rows == slice(2 * rank, 2 * rank + 2)
outs, polls, params = fleet_session(br, prog, n, save=os.path.join(work, "ck"))
assert read_meta(os.path.join(work, "ck"))["rank_offsets"] == [0, 2, 4, 6]
for c, o in enumerate(outs):
    got[f"dp_c{c}"] = o
for p, evs in enumerate(polls):
    got[f"dp_poll{p}"] = np.asarray(evs, dtype=object)

# a fresh dp=4 fleet restores its own rows of the checkpoint
fresh = BatchRenderer(fleet_program(pk)[0], FLEET_B, device="cpu",
                      mesh=make_mesh({"dp": 4}, "cpu"))
state, meta = fresh.restore_checkpoint(os.path.join(work, "ck"))
assert meta["app"] == {"tick": 7} and meta["batch"] == FLEET_B
out, _, _ = fresh.render_chunk(params, state, start_sample=3 * FLEET_K * FLEET_F,
                               num_blocks=FLEET_K)
assert np.array_equal(np.asarray(out), outs[3])
assert fresh.poll_events(state) == []

# VoiceParallelMixer at vp=4
vp, v = voice_program(pk)
mixer = VoiceParallelMixer(vp, VOICES, master_program(pk), mesh=make_mesh({"vp": 4}, "cpu"))
mouts, mstate = mix_session(mixer, voice_snapshots(vp, v, VOICES))
assert mixer.collectives == 2 and mixer.local_voices == slice(4 * rank, 4 * rank + 4)
for c, o in enumerate(mouts):
    got[f"vp_c{c}"] = o

# a 2-D mesh: the hybrid effects chain over "dp", 8 voices over "vp"
mesh2 = make_mesh({"dp": 2, "vp": 2}, "cpu")
fx = ft.effects_chain_graph(device="cpu")
ref = ft.BatchRenderer(fx, 4, device="cpu", lowering="hybrid")
fx_params = ft.mixer.vary_effects_params(ref.stack_params())
fx_state = ref.init_state()
sharded = BatchRenderer(fx, 4, device="cpu", lowering="hybrid", tile=2, mesh=mesh2, axis="dp")
rows = sharded.local_rows
assert rows == slice(2 * (rank // 2), 2 * (rank // 2) + 2)
mine = lambda t: t[rows].clone()
sp, ss = tree_map(mine, fx_params), tree_map(mine, fx_state)
for c in range(2):
    want, _, fx_state = ref.render_chunk(fx_params, fx_state, start_sample=c * 256, num_blocks=2)
    out, _, ss = sharded.render_chunk(sp, ss, start_sample=c * 256, num_blocks=2)
    assert torch.equal(out, want[rows]), c
mixer2 = VoiceParallelMixer(vp, 8, master_program(pk), mesh=mesh2, axis="vp")
assert mixer2.local_voices == slice(4 * (rank % 2), 4 * (rank % 2) + 4)
snaps = voice_snapshots(vp, v, 8)
m2, st2 = mix_session(mixer2, snaps)
m1, st1 = mix_session(VoiceParallelMixer(vp, 8, master_program(pk)), snaps)
for a, b in zip(m2, m1):
    assert np.abs(a - b).max() <= 1e-6
for a, b in zip(tree_leaves(st2["master"]), tree_leaves(st1["master"])):
    assert np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max() <= 1e-6
# the batch axis holds the same rows on both "vp" ranks: no checkpoint
try:
    sharded.save_checkpoint(os.path.join(work, "ck2"), ss)
except ValueError as e:
    assert "span" in str(e)
else:
    raise AssertionError("a 2-D mesh's replicated rows were checkpointed")

np.savez(os.path.join(work, f"rank{rank}.npz"), **got)
torch.distributed.destroy_process_group()
print(f"RANK{rank}_OK", flush=True)
'''

PORT_NAMES = r'''

def port_names():
    import types
    import firewheel_tpu_torch as ft
    return types.SimpleNamespace(
        AudioGraph=ft.AudioGraph, AudioGraphConfig=ft.AudioGraphConfig, nodes=ft.nodes,
        SampleResource=ft.SampleResource,
        program=lambda pkg: ft.ScheduleProgram(pkg.schedule, dict(pkg.new_node_processors),
                                               SR, device="cpu"))


def tree_leaves(t):
    return [x for v in t.values() for x in tree_leaves(v)] if isinstance(t, dict) else [t]
'''


def _common():
    ns: dict = {}
    exec(COMMON + PORT_NAMES, ns)
    return types.SimpleNamespace(**ns)


C = _common()
JAX = types.SimpleNamespace(
    AudioGraph=fw.AudioGraph, AudioGraphConfig=fw.AudioGraphConfig, nodes=fw.nodes,
    SampleResource=fw.core.sample_resource.SampleResource,
    program=lambda pkg: fw.ScheduleProgram(pkg.schedule, dict(pkg.new_node_processors), SR))
PORT = C.port_names()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_trees_close(a, b, atol):
    """Equal structure, leaves within ``atol`` (integer leaves equal)."""
    assert set(a) == set(b) if isinstance(a, dict) else True
    tree_map(lambda x, y: np.testing.assert_allclose(
        x.numpy().astype(np.float64), y.numpy().astype(np.float64), atol=atol, rtol=0),
        a, b)


# -- VoiceParallelMixer without a mesh ----------------------------------------------

def test_unmeshed_mix_matches_jax_and_the_clipped_voice_sum():
    vp, _ = C.voice_program(PORT)
    mixer = VoiceParallelMixer(vp, 8, C.master_program(PORT))
    out, om, state = mixer.render_chunk(mixer.stack_voice_params(), mixer.init_state(),
                                        num_blocks=3)
    assert out.shape == (3, 2, 128) and om.shape == (3, 2) and mixer.collectives == 0

    jvp, _ = C.voice_program(JAX)
    jm = JaxMixer(jvp, num_voices=8, master_program=C.master_program(JAX))
    jout, jom, jstate = jm.render_chunk(jm.stack_voice_params(), jm.init_state(), num_blocks=3)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(om.numpy(), np.asarray(jom))
    _assert_trees_close(state, state_from_jax(_np(jstate), "cpu"), 1e-6)

    # 8 identical voices at -24 dB each, clipped at 0 dB by the master
    single, _, _ = vp.render_chunk(vp.collect_params(), vp.init_state(),
                                   torch.zeros((3, 0, 128)), torch.zeros((3, 0), dtype=torch.bool))
    np.testing.assert_allclose(out.numpy(), np.clip(single.numpy() * 8.0, -1.0, 1.0),
                               atol=1e-5, rtol=0)


def test_state_carries_across_chunks_and_from_jax():
    """Two chunks carrying state are a continuous sine; and the port,
    started from the JAX mixer's params and state after its first chunk
    (``params_from_jax``/``state_from_jax``), renders JAX's second."""
    vp, v = C.voice_program(PORT)
    mixer = VoiceParallelMixer(vp, 8)
    params, state = mixer.stack_voice_params(), mixer.init_state()
    o1, _, state = mixer.render_chunk(params, state, num_blocks=2)
    o2, _, state = mixer.render_chunk(params, state, start_sample=256, num_blocks=2)
    sig = torch.cat([o1[:, 0].reshape(-1), o2[:, 0].reshape(-1)]).numpy()
    gain = 8 * 10 ** (-24 / 20) * np.cos(np.pi / 4)
    ideal = gain * np.sin(2 * np.pi * 440 / SR * np.arange(4 * 128))
    np.testing.assert_allclose(sig, ideal, atol=1e-4)

    jvp, jv = C.voice_program(JAX)
    snaps = C.voice_snapshots(jvp, jv, 8)
    jm = JaxMixer(jvp, num_voices=8, master_program=C.master_program(JAX))
    jparams, jstate = jm.stack_voice_params(snaps), jm.init_state()
    _, _, jstate = jm.render_chunk(jparams, jstate, num_blocks=2)
    jout, _, jstate = jm.render_chunk(jparams, jstate, start_sample=256, num_blocks=2)

    pm = VoiceParallelMixer(vp, 8, C.master_program(PORT))
    out, _, st = pm.render_chunk(params_from_jax(_np(jparams), "cpu"),
                                 state_from_jax(_np(jm.init_state()), "cpu"), num_blocks=2)
    out, _, st = pm.render_chunk(params_from_jax(_np(jparams), "cpu"), st,
                                 start_sample=256, num_blocks=2)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-6, rtol=0)
    # and from JAX's state after one chunk
    _, _, jmid = jm.render_chunk(jparams, jm.init_state(), num_blocks=2)
    out2, _, _ = pm.render_chunk(params_from_jax(_np(jparams), "cpu"),
                                 state_from_jax(_np(jmid), "cpu"), start_sample=256,
                                 num_blocks=2)
    np.testing.assert_allclose(out2.numpy(), np.asarray(jout), atol=1e-6, rtol=0)


# -- a sharded BatchRenderer on one process ------------------------------------------

class _Mesh:
    """The three things a renderer reads of a mesh, for rank ``rank`` of a
    1-D mesh of ``size``."""

    def __init__(self, size, rank, name="dp"):
        self.mesh_dim_names = (name,)
        self._size, self._rank = size, rank

    def size(self, dim=None):
        return self._size

    def get_local_rank(self, axis=None):
        return self._rank


@pytest.mark.parametrize("rank", [0, 3])
def test_a_rank_owns_its_rows(rank):
    """Rank ``rank`` of four: it stacks, renders and polls its two rows
    of the global batch, writes splices and resets only on them, and
    renders its rows of a global ``graph_in``."""
    prog, n = C.fleet_program(PORT)
    full = BatchRenderer(prog, 8, device="cpu")
    br = BatchRenderer(prog, 8, device="cpu", mesh=_Mesh(4, rank))
    rows = br.local_rows
    assert rows == slice(2 * rank, 2 * rank + 2)
    snaps, splice = C.fleet_snapshots(prog, n)
    params, state = br.stack_params(snaps), br.init_state()
    fparams, fstate = full.stack_params(snaps), full.init_state()
    assert all(t.shape[0] == 2 for t in C.tree_leaves(state) + C.tree_leaves(params))
    for index in (3, 6):
        before = [t.clone() for t in C.tree_leaves(params)]
        params = br.update_instance(params, index, splice)
        fparams = full.update_instance(fparams, index, splice)
        changed = any(not torch.equal(a, b) for a, b in zip(before, C.tree_leaves(params)))
        assert changed == (rows.start <= index < rows.stop)
    with pytest.raises(IndexError):
        br.update_instance(params, 8, splice)
    gin = torch.zeros((8, 2, 0, 64))
    for c in range(2):
        out, _, state = br.render_chunk(params, state, gin, start_sample=c * 128, num_blocks=2)
        fout, _, fstate = full.render_chunk(fparams, fstate, start_sample=c * 128,
                                            num_blocks=2)
        assert torch.equal(out, fout[rows])
    assert C.events(br.poll_events(state)) == [
        e for e in C.events(full.poll_events(fstate)) if rows.start <= e[0] < rows.stop]
    with pytest.raises(ValueError, match="rows"):
        br.render_chunk(params, state, torch.zeros((2, 2, 0, 64)), num_blocks=2)
    with pytest.raises(ValueError, match="divide"):
        BatchRenderer(prog, 6, device="cpu", mesh=_Mesh(4, rank))


def test_make_mesh_needs_the_process_group():
    with pytest.raises(RuntimeError, match="initialize_multihost"):
        make_mesh({"dp": 1}, "cpu")


# -- four gloo ranks ------------------------------------------------------------------

def test_four_ranks_against_jax(tmp_path):
    work = str(tmp_path)
    (tmp_path / "common.py").write_text(COMMON + PORT_NAMES)
    procs = start_ranks(RANKS, 4, work)
    try:
        # JAX's unsharded fleet and its vp=4 mixer, meanwhile
        jprog, jn = C.fleet_program(JAX)
        jbr = JaxBatchRenderer(jprog, batch=C.FLEET_B)
        jouts, jpolls, jparams = C.fleet_session(jbr, jprog, jn)
        jvp, jv = C.voice_program(JAX)
        jm = JaxMixer(jvp, num_voices=C.VOICES, master_program=C.master_program(JAX),
                      mesh=jax_mesh({"vp": 4}))
        jmouts, _ = C.mix_session(jm, C.voice_snapshots(jvp, jv, C.VOICES))
    finally:
        wait_ranks(procs, timeout=150)

    ranks = [np.load(tmp_path / f"rank{r}.npz", allow_pickle=True) for r in range(4)]
    for c in range(4):
        got = np.concatenate([r[f"dp_c{c}"] for r in ranks])
        np.testing.assert_allclose(got, jouts[c], atol=1e-6, rtol=0)
    for p in range(2):
        got = sorted(tuple(e) for r in ranks for e in r[f"dp_poll{p}"].tolist())
        assert got == jpolls[p]
    assert {1, 6} <= {e[0] for e in jpolls[0]} and 3 in {e[0] for e in jpolls[1]}
    for r in ranks:
        for c in range(2):
            np.testing.assert_allclose(r[f"vp_c{c}"], jmouts[c], atol=1e-5, rtol=0)

    # the four ranks' checkpoint, read in one process (4 → 1): the port's
    # renderer bit for bit, JAX's within 1e-6, against the continuation
    ck = str(tmp_path / "ck")
    prog, _ = C.fleet_program(PORT)
    br = BatchRenderer(prog, C.FLEET_B, device="cpu")
    state, meta = br.restore_checkpoint(ck)
    assert meta["process_count"] == 4 and meta["app"] == {"tick": 7}
    start = 3 * C.FLEET_K * C.FLEET_F
    out, _, _ = br.render_chunk(params_from_jax(_np(jparams), "cpu"), state,
                                start_sample=start, num_blocks=C.FLEET_K)
    truth = np.concatenate([r["dp_c3"] for r in ranks])
    np.testing.assert_array_equal(out.numpy(), truth)
    assert br.poll_events(state) == []

    jstate, jmeta = jbr.restore_checkpoint(ck)  # its chunk program compiled already
    jout, _, _ = jbr.render_chunk(jparams, jstate, start_sample=start,
                                  num_blocks=C.FLEET_K)
    np.testing.assert_allclose(np.asarray(jout), truth, atol=1e-6, rtol=0)
    assert jmeta["batch"] == C.FLEET_B


def test_the_mixer_split_over_voices_matches_jax():
    """The mixer's voices and bus as a ``VoiceParallelMixer`` (the bus's
    lowpass on K1's plain version here), each voice its own frequency,
    volume and pan, three chunks carrying state: the port within 1e-6 of
    JAX's mixer on the same graphs (built by ``mixer.add_voice_graph`` and
    ``add_mix_bus`` from either package's nodes), master state too."""
    from firewheel_tpu_torch.mixer import add_mix_bus, add_voice_graph, voice_mix_programs
    from firewheel_tpu_torch.mixer import voice_snapshots

    vp, mp, v = voice_mix_programs(device="cpu")
    pm = VoiceParallelMixer(vp, 12, mp)
    outs, state = C.mix_session(pm, voice_snapshots(vp, v, 12), chunks=3)

    g = fw.AudioGraph(fw.AudioGraphConfig(0, 2))
    jv = add_voice_graph(g, nodes=fw.nodes)
    jvp = JAX.program(g.compile(SR, 128))
    g = fw.AudioGraph(fw.AudioGraphConfig(num_graph_inputs=2, num_graph_outputs=2))
    add_mix_bus(g, "pallas", nodes=fw.nodes)
    jm = JaxMixer(jvp, num_voices=12, master_program=JAX.program(g.compile(SR, 128)))
    jouts, jstate = C.mix_session(jm, voice_snapshots(jvp, jv, 12), chunks=3)
    for o, jo in zip(outs, jouts):
        np.testing.assert_allclose(o, jo, atol=1e-6, rtol=0)
    assert 0.01 < np.abs(outs[-1]).max() <= 1.0
    _assert_trees_close(state["master"], state_from_jax(_np(jstate["master"]), "cpu"), 1e-6)
