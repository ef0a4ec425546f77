"""A two-rank ``SessionServer`` fleet of the port killed and resumed
(``tests/test_fleet_resume.py``'s two-process case, on the port, over
gloo on the CPU): the fleet runs mid-stream at dp=2, both ranks save one
checkpoint, the processes exit, and a fresh two-rank fleet restores it.
Each rank's resumed render is bit for bit the uninterrupted one, the slot
allocator is intact, no event from before the kill is replayed, and a
command after the restore fires exactly once.  The same checkpoint then
restores in one process (2 → 1) bit for bit."""

import numpy as np

import firewheel_tpu_torch as ft
from test_torch_distributed import spawn_ranks

COMMON = r'''
import numpy as np
import firewheel_tpu_torch as ft
from firewheel_tpu_torch.parallel import make_mesh

SR, F, K, CAPACITY = 48000, 64, 2, 8


def make_server(mesh=None):
    g = ft.AudioGraph(ft.AudioGraphConfig(0, 2))
    n = {"tone": ft.nodes.BeepTestNode(440.0, -12.0, True), "vol": ft.nodes.VolumeNode(0.0),
         "sfx": ft.nodes.SamplerNode(100.0)}
    n["sfx"].set_sample(ft.SampleResource(
        np.linspace(0.2, 0.0, 256, dtype=np.float32)[None, :] * np.ones((2, 1), np.float32),
        device=False))
    tid, vid = g.add_node(0, 2, n["tone"]), g.add_node(2, 2, n["vol"])
    sid, mix = g.add_node(0, 2, n["sfx"]), g.add_node(4, 2, ft.nodes.SumNode())
    for c in range(2):
        g.connect(tid, c, vid, c)
        g.connect(vid, c, mix, c)
        g.connect(sid, c, mix, 2 + c)
        g.connect(mix, c, g.graph_out_node(), c)
    pkg = g.compile(SR, F)
    prog = ft.ScheduleProgram(pkg.schedule, dict(pkg.new_node_processors), SR, device="cpu")
    return ft.SessionServer(prog, CAPACITY, chunk_blocks=K, device="cpu", mesh=mesh), n
'''

PHASE_A = r'''
from common import *

srv, n = make_server(make_mesh({"dp": 2}, "cpu"))
assert srv._br.local_rows == slice(4 * rank, 4 * rank + 4)
ha = srv.connect(lambda: (n["vol"].set_percent_volume(100.0), n["sfx"].play()))
hb = srv.connect(lambda: n["vol"].set_percent_volume(37.0))
assert (ha.slot, hb.slot) == (0, 1)
srv.render(); srv.render()   # mid-stream; the 256-frame clip finishes
ev = srv.poll_events()
# slots 0 and 1 are rank 0's
if rank == 0:
    assert list(ev) == [ha] and all(e.name == "finished" for e in ev[ha]), ev
else:
    assert ev == {}, ev
srv.save_checkpoint(os.path.join(work, "fleet_ck"), extra_meta={"app": {"wave": 3}})
truth = [srv.render().numpy() for _ in range(2)]   # the uninterrupted fleet
np.savez(os.path.join(work, f"truth.rank{rank}.npz"), *truth)
torch.distributed.destroy_process_group()
'''

PHASE_B = r'''
from common import *

srv, n = make_server(make_mesh({"dp": 2}, "cpu"))   # fresh, idle fleet
handles = srv.restore_checkpoint(os.path.join(work, "fleet_ck"))
assert set(handles) == {0, 1} and srv.occupancy == 2 and srv.sample == 2 * K * F
assert srv._free == list(range(CAPACITY - 1, 1, -1)) and srv._gens[:3] == [1, 1, 0]
truth = np.load(os.path.join(work, f"truth.rank{rank}.npz"))
for c in range(2):
    assert np.array_equal(srv.render().numpy(), truth[f"arr_{c}"]), c
assert srv.poll_events() == {}   # nothing from before the kill
handles[0].update(lambda: n["sfx"].play())
srv.render(); srv.render()
ev = srv.poll_events()
if rank == 0:
    assert list(ev) == [handles[0]] and [(e.name, e.count) for e in ev[handles[0]]] == \
        [("finished", 1)], ev
else:
    assert ev == {}, ev
torch.distributed.destroy_process_group()
'''


def test_two_rank_session_server_kill_and_resume(tmp_path):
    work = str(tmp_path)
    (tmp_path / "common.py").write_text(COMMON)
    spawn_ranks(PHASE_A, 2, work)   # the fleet runs, saves, exits
    spawn_ranks(PHASE_B, 2, work)   # a fresh fleet resumes

    # the same checkpoint in one process: every slot, bit for bit
    ns: dict = {}
    exec(COMMON, ns)
    srv, _ = ns["make_server"]()
    handles = srv.restore_checkpoint(str(tmp_path / "fleet_ck"))
    assert set(handles) == {0, 1} and srv.sample == 2 * ns["K"] * ns["F"]
    truth = [np.load(tmp_path / f"truth.rank{r}.npz") for r in range(2)]
    for c in range(2):
        want = np.concatenate([t[f"arr_{c}"] for t in truth])
        np.testing.assert_array_equal(srv.render().numpy(), want)
    assert srv.poll_events() == {}
    assert ft.checkpoint.read_meta(str(tmp_path / "fleet_ck" / "params"))[
        "rank_offsets"] == [0, 4]
