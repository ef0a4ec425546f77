"""The port's SessionServer (``firewheel_tpu_torch/serving.py``) over its
BatchRenderer, held against the JAX package's under the same operations.

Each case of ``tests/test_serving.py`` (but the mesh and adpcm4) runs as a
scenario on both packages from the same template graph (a tone through a
volume, and a one-shot SFX sampler, summed; idle: muted and paused) and
the same seeded clip; the scenario's outputs, slots and events are
compared, and the JAX test's own assertions are made on the port's.
Tolerance: 1e-6 abs on f32 output; pcm16 equal, or 1 LSB apart where the
f32 values round to either side (the count of such samples is asserted);
events equal.
"""

import numpy as np
import pytest
import torch

import firewheel_tpu as fw
from firewheel_tpu import nodes as jn
from firewheel_tpu.core.sample_resource import SampleResource as JaxResource
import firewheel_tpu_torch as ft
from firewheel_tpu_torch import nodes as tn
from firewheel_tpu_torch import serving

SR, F = 48000, 128
TOL = 1e-6
CLIP = (np.random.default_rng(5).standard_normal((2, 256)) * 0.1).astype(np.float32)
PACKAGES = ("jax", "port")


def make_template(pkg):
    """Template graph: tone → volume, plus a one-shot SFX sampler, both
    summed to the output.  Idle state: volume 0, sampler paused."""
    mod, nodes = (fw, jn) if pkg == "jax" else (ft, tn)
    g = mod.AudioGraph(mod.AudioGraphConfig(0, 2))
    tone = nodes.BeepTestNode(440.0, -12.0, True)
    vol = nodes.VolumeNode(0.0)
    sfx = nodes.SamplerNode(100.0)
    sfx.set_sample(JaxResource(CLIP, device=False) if pkg == "jax"
                   else ft.SampleResource(CLIP))
    tid = g.add_node(0, 2, tone)
    vid = g.add_node(2, 2, vol)
    sid = g.add_node(0, 2, sfx)
    mix = g.add_node(4, 2, nodes.SumNode())
    for ch in range(2):
        g.connect(tid, ch, vid, ch)
        g.connect(vid, ch, mix, ch)
        g.connect(sid, ch, mix, 2 + ch)
        g.connect(mix, ch, g.graph_out_node(), ch)
    pk = g.compile(SR, F)
    kw = {} if pkg == "jax" else {"device": "cpu"}
    prog = mod.ScheduleProgram(pk.schedule, dict(pk.new_node_processors), SR, **kw)
    return prog, {"tone": tone, "vol": vol, "sfx": sfx}


def make_server(pkg, capacity, **kw):
    prog, n = make_template(pkg)
    if pkg == "port":
        kw["device"] = "cpu"
    elif kw.get("lowering") == "hybrid":
        kw["hybrid_interpret"] = True
    mod = fw if pkg == "jax" else ft
    return mod.SessionServer(prog, capacity=capacity, **kw), n


def host(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def rms(x):
    return float(np.sqrt((np.asarray(x, np.float64) ** 2).mean()))


def events(ev: dict) -> list:
    """``poll_events()`` → sorted ``(slot, node, name, count, total, lane)``."""
    return sorted((h.slot, repr(e.node_id), e.name, e.count, e.total, e.lane)
                  for h, es in ev.items() for e in es)


def both(scenario, *args):
    """Run ``scenario(pkg, *args)`` on both packages → ``(jax, port)``."""
    return tuple(scenario(pkg, *args) for pkg in PACKAGES)


def assert_close(j, p, what=""):
    """Two scenario records: arrays within TOL (int16 within 1 LSB), the
    rest equal.  Returns the count of pcm16 samples 1 LSB apart."""
    off = 0
    if isinstance(j, dict):
        assert j.keys() == p.keys()
        return sum(assert_close(j[k], p[k], f"{what}/{k}") for k in j)
    if isinstance(j, (list, tuple)) and j and isinstance(j[0], np.ndarray):
        return sum(assert_close(a, b, f"{what}[{i}]") for i, (a, b) in
                   enumerate(zip(j, p, strict=True)))
    if isinstance(j, np.ndarray):
        assert j.shape == p.shape and j.dtype == p.dtype, what
        if j.dtype == np.int16:
            d = np.abs(j.astype(np.int32) - p.astype(np.int32))
            assert d.max(initial=0) <= 1, what
            off = int((d == 1).sum())
        else:
            np.testing.assert_allclose(p, j, atol=TOL, rtol=0, err_msg=what)
        return off
    assert j == p, what
    return off


def lifecycle(pkg):
    srv, n = make_server(pkg, 4, chunk_blocks=8)
    rec = {"occupancy0": srv.occupancy}
    h1 = srv.connect(lambda: n["vol"].set_percent_volume(100.0))
    h2 = srv.connect(lambda: n["vol"].set_percent_volume(0.0))
    rec["slots"] = (h1.slot, h2.slot, srv.occupancy)
    rec["first"] = [host(srv.render()) for _ in range(3)]
    h1.update(lambda: n["vol"].set_percent_volume(0.0))
    h2.update(lambda: n["vol"].set_percent_volume(100.0))
    rec["second"] = [host(srv.render()) for _ in range(8)]
    h3, h4 = srv.connect(), srv.connect()
    rec["full"] = srv.connect() is None
    h3.disconnect()
    h5 = srv.connect()
    rec["reuse"] = (h3.alive, h5.slot == h3.slot, srv.occupancy)
    rec["h"] = (h1.slot, h2.slot)
    return rec


def test_lifecycle_and_isolation():
    j, p = both(lifecycle)
    assert_close(j, p)
    s1, s2 = p["h"]
    out = p["first"][-1]
    assert rms(out[s1]) > 0.1 and rms(out[s2]) < 1e-6
    assert rms(out[2]) < 1e-6 and rms(out[3]) < 1e-6
    out = p["second"][-1]
    assert rms(out[s1]) < 1e-6 and rms(out[s2]) > 0.1
    assert p["full"] and p["reuse"] == (False, True, 4)


def event_reuse(pkg):
    srv, n = make_server(pkg, 2, chunk_blocks=8)
    h1 = srv.connect(lambda: n["sfx"].play())
    h2 = srv.connect(lambda: n["sfx"].pause())
    srv.render()  # 8 blocks = 1024 frames ≫ the 256-frame clip
    rec = {"ev1": events(srv.poll_events()), "h": (h1.slot, h2.slot)}
    h1.disconnect()
    h3 = srv.connect(lambda: n["sfx"].play())
    rec["reused"] = h3.slot == h1.slot
    srv.render()
    rec["ev2"] = events(srv.poll_events())
    return rec


def test_events_routed_per_session_and_isolated_across_reuse():
    j, p = both(event_reuse)
    assert_close(j, p)
    s1, s2 = p["h"]
    assert {e[0] for e in p["ev1"]} == {s1}
    assert all(e[2] == "finished" for e in p["ev1"])
    assert p["reused"]
    # the new tenant of s1 sees exactly its own event: fresh baseline
    (e,) = [e for e in p["ev2"] if e[2] == "finished"]
    assert e[0] == s1 and e[3:5] == (1, 1)


def pcm16(pkg):
    srv, n = make_server(pkg, 2, chunk_blocks=4, output_format="pcm16")
    h = srv.connect(lambda: n["vol"].set_percent_volume(100.0))
    return {"outs": [host(srv.render()) for _ in range(3)], "slot": h.slot}


def test_pcm16_output_format():
    """pcm16 within 1 LSB of JAX's (the f32 values agree to an ulp, and an
    ulp can cross a rounding boundary: at most a handful of samples)."""
    j, p = both(pcm16)
    off = assert_close(j, p)
    out = p["outs"][-1]
    assert out.dtype == np.int16 and out.shape == (2, 4, F, 2)
    assert np.abs(out[p["slot"]].astype(np.int32)).max() > 1000
    assert off <= 4, off


def hybrid_sessions(pkg):
    srv, n = make_server(pkg, 2, chunk_blocks=4, lowering="hybrid", tile=1)
    h = srv.connect(lambda: (n["vol"].set_percent_volume(100.0), n["sfx"].play()))
    outs = [host(srv.render()) for _ in range(2)]
    return {"outs": outs, "slot": h.slot, "ev": events(srv.poll_events())}


def test_sessions_and_events_on_hybrid_lowering():
    j, p = both(hybrid_sessions)
    assert_close(j, p)
    assert rms(p["outs"][-1][p["slot"]]) > 0.05
    assert any(e[0] == p["slot"] and e[2] == "finished" for e in p["ev"])


def hybrid_connect_between_chunks(pkg):
    """A session connected between two chunks on the hybrid lowering: its
    splice (written in place in the port) must reach the very next chunk."""
    srv, n = make_server(pkg, 2, chunk_blocks=4, lowering="hybrid", tile=1)
    first = host(srv.render())
    h = srv.connect(lambda: (n["vol"].set_percent_volume(100.0), n["sfx"].play()))
    return {"first": first, "next": host(srv.render()), "slot": h.slot}


def test_hybrid_connect_between_chunks_reaches_next_chunk():
    j, p = both(hybrid_connect_between_chunks)
    assert_close(j, p)
    assert np.abs(p["first"]).max() == 0.0
    assert rms(p["next"][p["slot"]]) > 0.01
    assert np.abs(p["next"][1 - p["slot"]]).max() == 0.0


def test_connect_rejects_scheduled_commands_and_keeps_slot():
    """at_sample= commands need the streaming processor's timelines: both
    packages refuse them, clear them and keep the slot; a raising
    configure() leaks no slot."""
    for pkg in PACKAGES:
        srv, n = make_server(pkg, 2, chunk_blocks=4)
        for cmd in (lambda: n["sfx"].play(at_sample=480),
                    lambda: n["vol"].set_percent_volume(50.0, at_sample=480)):
            with pytest.raises(ValueError, match="at_sample"):
                srv.connect(cmd)
            assert srv.occupancy == 0
        assert n["sfx"]._scheduled == [] and n["vol"]._scheduled == []

        def boom():
            raise RuntimeError("game-side bug")

        with pytest.raises(RuntimeError):
            srv.connect(boom)
        assert srv.occupancy == 0
        assert srv.connect() is not None and srv.connect() is not None
        assert srv.connect() is None


def fuzz(pkg, seed):
    rng = np.random.default_rng(seed)
    srv, n = make_server(pkg, 4, chunk_blocks=4)
    live, steps = [], []

    def op_connect():
        h = srv.connect(lambda: (
            n["vol"].set_percent_volume(float(rng.choice([0.0, 50.0, 100.0]))),
            n["sfx"].play() if rng.integers(2) else n["sfx"].pause(),
        ))
        if h is not None:
            live.append(h)

    def op_disconnect():
        if live:
            live.pop(int(rng.integers(len(live)))).disconnect()

    def op_update():
        if live:
            h = live[int(rng.integers(len(live)))]
            h.update(lambda: n["vol"].set_percent_volume(
                float(rng.choice([0.0, 100.0]))))

    def op_reset():
        if live:
            live[int(rng.integers(len(live)))].reset()

    ops = [op_connect, op_connect, op_disconnect, op_update, op_reset]
    for _ in range(30):
        ops[int(rng.integers(len(ops)))]()
        out = host(srv.render())
        ev = srv.poll_events()
        assert all(h.alive for h in ev)  # events only for live sessions
        assert srv.occupancy == len(live)
        assert np.isfinite(out).all()
        steps.append((out, events(ev), sorted(h.slot for h in live)))
    assert all(h.alive for h in live)
    return {"outs": [s[0] for s in steps], "events": [s[1] for s in steps],
            "live": [s[2] for s in steps]}


@pytest.mark.parametrize("seed", [0, 1])
def test_random_session_lifecycle_fuzz(seed):
    j, p = both(fuzz, seed)
    assert_close(j, p)
    dead = set(range(4)) - set(p["live"][-1])
    for b in dead:  # vacant slots render the idle (muted) template
        assert np.abs(p["outs"][-1][b]).max() < 1e-6


def partial_configure(pkg):
    srv, n = make_server(pkg, 2, chunk_blocks=8)
    ha = srv.connect(lambda: n["vol"].set_percent_volume(100.0))
    # B touches only the sampler: it must NOT inherit A's volume
    hb = srv.connect(lambda: n["sfx"].pause())
    outs = [host(srv.render()) for _ in range(8)]
    return {"outs": outs, "h": (ha.slot, hb.slot)}


def test_partial_configure_starts_from_idle_not_previous_tenant():
    j, p = both(partial_configure)
    assert_close(j, p)
    sa, sb = p["h"]
    assert rms(p["outs"][-1][sa]) > 0.1 and rms(p["outs"][-1][sb]) < 1e-6


def partial_update(pkg):
    srv, n = make_server(pkg, 1, chunk_blocks=8)
    h = srv.connect(lambda: n["vol"].set_percent_volume(100.0))
    h.update(lambda: n["sfx"].play())  # touches only the sampler
    return {"outs": [host(srv.render()) for _ in range(8)], "slot": h.slot}


def test_partial_update_composes_with_own_session_state():
    j, p = both(partial_update)
    assert_close(j, p)
    assert rms(p["outs"][-1][p["slot"]]) > 0.1  # the tone is still audible


def test_template_rests_idle_between_server_calls():
    for pkg in PACKAGES:
        srv, n = make_server(pkg, 2, chunk_blocks=8)
        srv.connect(lambda: n["vol"].set_percent_volume(100.0))
        assert n["vol"].percent_volume() == 0.0  # idle template value


def raising_configure(pkg):
    srv, n = make_server(pkg, 2, chunk_blocks=8)

    def bad():
        n["vol"].set_percent_volume(100.0)
        raise RuntimeError("client error")

    with pytest.raises(RuntimeError, match="client error"):
        srv.connect(bad)
    rec = {"occ": srv.occupancy, "vol": n["vol"].percent_volume()}
    h = srv.connect(lambda: n["sfx"].pause())
    rec["outs"] = [host(srv.render()) for _ in range(4)]
    rec["slot"] = h.slot
    return rec


def test_raising_configure_leaves_template_idle():
    j, p = both(raising_configure)
    assert_close(j, p)
    assert p["occ"] == 0 and p["vol"] == 0.0
    assert rms(p["outs"][-1][p["slot"]]) < 1e-6


def test_snapshots_keep_shared_objects_by_reference():
    """A node that keeps SampleResources, an ndarray and a tensor inside
    its containers keeps the very same objects in every session's control
    snapshot and on the template: no per-session copy is made, while the
    containers themselves are copied."""
    prog, n = make_template("port")
    sfx = n["sfx"]
    bank = [ft.SampleResource(CLIP), ft.SampleResource(CLIP[::-1].copy())]
    table = {"gains": np.ones(4, np.float32), "curve": torch.zeros(3)}
    sfx.bank, sfx.table = bank, table
    srv = ft.SessionServer(prog, capacity=3, chunk_blocks=2, device="cpu")
    hs = [srv.connect(lambda i=i: sfx.set_sample(sfx.bank[i % 2])) for i in range(3)]
    idx = srv._nodes.index(sfx)
    for h in hs:
        ctrl = srv._slot_ctrl[h.slot][idx]
        assert ctrl["bank"] is not bank and ctrl["table"] is not table
        assert all(a is b for a, b in zip(ctrl["bank"], bank))
        assert ctrl["table"]["gains"] is table["gains"]
        assert ctrl["table"]["curve"] is table["curve"]
        assert ctrl["_sample"] is bank[h.slot % 2]
    assert sfx.bank[0] is bank[0] and sfx.table["curve"] is table["curve"]
    assert sfx._sample is srv._idle_ctrl[idx]["_sample"]
    # the snapshot of a nested container is still a copy
    ctrl = serving._snap_dict({"x": [[1], bank[0]]})
    assert ctrl["x"][1] is bank[0]


def stream_chunks(pkg):
    prog, n = make_template(pkg)
    n["vol"].set_percent_volume(100.0)
    kw = {} if pkg == "jax" else {"device": "cpu"}
    mod = fw.parallel if pkg == "jax" else ft

    def renderer():
        return mod.BatchRenderer(prog, batch=3, output_format="pcm16", **kw)

    br = renderer()
    params, state, seq, s = br.stack_params(), br.init_state(), [], 0
    for _ in range(4):
        out, _om, state = br.render_chunk(params, state, start_sample=s, num_blocks=4)
        seq.append(host(out))
        s += 4 * F
    br = renderer()
    streamed, _, end = br.render_stream(br.stack_params(), br.init_state(),
                                        num_chunks=4, num_blocks=4)
    assert end == 4 * 4 * F
    got, views = [], []

    def on_chunk(x):
        got.append(np.array(x))
        views.append(x)

    br = renderer()
    ret, _, _ = br.render_stream(br.stack_params(), br.init_state(), num_chunks=4,
                                 num_blocks=4, on_chunk=on_chunk)
    assert ret is None
    return {"seq": seq, "streamed": streamed, "callback": got}, views


def test_render_stream_matches_sequential_chunks():
    """render_stream (the overlapped render→fetch loop) delivers exactly the
    chunks a sequential render_chunk loop produces, on either package; the
    port's callback gets a view of one of two egress buffers (valid until
    it returns, refilled two chunks later), its collected list owns its
    arrays."""
    (j, _), (p, views) = both(stream_chunks)
    for rec in (j, p):
        for key in ("streamed", "callback"):
            assert len(rec[key]) == 4
            for x, y in zip(rec["seq"], rec[key]):
                assert x.dtype == np.int16 and x.shape == (3, 4, F, 2)
                np.testing.assert_array_equal(x, y)
    assert_close(j, p)
    assert np.shares_memory(views[0], views[2]) and np.shares_memory(views[1], views[3])
    assert not np.shares_memory(views[0], views[1])
    assert not np.array_equal(views[0], p["seq"][0])  # refilled by chunk 2
    s = p["streamed"]
    assert not any(np.shares_memory(s[a], s[b]) for a in range(4) for b in range(a))


def fetched(pkg):
    def build():
        srv, n = make_server(pkg, 2, chunk_blocks=4)
        srv.connect(lambda: n["vol"].set_percent_volume(100.0))
        return srv

    ref = build()
    want = [host(ref.render()) for _ in range(3)]
    srv = build()
    rec = {"primed": srv.render_fetched() is None}
    got = [srv.render_fetched() for _ in range(2)]
    got.append(srv.flush())
    rec["drained"] = srv.flush() is None
    rec["want"], rec["got"] = want, got
    return rec


def test_render_fetched_is_one_chunk_delayed_render():
    """render_fetched ships chunk t-1 while chunk t renders, as an array the
    caller owns; flush() drains the last chunk in flight."""
    j, p = both(fetched)
    assert_close(j, p)
    assert p["primed"] and p["drained"]
    for w, g in zip(p["want"], p["got"]):
        np.testing.assert_array_equal(w, g)
    assert not np.shares_memory(p["got"][0], p["got"][2])


def fleet_checkpoint(pkg, tmp_path, restore_pkg):
    """Save a fleet mid-stream with ``pkg``'s server; restore it into a
    fresh ``restore_pkg`` server; both continue two chunks."""
    srv, n = make_server(pkg, 4, chunk_blocks=4)
    ha = srv.connect(lambda: (n["vol"].set_percent_volume(100.0), n["sfx"].play()))
    hb = srv.connect(lambda: n["vol"].set_percent_volume(37.0))
    srv.render()
    srv.render()
    rec = {"ev": events(srv.poll_events())}
    ck = str(tmp_path / f"fleet-{pkg}")
    srv.save_checkpoint(ck, extra_meta={"app": {"tick": 42}})
    rec["truth"] = [host(srv.render()) for _ in range(2)]
    srv2, n2 = make_server(restore_pkg, 4, chunk_blocks=4)
    handles = srv2.restore_checkpoint(ck)
    rec["slots"] = (sorted(handles), srv2.occupancy, srv2.sample, ha.slot, hb.slot)
    rec["resumed"] = [host(srv2.render()) for _ in range(2)]
    rec["ev_after"] = events(srv2.poll_events())
    handles[ha.slot].update(lambda: n2["sfx"].play())
    srv2.render()
    rec["ev_new"] = events(srv2.poll_events())
    return rec


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("jax", "port"),
                                           ("port", "jax")])
def test_fleet_checkpoint_restores_sessions_bit_exact(tmp_path, writer, reader):
    """A fleet saved mid-stream resumes in a fresh server: params, state and
    slots; bit-exact within a package, and across the packages (the JAX
    package's files in the port, the port's in the JAX package) as the
    packages agree; no event replayed, events flow afterwards."""
    rec = fleet_checkpoint(writer, tmp_path, reader)
    ref = fleet_checkpoint(reader, tmp_path, reader)
    assert_close(ref, rec)
    sa, sb = rec["slots"][3:]
    assert any(e[0] == sa for e in rec["ev"])  # the clip finished pre-save
    assert rec["slots"][:3] == ([sa, sb], 2, 2 * 4 * F)
    for t, g in zip(rec["truth"], rec["resumed"]):
        if writer == reader:
            np.testing.assert_array_equal(t, g)
        else:
            np.testing.assert_allclose(g, t, atol=TOL, rtol=0)
    assert rec["ev_after"] == []
    assert any(e[0] == sa and e[2] == "finished" for e in rec["ev_new"])


def test_restore_rejects_capacity_mismatch(tmp_path):
    srv, _ = make_server("port", 4, chunk_blocks=4)
    srv.render()
    ck = str(tmp_path / "fleet")
    srv.save_checkpoint(ck)
    srv8, _ = make_server("port", 8, chunk_blocks=4)
    with pytest.raises(ValueError, match="batch mismatch|capacity"):
        srv8.restore_checkpoint(ck)
