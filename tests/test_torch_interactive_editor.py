"""The port's interactive editor (``firewheel_tpu_torch.examples.
interactive_graph``) over HTTP, as ``tests/test_interactive_editor.py``
drives the JAX package's: the example's real server on an ephemeral
localhost port, its engine on the CPU.  ``/state`` carries a finite meter
dB and stream stats that advance while the voices render; an added voice
grows the live graph by three nodes; the master FX insert, swap and
removal are three live topology edits.  The app is stopped once the
module's assertions have run.
"""

import json
import threading
import time
import urllib.request

import pytest

from firewheel_tpu_torch.examples import interactive_graph as ig


@pytest.fixture(scope="module")
def editor():
    app = ig.EngineApp(device="cpu")
    # ephemeral port: the OS picks, we read it back
    server = ig.ThreadingHTTPServer(("127.0.0.1", 0), ig.make_handler(app))
    port = server.server_address[1]
    st = threading.Thread(target=server.serve_forever, daemon=True)
    st.start()
    et = threading.Thread(target=app.run, kwargs={"duration_secs": 60.0})
    et.start()
    try:
        yield app, port
    finally:
        app.stop()
        et.join(timeout=30.0)
        server.shutdown()


def _get_state(port):
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}/state", timeout=5.0
    ) as r:
        return json.loads(r.read().decode())


def _post(port, path):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", method="POST", data=b""
    )
    with urllib.request.urlopen(req, timeout=5.0) as r:
        return r.read()


def _wait_for(predicate, port, timeout=90.0):
    # 90 s: under a full-suite run the editor's recompile-after-edit
    # contends with other workers
    deadline = time.monotonic() + timeout
    state = None
    while time.monotonic() < deadline:
        try:
            state = _get_state(port)
            if predicate(state):
                return state
        except (urllib.error.URLError, json.JSONDecodeError, OSError):
            pass
        time.sleep(0.1)
    return state


class TestEditorTelemetry:
    def test_meter_is_finite_while_streaming(self, editor):
        app, port = editor
        state = _wait_for(
            lambda s: s.get("meter_db") is not None
            and s.get("stream", {}).get("frames_rendered", 0) > 4096,
            port,
        )
        assert state is not None, "no /state response"
        assert state["stream"].get("frames_rendered", 0) > 4096, state
        md = state["meter_db"]
        assert md is not None, f"meter never published: {state.get('log')}"
        # two beeps at -15 dB through the mixer: a real signal level,
        # finite (JSON could not have carried inf/nan anyway) and sane
        for v in md:
            assert -100.0 <= float(v) <= 0.0

    def test_stats_advance(self, editor):
        app, port = editor
        s1 = _wait_for(
            lambda s: s.get("stream", {}).get("frames_rendered", 0) > 0, port
        )
        f1 = s1["stream"]["frames_rendered"]
        s2 = _wait_for(
            lambda s: s.get("stream", {}).get("frames_rendered", 0) > f1, port
        )
        assert s2["stream"]["frames_rendered"] > f1

    def test_add_voice_grows_live_graph(self, editor):
        app, port = editor
        before = _wait_for(lambda s: bool(s.get("nodes")), port)
        n0 = len(before["nodes"])
        _post(port, "/cmd?op=add_voice&freq=880")
        after = _wait_for(lambda s: len(s.get("nodes", [])) == n0 + 3, port)
        assert len(after["nodes"]) == n0 + 3, after.get("log")
        # the engine kept publishing a live meter through the edit
        state = _wait_for(lambda s: s.get("meter_db") is not None, port)
        assert state["meter_db"] is not None

    def test_master_fx_insert_swap_remove(self, editor):
        """The FX palette inserts/swaps/removes a master-bus effect on the
        RUNNING engine — three live topology edits through the HTTP API."""
        app, port = editor
        before = _wait_for(lambda s: bool(s.get("nodes")), port)
        n0 = len(before["nodes"])

        _post(port, "/cmd?op=set_fx&v=chorus")
        state = _wait_for(lambda s: s.get("fx") == "chorus", port)
        assert state["fx"] == "chorus", state.get("log")
        assert len(state["nodes"]) == n0 + 1
        assert any(n["name"] == "mod_delay" for n in state["nodes"])

        _post(port, "/cmd?op=set_fx&v=eq")  # swap chorus -> eq
        state = _wait_for(lambda s: s.get("fx") == "eq", port)
        assert state["fx"] == "eq", state.get("log")
        assert len(state["nodes"]) == n0 + 1
        assert any(n["name"] == "parametric_eq" for n in state["nodes"])

        _post(port, "/cmd?op=set_fx&v=none")
        state = _wait_for(lambda s: s.get("fx") == "none", port)
        assert state["fx"] == "none", state.get("log")
        assert len(state["nodes"]) == n0
        # the engine streamed through all three edits: meter still live
        state = _wait_for(lambda s: s.get("meter_db") is not None, port)
        assert state["meter_db"] is not None
