"""Interactive visual node graph: a live browser editor driving a running
engine on the card.

The editor is a local web page served by this module:

* dragging a volume/pan/frequency slider POSTs to the engine and the
  running stream ramps live (``set_percent_volume``);
* "add voice" / "remove" buttons edit the topology of the RUNNING engine:
  each edit recompiles the schedule and hot-swaps it with state migration;
* the master-bus FX palette (``mixer.FX_KINDS``: EQ, chorus, flanger,
  tremolo, waveshaper, gate) inserts, swaps and removes an effect between
  the clip and the meter (``mixer.set_fx``), another live topology edit;
* connecting an edge that would form a cycle is rejected
  (``CycleDetected``);
* the page polls ``/state`` for the live graph (SVG), a dB meter, the
  stream's stats and the log.

The engine's graph is ``mixer.add_fx_engine``'s (two voices → sum → clip →
meter).  Threading: all device work stays on the engine thread; HTTP
handlers only enqueue commands and read a snapshot dict.

Run:  python -m firewheel_tpu_torch.examples.interactive_graph [port [secs]]
      (Ctrl-C to stop)
"""

from __future__ import annotations

import json
import queue
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from ..backend import ArraySink, FirewheelCtx, StreamConfig
from ..device import DEFAULT_DEVICE
from ..graph import CycleDetected
from ..mixer import FX_KINDS, FX_VOICES, add_fx_engine, add_fx_voice, set_fx
from ..nodes import DbMeterNode

SR = 48000
MAX_VOICES = len(FX_VOICES)


class EngineApp:
    """Owns the engine and all device work; applies queued edits between
    ``update()`` pumps and publishes a JSON-able snapshot for the page."""

    def __init__(self, device=DEFAULT_DEVICE):
        self.cx = FirewheelCtx(device=device)
        self.cmds: "queue.Queue[tuple]" = queue.Queue()
        self.snapshot: dict = {}
        self._lock = threading.Lock()
        self._stop = False
        self.sink = ArraySink()
        self.log: list[str] = []
        self.ids = add_fx_engine(self.cx.graph_mut())
        self.mixer, self.clip, self.meter = (self.ids[k] for k in ("sum", "clip", "meter"))
        self.voices: list[dict] = [
            {"beep": beep, "vol": vol, "pan": pan, "freq": freq}
            for (beep, vol, pan), freq in zip(self.ids["voices"], FX_VOICES)]

    @property
    def fx(self):
        """The master-bus insert as ``(kind, node id)``, or None."""
        return self.ids["fx"]

    # -- topology edits (engine thread only) -----------------------------------
    def _add_voice(self, freq: float):
        if len(self.voices) >= MAX_VOICES:
            self._log("voice limit reached")
            return
        slot = len(self.voices)
        beep, vol, pan = add_fx_voice(self.cx.graph_mut(), self.mixer, slot, freq)
        self.voices.append({"beep": beep, "vol": vol, "pan": pan, "freq": freq})
        self._log(f"added voice {slot} ({freq:.0f} Hz) — schedule recompiles")

    def _set_fx(self, kind: str):
        kind = kind if kind in FX_KINDS else None
        set_fx(self.cx.graph_mut(), self.ids, kind)
        self._log(f"master FX -> {kind} — schedule recompiles" if kind
                  else "master FX removed — schedule recompiles")

    def _remove_voice(self):
        if not self.voices:
            return
        g = self.cx.graph_mut()
        v = self.voices.pop()
        for nid in (v["beep"], v["vol"], v["pan"]):
            g.remove_node(nid)
        self._log("removed last voice — schedule recompiles")

    def _log(self, msg):
        self.log.append(f"[{time.strftime('%H:%M:%S')}] {msg}")
        del self.log[:-12]

    # -- command application ----------------------------------------------------
    def _apply(self, cmd):
        g = self.cx.graph_mut()
        kind = cmd[0]
        try:
            if kind == "volume":
                _, i, pct = cmd
                g.node(self.voices[i]["vol"]).set_percent_volume(float(pct))
            elif kind == "pan":
                _, i, p = cmd
                g.node(self.voices[i]["pan"]).set_pan(float(p))
            elif kind == "freq":
                _, i, hz = cmd
                g.node(self.voices[i]["beep"]).set_frequency(float(hz))
                self.voices[i]["freq"] = float(hz)
            elif kind == "enable":
                _, i, on = cmd
                g.node(self.voices[i]["beep"]).set_enabled(bool(on))
            elif kind == "add_voice":
                self._add_voice(float(cmd[1]))
            elif kind == "set_fx":
                self._set_fx(cmd[1])
            elif kind == "remove_voice":
                self._remove_voice()
            elif kind == "try_cycle":
                # wire the clip output back into the mixer: must be rejected.
                # Target the next FREE voice slot so the demo exercises the
                # cycle check, not InputPortAlreadyConnected (voices occupy
                # ports 0..2*len(voices)-1).
                if len(self.voices) >= MAX_VOICES:
                    self._log("mixer ports full — remove a voice, then try")
                else:
                    try:
                        g.connect(self.clip, 0, self.mixer,
                                  2 * len(self.voices),
                                  check_for_cycles=True)
                        self._log("BUG: cycle was accepted")
                    except CycleDetected:
                        self._log("cycle attempt rejected (CycleDetected), "
                                  "graph untouched")
        except Exception as e:  # editor robustness: report, don't die
            self._log(f"edit failed: {type(e).__name__}: {e}")

    # -- snapshot for the page ---------------------------------------------------
    def _publish(self):
        g = self.cx.graph
        nodes = []
        for e in g.nodes():
            nodes.append({
                "key": repr(e.id),
                "name": e.id.debug_name,
                "inputs": e.num_inputs,
                "outputs": e.num_outputs,
            })
        edges = [
            {
                "src": repr(ed.src_node), "sp": ed.src_port,
                "dst": repr(ed.dst_node), "dp": ed.dst_port,
            }
            for ed in g.edges()
        ]
        # node events (core/events.py): surface them in the page log — the
        # master-bus HardClip reports "clipped" when the mix runs hot
        try:
            for ev in self.cx.poll_events():
                self._log(
                    f"event {ev.name}: {ev.node_id} +{ev.count} "
                    f"(total {ev.total})"
                )
        except Exception as e:
            self._log(f"event poll failed: {type(e).__name__}: {e}")
        meter_db = None
        try:
            st = self.cx.node_state(self.meter)
            if st is not None:
                # clamp at the meter's -100 dB floor: -inf (pure silence)
                # is not valid JSON and would break the page's JSON.parse
                meter_db = [round(max(float(x), -100.0), 1)
                            for x in DbMeterNode.read(st)["rms_db"]]
        except Exception as e:  # surface readback failures in the page log
            self._log(f"meter readback failed: {type(e).__name__}: {e}")
        stream = self.cx.stream
        stats = {}
        if stream is not None:
            stats = {
                "frames_rendered": int(stream.frames_rendered),
                "seconds": round(stream.frames_rendered / SR, 2),
            }
        voices = [
            {
                "i": i,
                "freq": v["freq"],
                "volume": self.cx.graph.node(v["vol"]).percent_volume(),
                "pan": self.cx.graph.node(v["pan"]).pan(),
                "enabled": self.cx.graph.node(v["beep"]).enabled(),
            }
            for i, v in enumerate(self.voices)
        ]
        snap = {
            "nodes": nodes, "edges": edges, "voices": voices,
            "meter_db": meter_db, "stream": stats, "log": list(self.log),
            "fx": self.fx[0] if self.fx else "none",
        }
        with self._lock:
            self.snapshot = snap

    def get_snapshot(self):
        with self._lock:
            return dict(self.snapshot)

    # -- the engine loop ----------------------------------------------------------
    def run(self, duration_secs: float | None = None):
        self.cx.activate(
            StreamConfig(SR, 2, buffer_frames=512, realtime=True),
            sink=self.sink,
        )
        self._log("engine activated (512-frame buffers, realtime pacing)")
        self._publish()
        t_end = None if duration_secs is None else time.time() + duration_secs
        last_pub = 0.0
        try:
            while not self._stop and (t_end is None or time.time() < t_end):
                try:
                    while True:
                        self._apply(self.cmds.get_nowait())
                except queue.Empty:
                    pass
                res = self.cx.update()
                if res.status.name == "DEACTIVATED":
                    # a stream error deactivated the engine (the reference's
                    # fault-tolerance story, lib.rs README:24): say so on
                    # the page and re-activate on the next loop — without
                    # this the editor keeps serving stale snapshots with a
                    # null meter and empty stats while looking alive
                    self._log(f"stream deactivated ({res.error}); "
                              "re-activating")
                    try:
                        self.cx.activate(
                            StreamConfig(SR, 2, buffer_frames=512,
                                         realtime=True),
                            sink=self.sink,
                        )
                        self._log("engine re-activated")
                    except Exception as e:
                        self._log(f"re-activation failed: "
                                  f"{type(e).__name__}: {e}")
                        time.sleep(0.5)
                now = time.time()
                if now - last_pub > 0.10:
                    self._publish()
                    last_pub = now
                time.sleep(0.005)
        finally:
            self.cx.deactivate()

    def stop(self):
        self._stop = True


PAGE = """<!DOCTYPE html>
<html><head><title>firewheel_tpu_torch — interactive node graph</title>
<style>
 body{font-family:system-ui,sans-serif;margin:1.2em;background:#14161a;color:#e8e8e8}
 h1{font-size:1.2em} .row{display:flex;gap:2em;flex-wrap:wrap}
 .voice{border:1px solid #333;border-radius:8px;padding:.7em;margin:.4em 0;background:#1d2026}
 .voice b{color:#7ecbff} input[type=range]{width:180px;vertical-align:middle}
 button{background:#2d6cdf;color:#fff;border:0;border-radius:6px;padding:.45em .9em;margin:.2em;cursor:pointer}
 button.warn{background:#b3452f}
 svg{background:#0e0f12;border-radius:8px}
 .meter{font-family:monospace;font-size:1.05em;color:#9f9}
 #log{font-family:monospace;font-size:.8em;color:#aaa;white-space:pre-wrap}
 .lbl{display:inline-block;width:3.6em;font-size:.85em;color:#999}
</style></head><body>
<h1>firewheel_tpu_torch — interactive node graph (live engine)</h1>
<div class="row">
<div style="min-width:430px">
  <div>
    <button onclick="post('/cmd?op=add_voice&freq='+(220+Math.round(Math.random()*660)))">add voice</button>
    <button class="warn" onclick="post('/cmd?op=remove_voice')">remove last voice</button>
    <button onclick="post('/cmd?op=try_cycle')">try to create a cycle</button>
  </div>
  <div>
    <span class="lbl">FX</span>
    <select id="fx" onchange="post('/cmd?op=set_fx&v='+this.value)">
      <option value="none">none</option><option value="eq">eq</option>
      <option value="chorus">chorus</option><option value="flanger">flanger</option>
      <option value="tremolo">tremolo</option><option value="waveshaper">waveshaper</option>
      <option value="gate">gate</option>
    </select>
  </div>
  <div id="voices"></div>
  <div class="meter" id="meter"></div>
  <div id="stream"></div>
  <div id="log"></div>
</div>
<div><svg id="graph" width="560" height="520"></svg></div>
</div>
<script>
async function post(u){await fetch(u,{method:'POST'});refresh()}
function slider(i,k,min,max,step,val){
 return `<span class="lbl">${k}</span><input type=range min=${min} max=${max} step=${step} value=${val}
   oninput="post('/cmd?op=${k}&i=${i}&v='+this.value)">`}
async function refresh(){
 const s=await (await fetch('/state')).json();
 document.getElementById('voices').innerHTML=s.voices.map(v=>
  `<div class=voice><b>voice ${v.i}</b> ${v.freq.toFixed(0)} Hz
   <label><input type=checkbox ${v.enabled?'checked':''}
     onchange="post('/cmd?op=enable&i=${v.i}&v='+(this.checked?1:0))">on</label><br>
   ${slider(v.i,'volume',0,100,1,v.volume)}<br>
   ${slider(v.i,'pan',-1,1,0.01,v.pan)}<br>
   ${slider(v.i,'freq',55,1760,1,v.freq)}</div>`).join('');
 document.getElementById('meter').textContent=
   s.meter_db?('meter  L '+s.meter_db[0]+' dB   R '+s.meter_db[1]+' dB'):'meter --';
 document.getElementById('stream').textContent=
   'rendered '+ (s.stream.seconds||0) +' s ('+(s.stream.frames_rendered||0)+' frames)';
 document.getElementById('log').textContent=(s.log||[]).join('\\n');
 const fxSel=document.getElementById('fx');
 if(document.activeElement!==fxSel)fxSel.value=s.fx||'none';
 drawGraph(s);
}
function drawGraph(s){
 const svg=document.getElementById('graph');
 // layered layout: simple BFS depth from graph_in/source nodes
 const idx={},depth={},children={};
 s.nodes.forEach(n=>{idx[n.key]=n;depth[n.key]=0});
 for(let pass=0;pass<12;pass++)
   s.edges.forEach(e=>{depth[e.dst]=Math.max(depth[e.dst],(depth[e.src]||0)+1)});
 const layers={};
 s.nodes.forEach(n=>{(layers[depth[n.key]]=layers[depth[n.key]]||[]).push(n)});
 const pos={};const W=560,LH=64;
 Object.keys(layers).sort((a,b)=>a-b).forEach((d,li)=>{
   layers[d].forEach((n,i)=>{pos[n.key]=[40+(i+0.5)*(W-60)/layers[d].length,40+li*LH]});
 });
 let out='';
 s.edges.forEach(e=>{const a=pos[e.src],b=pos[e.dst];if(!a||!b)return;
   out+=`<path d="M${a[0]},${a[1]+12} C${a[0]},${a[1]+40} ${b[0]},${b[1]-40} ${b[0]},${b[1]-12}"
     stroke="#4a90d9" fill="none" stroke-width="1.5"/>`});
 s.nodes.forEach(n=>{const p=pos[n.key];if(!p)return;
   out+=`<rect x=${p[0]-44} y=${p[1]-13} width=88 height=26 rx=6 fill="#262b33" stroke="#555"/>
   <text x=${p[0]} y=${p[1]+4} text-anchor=middle font-size=11 fill="#ddd">${n.name}</text>`});
 svg.innerHTML=out;
}
setInterval(refresh,500);refresh();
</script></body></html>"""


def make_handler(app: EngineApp):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, body, ctype="text/html"):
            data = body.encode() if isinstance(body, str) else body
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            u = urlparse(self.path)
            if u.path == "/":
                self._send(PAGE)
            elif u.path == "/state":
                self._send(json.dumps(app.get_snapshot()), "application/json")
            else:
                self.send_error(404)

        def do_POST(self):
            u = urlparse(self.path)
            q = parse_qs(u.query)
            if u.path == "/cmd":
                op = q.get("op", [""])[0]
                i = int(q.get("i", ["0"])[0])
                v = q.get("v", ["0"])[0]
                if op in ("volume", "pan", "freq"):
                    app.cmds.put((op, i, float(v)))
                elif op == "enable":
                    app.cmds.put((op, i, v not in ("0", "false")))
                elif op == "add_voice":
                    app.cmds.put(("add_voice", float(q.get("freq", ["440"])[0])))
                elif op == "set_fx":
                    app.cmds.put(("set_fx", v))
                elif op in ("remove_voice", "try_cycle"):
                    app.cmds.put((op,))
                self._send("ok", "text/plain")
            else:
                self.send_error(404)

    return Handler


def main(port: int = 8787, duration_secs: float | None = None,
         device=DEFAULT_DEVICE):
    app = EngineApp(device)
    server = ThreadingHTTPServer(("127.0.0.1", port), make_handler(app))
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    print(f"interactive editor at http://127.0.0.1:{port}/  (Ctrl-C to stop)")
    try:
        app.run(duration_secs)
    except KeyboardInterrupt:
        pass
    finally:
        app.stop()
        server.shutdown()
        audio = app.sink.audio(2)
        print(f"rendered {audio.shape[1] / SR:.1f}s of audio during the session")


if __name__ == "__main__":
    port = int(sys.argv[1]) if len(sys.argv) > 1 else 8787
    dur = float(sys.argv[2]) if len(sys.argv) > 2 else None
    main(port, dur)
