"""Graph and schedule visualization: ASCII, DOT, and self-contained HTML.

A copy of ``firewheel_tpu/utils/viz.py`` (it needs only the standard
library): the same strings for the same graph and schedule objects, the
HTML page's default title included.

The reference ships an interactive egui DAG editor example
(``examples/visual_node_graph``) and rich schedule Debug dumps
(``schedule.rs:32-101``; generation counters kept "for debugging and
visualization", schedule.rs:112-114).  This module provides the equivalents
for a headless host: terminal ASCII rendering, Graphviz DOT export, and
a dependency-free interactive HTML page (SVG + vanilla JS) for notebooks or
browsers.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["ascii_graph", "to_dot", "to_html", "schedule_table"]


def _topo_layers(graph):
    """Group nodes into topological layers for layout."""
    entries = {e.id: e for e in graph.nodes()}
    indeg = {nid: 0 for nid in entries}
    edges = list(graph.edges())
    for e in edges:
        indeg[e.dst_node] += 1
    layers = []
    frontier = [nid for nid, d in indeg.items() if d == 0]
    seen = set()
    while frontier:
        layers.append(sorted(frontier, key=lambda n: n.idx.slot))
        emitted = set(frontier)
        seen.update(emitted)
        nxt = {}
        # decrement only through the just-emitted layer's edges: counting
        # earlier layers again would promote consumers level with (or
        # before) their producers
        for e in edges:
            if e.src_node in emitted and e.dst_node not in seen:
                indeg[e.dst_node] -= 1
                if indeg[e.dst_node] == 0:
                    nxt[e.dst_node] = True
        frontier = list(nxt)
    rest = [nid for nid in entries if nid not in seen]
    if rest:
        layers.append(sorted(rest, key=lambda n: n.idx.slot))
    return layers, entries, edges


def ascii_graph(graph) -> str:
    """Render the DAG as layered ASCII art."""
    layers, entries, edges = _topo_layers(graph)
    lines = []
    for depth, layer in enumerate(layers):
        boxes = []
        for nid in layer:
            e = entries[nid]
            boxes.append(f"[{nid!r} {e.num_inputs}->{e.num_outputs}]")
        lines.append(("  " * depth) + "  ".join(boxes))
        outgoing = [
            f"{e.src_node!r}:{e.src_port} --> {e.dst_node!r}:{e.dst_port}"
            for e in edges
            if e.src_node in layer
        ]
        for o in outgoing:
            lines.append(("  " * depth) + "  | " + o)
    return "\n".join(lines)


def to_dot(graph, schedule=None) -> str:
    """Graphviz DOT export (buffer indices on edges when a schedule is
    given)."""
    buf_of_edge = {}
    if schedule is not None:
        by_id = {sn.id: sn for sn in schedule.schedule}
        for e in graph.edges():
            src = by_id.get(e.src_node)
            if src is not None and e.src_port < len(src.output_buffers):
                buf_of_edge[e.id] = src.output_buffers[e.src_port].buffer_index

    out = ["digraph firewheel {", "  rankdir=LR;", "  node [shape=record];"]
    for entry in graph.nodes():
        nid = entry.id
        ins = "|".join(f"<i{i}> {i}" for i in range(entry.num_inputs))
        outs = "|".join(f"<o{i}> {i}" for i in range(entry.num_outputs))
        label = f"{{ {{{ins}}} | {nid!r} | {{{outs}}} }}"
        out.append(f'  "n{nid.idx.slot}" [label="{label}"];')
    for e in graph.edges():
        attr = ""
        if e.id in buf_of_edge:
            attr = f' [label="b{buf_of_edge[e.id]}"]'
        out.append(
            f'  "n{e.src_node.idx.slot}":o{e.src_port} -> '
            f'"n{e.dst_node.idx.slot}":i{e.dst_port}{attr};'
        )
    out.append("}")
    return "\n".join(out)


def schedule_table(schedule) -> str:
    """Flat text table of the compiled schedule (order, buffers, clears)."""
    rows = [
        f"{'#':>3}  {'node':<28} {'in bufs':<18} {'out bufs':<18} {'clears'}"
    ]
    for i, sn in enumerate(schedule.schedule):
        ins = ",".join(str(b.buffer_index) for b in sn.input_buffers) or "-"
        outs = ",".join(str(b.buffer_index) for b in sn.output_buffers) or "-"
        clears = (
            ",".join("y" if b.should_clear else "n" for b in sn.input_buffers)
            or "-"
        )
        rows.append(f"{i:>3}  {sn.id!r:<28} {ins:<18} {outs:<18} {clears}")
    rows.append(
        f"buffers: {schedule.num_buffers} × {schedule.max_block_frames} frames"
    )
    return "\n".join(rows)


def to_html(graph, schedule=None, title: str = "firewheel_tpu graph") -> str:
    """Self-contained interactive HTML view: draggable SVG nodes, edge
    routing, and the schedule table."""
    layers, entries, edges = _topo_layers(graph)
    positions = {}
    for x, layer in enumerate(layers):
        for y, nid in enumerate(layer):
            positions[nid] = (60 + x * 220, 60 + y * 110)

    node_js = []
    for nid, (x, y) in positions.items():
        e = entries[nid]
        node_js.append(
            {
                "id": f"n{nid.idx.slot}",
                "label": repr(nid),
                "x": x,
                "y": y,
                "nin": e.num_inputs,
                "nout": e.num_outputs,
            }
        )
    edge_js = [
        {
            "src": f"n{e.src_node.idx.slot}",
            "sp": e.src_port,
            "dst": f"n{e.dst_node.idx.slot}",
            "dp": e.dst_port,
        }
        for e in edges
    ]
    table = schedule_table(schedule) if schedule is not None else ""

    import json as _json

    return f"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
 body {{ font-family: monospace; background: #1b1b22; color: #ddd; }}
 svg {{ background: #232330; border-radius: 8px; }}
 .node rect {{ fill: #3a3a55; stroke: #8888cc; rx: 6; cursor: grab; }}
 .node text {{ fill: #eee; font-size: 11px; pointer-events: none; }}
 .port {{ fill: #cc8; }}
 .edge {{ stroke: #9c9; stroke-width: 1.5; fill: none; }}
 pre {{ background: #232330; padding: 12px; border-radius: 8px; }}
</style></head><body>
<h2>{title}</h2>
<svg id="g" width="1200" height="640"></svg>
<pre>{table}</pre>
<script>
const nodes = {_json.dumps(node_js)};
const edges = {_json.dumps(edge_js)};
const svg = document.getElementById('g');
const NS = 'http://www.w3.org/2000/svg';
const byId = {{}};
function portY(n, i, total) {{ return n.y + 14 + (total > 1 ? i * 18 : 14); }}
function draw() {{
  svg.innerHTML = '';
  for (const e of edges) {{
    const a = byId[e.src] || nodes.find(n => n.id === e.src);
    const b = byId[e.dst] || nodes.find(n => n.id === e.dst);
    const x1 = a.x + 170, y1 = portY(a, e.sp, a.nout);
    const x2 = b.x, y2 = portY(b, e.dp, b.nin);
    const p = document.createElementNS(NS, 'path');
    p.setAttribute('class', 'edge');
    p.setAttribute('d', `M ${{x1}} ${{y1}} C ${{x1+60}} ${{y1}}, ${{x2-60}} ${{y2}}, ${{x2}} ${{y2}}`);
    svg.appendChild(p);
  }}
  for (const n of nodes) {{
    byId[n.id] = n;
    const g = document.createElementNS(NS, 'g');
    g.setAttribute('class', 'node');
    const h = 28 + Math.max(n.nin, n.nout, 1) * 18;
    g.innerHTML = `<rect x="${{n.x}}" y="${{n.y}}" width="170" height="${{h}}"></rect>`
      + `<text x="${{n.x+8}}" y="${{n.y+16}}">${{n.label}}</text>`;
    for (let i = 0; i < n.nin; i++)
      g.innerHTML += `<circle class="port" cx="${{n.x}}" cy="${{portY(n,i,n.nin)}}" r="4"></circle>`;
    for (let i = 0; i < n.nout; i++)
      g.innerHTML += `<circle class="port" cx="${{n.x+170}}" cy="${{portY(n,i,n.nout)}}" r="4"></circle>`;
    g.addEventListener('mousedown', ev => {{ drag = [n, ev.clientX - n.x, ev.clientY - n.y]; }});
    svg.appendChild(g);
  }}
}}
// one window-level listener pair (re-registering inside draw() would add
// 2*N listeners per redraw and redraw on every mouse move)
let drag = null;
window.addEventListener('mousemove', ev => {{
  if (drag) {{ const [n, dx, dy] = drag; n.x = ev.clientX - dx; n.y = ev.clientY - dy; draw(); }}
}});
window.addEventListener('mouseup', () => drag = null);
draw();
</script></body></html>"""
