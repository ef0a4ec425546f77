"""The control of the correctness check: the plain reference put in the
program's place and computed in bfloat16, the precision below the float32
that the configurations state.  Its shipped int16 is compared with the
float64 reference by the check that decides ``correct`` (the widest gap in
LSB over the compared sessions), and has to fail it.

    python3 fwbench/control.py --workload <cell> --seeds 1 2 3 --chunks 400

draws each seed's sessions as a run of the cell does (on the card, at the
cell's batch) and prints, for each seed, the control's reading beside the
limit.  ``--chunks``: how many chunks of K blocks to render, as many as a
run compares.  The benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from fwbench.harness import cell as cellmod  # noqa: E402


def control_reading(cell: cellmod.Cell, seed: int, chunks: int, device,
                    dt=torch.bfloat16) -> dict:
    """The widest gap, in LSB, between the reference computed in ``dt`` and
    in float64, over the sessions that a run of ``cell`` with ``seed``
    compares, for ``chunks`` chunks."""
    t = cell.traffic
    batch = int(t["batch"])
    values = cell.config.session_values(cell.cfg, batch, seed, device)
    live = torch.arange(batch, device=device) % (batch // int(t["live"])) == 0
    rows = torch.nonzero(live).flatten().tolist()
    compared = cellmod.sample_sessions(rows, int(t["compare_sessions"]), seed)
    picked = cell.config.rows(values, compared)
    frames = chunks * int(t["blocks"]) * cell.cfg["block_frames"]
    ref = cell.reference.render(cell.cfg, picked, frames, torch.float64).to(torch.int32)
    low = cell.reference.render(cell.cfg, picked, frames, dt).to(torch.int32)
    return {"max_lsb_gap": int((low - ref).abs().max()),
            "limit": cell.cfg["correct"]["max_lsb_gap"], "frames": frames,
            "sessions": len(compared)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--chunks", type=int, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fwbench control: no CUDA card", file=sys.stderr)
        return 2
    bench = cellmod.load_json(ROOT / "BENCHMARK.json")
    cell = cellmod.Cell(bench, args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = control_reading(cell, seed, args.chunks, torch.device("cuda"))
        r.update(workload=args.workload, seed=seed, seconds=time.perf_counter() - t0)
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
