"""Run one cell of the benchmark once and print its result line.

    python3 fwbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and ``check`` last: each number
compared beside its limit).  Without a CUDA card, or with fewer cards than
the cell asks for, it exits with code 2 and prints no result; in a
directory without the port it exits with code 4.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "fwbench" / ".cache"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache the run could write stays at a fixed place in the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))

    import torch

    from fwbench.harness import cell as cellmod
    from fwbench.harness.runner import log, run_cell

    bench = cellmod.load_json(ROOT / "BENCHMARK.json")
    chips = cellmod.Cell(bench, args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"fwbench: {args.workload} needs {chips} CUDA card(s); "
            f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    try:
        import firewheel_tpu_torch  # noqa: F401
    except ImportError as exc:
        log(f"fwbench: the port is not in this checkout ({exc})")
        return 4
    torch.backends.cudnn.benchmark = False
    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                      device="cuda", t_start=T_START)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
