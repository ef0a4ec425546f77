"""``k3_roofline``: the island kernel K3's share of its roofline, the
benchmark's least time for the island's work (``harness/roofline.py``,
from the nodes the island runs and the cell's shapes) over K3's mean
device time a launch.  One launch an island a chunk is expected; a profile
that shows another count, or disagrees with the program's own launch
counter, gives no reading."""

from fwbench.harness import roofline
from fwbench.harness.trace import port_kernel

LAYER = "island kernel K3"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "shipped_rtf"


def read(run):
    if not run.islands:
        return None
    launches = [o for o in run.trace.kernels() if port_kernel(o.name) == "K3"]
    expected = run.chunks * len(run.islands)
    if len(launches) != expected or run.port_launches.get("K3") != expected:
        run.note(f"k3_roofline: {len(launches)} K3 launches in the profile and "
                 f"{run.port_launches.get('K3')} by the program's counter, {expected} "
                 "expected")
        return None
    frames = run.blocks * run.frames
    least = 0.0
    for kinds, ins, outs in run.islands:
        try:
            work = roofline.island_work(kinds, run.node_specs, run.batch, frames, ins, outs)
        except KeyError as exc:
            run.note(f"k3_roofline: {exc.args[0]}")
            return None
        t = work.least_s(run.card)
        if t is None:
            run.note(f"k3_roofline: no peaks for {run.card}")
            return None
        least += t
    device = sum(o.seconds for o in launches) / run.chunks
    return 100.0 * least / device
