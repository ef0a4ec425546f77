"""``k1_roofline``: the sequential biquad K1's share of its roofline, the
benchmark's least time for one launch's filter work (every session's two
channels over one block, ``harness/roofline.py``) over K1's mean device
time a launch.  One launch a block is expected; another count in the
profile gives no reading."""

from fwbench.harness import roofline
from fwbench.harness.trace import port_kernel

LAYER = "sequential biquad K1"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "shipped_rtf"


def read(run):
    launches = [o for o in run.trace.kernels() if port_kernel(o.name) == "K1"]
    expected = run.chunks * run.blocks
    if len(launches) != expected:
        run.note(f"k1_roofline: {len(launches)} K1 launches in the profile, "
                 f"{expected} expected (one a block)")
        return None
    least = roofline.biquad_launch_work(run.batch, run.frames).least_s(run.card)
    if least is None:
        run.note(f"k1_roofline: no peaks for {run.card}")
        return None
    return 100.0 * least / (sum(o.seconds for o in launches) / len(launches))
