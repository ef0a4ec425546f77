"""``device.idle_pct``: the share of the traced window in which no kernel
and no copy ran on the card."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "shipped_rtf"


def read(run):
    if not run.trace.ops:
        run.note("device.idle_pct: the profile saw no device activity")
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
