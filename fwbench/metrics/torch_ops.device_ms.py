"""``torch_ops.device_ms``: device time a chunk of every kernel that is
none of the port's hand-written kernels K1–K9 and no copy: the node ops
that PyTorch runs, through the eager executor or the hybrid's torch
stages, and the pcm16 conversion."""

from fwbench.harness.trace import port_kernel

LAYER = "node ops"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "shipped_rtf"


def read(run):
    ops = [o for o in run.trace.kernels() if port_kernel(o.name) is None]
    if not ops:
        run.note("torch_ops.device_ms: no torch kernel in the profile")
        return None
    return 1e3 * sum(o.seconds for o in ops) / run.chunks
