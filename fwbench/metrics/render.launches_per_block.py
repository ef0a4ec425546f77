"""``render.launches_per_block``: device kernels of the traced chunks
(render, pcm16 conversion; no copies) over the blocks they rendered."""

LAYER = "batch renderer"
UNIT = "launches"
SOURCE = "device_trace"
MOVES = "shipped_rtf"


def read(run):
    kernels = run.trace.kernels()
    if not kernels:
        run.note("render.launches_per_block: the profile saw no device kernel")
        return None
    return len(kernels) / (run.chunks * run.blocks)
