"""``egress.copy_ms``: device time of the device→host copies of the traced
chunks (``Egress``'s side stream into pinned memory), a chunk."""

LAYER = "egress"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "shipped_rtf"


def read(run):
    copies = run.trace.copies()
    if len(copies) != run.chunks:
        run.note(f"egress.copy_ms: {len(copies)} device-to-host copies in the profile "
                 f"of {run.chunks} chunks, one a chunk expected")
        return None
    return 1e3 * sum(c.seconds for c in copies) / run.chunks
