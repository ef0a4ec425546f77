"""``render.enqueue_ms``: host time of one ``BatchRenderer.render_chunk``
call, from the call to its return, averaged over the window's chunks that
were not profiled (the profiler slows the host)."""

LAYER = "batch renderer"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "shipped_rtf"


def read(run):
    if not run.enqueue_s:
        return None
    return 1e3 * sum(run.enqueue_s) / len(run.enqueue_s)
