"""Profiling and tracing hooks over ``torch.profiler``.

PyTorch port of ``firewheel_tpu/utils/profiler.py``:

* :func:`trace`: a context manager that profiles the host, and the card
  when one is in use, and writes a Chrome/Perfetto trace of the work
  inside into a directory;
* :func:`annotate`: a named host-side region inside a trace;
* ``OutputStream.stats()`` (``backend/stream.py``): per-buffer render
  latency percentiles against the realtime budget;
* the schedule pretty-printers live in ``utils/viz.py``.
"""

from __future__ import annotations

import contextlib
import os
import time

__all__ = ["trace", "annotate"]


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block's CPU work, and its CUDA work when a card is
    available, into ``logdir/trace-<pid>-<ns>.json`` (open it in
    ui.perfetto.dev or chrome://tracing).  Yields the
    ``torch.profiler.profile`` object (``key_averages()`` and the like)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(
        os.path.join(logdir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


def annotate(name: str):
    """Named trace region: ``with annotate("render-chunk"): ...``"""
    from torch.profiler import record_function

    return record_function(name)
