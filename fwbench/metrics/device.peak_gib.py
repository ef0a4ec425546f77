"""``device.peak_gib``: the most device memory that PyTorch's allocator
held at once over the window (``torch.cuda.max_memory_allocated``)."""

LAYER = "device"
UNIT = "GiB"
SOURCE = "program_counter"
MOVES = "shipped_rtf"


def read(run):
    if not run.window_peak_bytes:
        return None
    return run.window_peak_bytes / 2 ** 30
