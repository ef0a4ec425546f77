"""The device the port's entry points run on.

Every entry point (``ScheduleProgram``, ``BatchRenderer``, ``MegaRenderer``,
``HybridMegaRenderer`` and the graph functions of :mod:`.mixer`) takes
``device="cuda"`` by default and resolves it here: the port runs on the
card unless the caller asks for the CPU, where it runs the kernels' plain
versions.  Without a CUDA device a CUDA request raises; it never falls back
to the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device"]

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device = DEFAULT_DEVICE) -> torch.device:
    """``device`` as a ``torch.device``.  A bare ``"cuda"`` is pinned to the
    current index (a tensor's device always has one, and the renderers
    compare devices exactly); a CUDA device with no CUDA available raises
    ``RuntimeError``."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested, but no CUDA device is available; "
            "pass device='cpu' to run the plain versions on the CPU"
        )
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
