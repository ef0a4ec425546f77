"""Backend device descriptors.

Mirrors ``crates/firewheel-graph/src/backend.rs:1-6`` (``DeviceInfo``) and
the cpal enumeration (``firewheel-cpal/src/lib.rs:44-97``); here the
"output devices" are the CUDA devices torch sees.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["DeviceInfo", "available_output_devices"]


@dataclasses.dataclass(frozen=True)
class DeviceInfo:
    name: str
    num_channels: int
    is_default: bool


def available_output_devices(num_channels: int = 2) -> list[DeviceInfo]:
    """The CUDA devices, the current one marked default; empty without
    CUDA."""
    if not torch.cuda.is_available():
        return []
    current = torch.cuda.current_device()
    return [
        DeviceInfo(
            name=f"cuda:{i} ({torch.cuda.get_device_name(i)})",
            num_channels=num_channels,
            is_default=(i == current),
        )
        for i in range(torch.cuda.device_count())
    ]
