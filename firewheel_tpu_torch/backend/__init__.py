"""firewheel_tpu_torch.backend — the streaming backend (the
``firewheel-cpal`` analog): host ring-buffer output streams over the
device render path."""

from .context import FirewheelCtx
from .device_info import DeviceInfo, available_output_devices
from .ring_buffer import RingBuffer
from .stream import ArraySink, OutputStream, StreamConfig, StreamError, WavSink

__all__ = [
    "FirewheelCtx",
    "DeviceInfo",
    "available_output_devices",
    "RingBuffer",
    "ArraySink",
    "OutputStream",
    "StreamConfig",
    "StreamError",
    "WavSink",
]
