"""The node abstraction: main-thread handles and pure compute kernels.

PyTorch port of ``firewheel_tpu/core/node.py``.  A node splits into a
main-thread half (:class:`AudioNode`) and a compute half
(:class:`NodeProcessor`) whose kernel is a function on tensors::

    kernel(params, state, inputs[..., ch, F], in_mask[..., ch], info) ->
        (outputs[..., ch, F], new_state, out_mask[..., ch])

* ``params`` — a dict of tensors staged from the host every dispatch.
* ``state``  — a dict of tensors carried from block to block.
* ``in_mask``/``out_mask`` — boolean silence flags per channel.

Every kernel takes any number of leading batch dimensions (``...``): the
executor adds one for node pooling (a member axis) and the batch renderer
one for instances, where the JAX package uses ``vmap``.  Every leaf of
``params`` and ``state`` carries the same leading dimensions.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "gate",
    "wrap_stream_sample",
    "stream_time_from_sample",
    "AudioNodeInfo",
    "BlockInfo",
    "NodeProcessor",
    "AudioNode",
    "NodeActivationError",
    "StreamStatus",
    "MAX_PORTS",
    "STREAM_SAMPLE_PERIOD",
    "UINT32_MASK",
    "wrap_int32",
]

# Hard engine constant: at most 64 ports per node, the silence-mask width
# (node.rs:62,69; silence_mask.rs:23-29).
MAX_PORTS = 64


class StreamStatus(enum.IntFlag):
    """Stream status bitflags (node.rs:120-132)."""

    NONE = 0
    INPUT_OVERFLOW = 0b01
    OUTPUT_UNDERFLOW = 0b10


@dataclasses.dataclass(frozen=True)
class AudioNodeInfo:
    """Port-count constraints and update opt-in (node.rs:57-90)."""

    num_min_supported_inputs: int = 0
    num_max_supported_inputs: int = 0
    num_min_supported_outputs: int = 0
    num_max_supported_outputs: int = 0
    updates: bool = False

    def __post_init__(self):
        assert self.num_max_supported_inputs <= MAX_PORTS
        assert self.num_max_supported_outputs <= MAX_PORTS


def expand_like(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """View ``p`` (shape = leading dims of ``x``) with trailing unit dims
    so that it broadcasts against ``x``."""
    return p.reshape(p.shape + (1,) * (x.ndim - p.ndim))


def gate(x: torch.Tensor, silent_flag: torch.Tensor) -> torch.Tensor:
    """Zero ``x`` where ``silent_flag`` is set, broadcasting the flag over
    ``x``'s trailing dims.

    A real select, so flagged-silent outputs are exactly zero even if a
    kernel emits non-finite samples (``0 * NaN`` would leak NaN)."""
    return x.masked_fill(expand_like(silent_flag, x), 0.0)


#: the device stream clock's modulus: kernels see ``stream_sample`` as an
#: unsigned 32-bit counter that wraps every 2^32 samples (~24.8 h @ 48 kHz)
STREAM_SAMPLE_PERIOD = 1 << 32
UINT32_MASK = STREAM_SAMPLE_PERIOD - 1


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """An int64 tensor wrapped to the int32 value with the same low 32
    bits: what the JAX package's int32 arithmetic gives."""
    return ((x + (1 << 31)) & UINT32_MASK) - (1 << 31)


def wrap_stream_sample(start_sample):
    """Rebase a host sample clock onto the device's modular 32-bit clock.

    torch has no uint32 arithmetic on the CPU, so the port carries every
    uint32 value as int64 masked to 32 bits.  A Python int stays a Python
    int; a tensor stays an int64 tensor."""
    if isinstance(start_sample, torch.Tensor):
        return start_sample.to(torch.int64) & UINT32_MASK
    return int(start_sample) & UINT32_MASK


def stream_time_from_sample(sample: torch.Tensor, sample_rate: float):
    """32-bit sample counter (int64 tensor) -> f32 seconds, split precision.

    Same 16-bit split and op order as the JAX package: both halves convert
    to f32 exactly, so the result is within ~1 ulp of the true time over
    the whole uint32 range.  The two scales are rounded to f32 first, as
    the JAX package rounds them."""
    hi = (sample >> 16).to(torch.float32)
    lo = (sample & 0xFFFF).to(torch.float32)
    return hi * float(np.float32(65536.0 / sample_rate)) + lo * float(
        np.float32(1.0 / sample_rate)
    )


class BlockInfo(NamedTuple):
    """Per-block metadata passed to every kernel (``ProcInfo``,
    node.rs:94-118).

    ``stream_time_secs`` — f32 seconds to this block's first frame.
    ``stream_sample`` — the block's first sample on the modular 32-bit
    clock (int64).  ``stream_status`` — stream status bits (node.rs:120-132).
    The clock is shared by every instance of a batch, so its leaves are
    0-dim tensors."""

    stream_time_secs: torch.Tensor
    stream_sample: torch.Tensor
    stream_status: torch.Tensor

    @staticmethod
    def make(stream_time_secs=0.0, stream_sample=0, stream_status=0,
             device="cpu") -> "BlockInfo":
        return BlockInfo(
            stream_time_secs=torch.tensor(
                stream_time_secs, dtype=torch.float32, device=device
            ),
            stream_sample=torch.tensor(
                wrap_stream_sample(stream_sample), dtype=torch.int64,
                device=device,
            ),
            stream_status=torch.tensor(
                int(stream_status), dtype=torch.int64, device=device
            ),
        )


class NodeActivationError(Exception):
    """Raised by :meth:`AudioNode.activate` on invalid configuration
    (the ``CompileGraphError::NodeActivationFailed`` payload,
    ``graph/error.rs``)."""


class NodeProcessor:
    """The compute half of a node, created by :meth:`AudioNode.activate`.

    Subclasses define :meth:`init_state`, :meth:`collect_params` and
    :meth:`kernel`.  ``sample_rate``, ``max_block_frames`` and the port
    counts are static.
    """

    #: Whether the CUDA megakernel (``executor_mega``) may render this
    #: processor.  It also needs a device function for the processor's
    #: class in the kernel's op registry, so a processor without one is
    #: ineligible whatever this says; set it ``False`` to opt out of one
    #: that has.
    supports_megakernel: bool = True

    def __init__(
        self,
        sample_rate: int,
        max_block_frames: int,
        num_inputs: int,
        num_outputs: int,
    ):
        self.sample_rate = int(sample_rate)
        self.max_block_frames = int(max_block_frames)
        self.num_inputs = int(num_inputs)
        self.num_outputs = int(num_outputs)

    # -- overridables --------------------------------------------------------
    def init_state(self) -> dict:
        """Initial recurrent state: a dict of CPU tensors (empty when
        stateless)."""
        return {}

    def collect_params(self) -> dict:
        """Snapshot current host-side params as a dict of numpy scalars
        (the lock-free param channel, volume.rs:92)."""
        return {}

    def kernel(self, params, state, inputs, in_mask, info: BlockInfo):
        """Per-block compute; see the module docstring for the contract.

        ``inputs`` is ``f32[..., num_inputs, F]`` and ``in_mask``
        ``bool[..., num_inputs]``.  Returns ``(f32[..., num_outputs, F],
        new_state, bool[..., num_outputs])``.
        """
        raise NotImplementedError

    def resync_from_state(self, state) -> None:
        """Adopt a restored state's control metadata (sequence numbers)
        into the host-side node, so that the first block after
        ``GraphProcessor.set_state_dict`` sees no spurious command edge.
        Default: nothing to sync."""

    def event_counters(self) -> dict:
        """Device-side event counters, ``{event_name: state_key}``: each
        named state leaf is a monotonic 32-bit counter the kernel
        increments when the event occurs (``core/events.py``).  Default:
        none."""
        return {}

    def group_key(self):
        """Pooling signature, or ``None``.

        The executor runs identical consecutive nodes as one kernel call
        over a stacked member axis.  Two processors may share a group only
        if their kernels are behaviorally identical given the same
        (params, state, inputs): every per-node difference lives in params
        or state.  Return ``None`` (the default) to opt out."""
        return None


class AudioNode:
    """Main-thread node handle (node.rs:6-34).

    Holds user-facing parameters; :meth:`activate` validates the port
    configuration and builds the :class:`NodeProcessor`.
    """

    debug_name: str = "node"

    #: silence in => silence out with no self-generated signal
    #: (``AudioGraph.prune_dormant``)
    silence_transparent: bool = False

    def is_dormant(self) -> bool:
        """True while this node is guaranteed to output silence."""
        return False

    def latency_frames(self, sample_rate: int) -> int:
        """Algorithmic delay this node imposes on its signal path."""
        return 0

    def info(self) -> AudioNodeInfo:
        raise NotImplementedError

    def activate(
        self,
        sample_rate: int,
        max_block_frames: int,
        num_inputs: int,
        num_outputs: int,
    ) -> NodeProcessor:
        raise NotImplementedError

    def deactivate(self, processor: NodeProcessor | None = None) -> None:
        """Called when the processor half is retired (node.rs:25-28)."""

    def update(self) -> None:
        """Periodic main-thread hook; called only if ``info().updates``
        (node.rs:30-34)."""
