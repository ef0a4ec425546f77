"""firewheel_tpu_torch.parallel — multi-instance batching and scale-out
over ``torch.distributed`` process groups."""

from .mesh import BatchRenderer, VoiceParallelMixer, make_mesh
from .distributed import initialize_multihost, local_batch_slice

__all__ = [
    "BatchRenderer",
    "VoiceParallelMixer",
    "make_mesh",
    "initialize_multihost",
    "local_batch_slice",
]
