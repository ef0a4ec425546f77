"""Multi-process scale-out: the process group a sharded fleet runs in.

PyTorch port of ``firewheel_tpu/parallel/distributed.py``.  Torch runs one
process per device: each process of a fleet joins one
``torch.distributed`` process group (NCCL between cards by default), then
builds the same :func:`~firewheel_tpu_torch.parallel.mesh.make_mesh` and
renderer with the same global arguments::

    from firewheel_tpu_torch.parallel import (
        BatchRenderer, initialize_multihost, make_mesh)

    torch.cuda.set_device(LOCAL_RANK)
    initialize_multihost("10.0.0.1:1234", num_processes=WORLD,
                         process_id=RANK)
    mesh = make_mesh({"dp": WORLD})
    renderer = BatchRenderer(program, batch=GLOBAL_BATCH, mesh=mesh)

Each process then holds, renders and returns only its own rows of the
global batch (``renderer.local_rows``).  Instances are independent, so the
render loop needs no collective; a fleet checkpoint synchronises once.

:func:`process_count` and :func:`process_index` are the topology every
module of the port reads (``jax.process_count``/``jax.process_index`` in
the JAX package): 1 and 0 when no process group is initialised.
"""

from __future__ import annotations

import torch.distributed as dist

__all__ = ["initialize_multihost", "local_batch_slice", "process_count",
           "process_index"]


def initialize_multihost(coordinator: str, num_processes: int, process_id: int,
                         backend: str = "nccl", **kwargs) -> None:
    """Join the fleet's process group: ``coordinator`` is ``host:port`` of
    rank 0's rendezvous.  ``backend`` is NCCL (one card a rank) unless the
    caller passes another (``"gloo"`` on the CPU); other keyword arguments
    pass through to ``torch.distributed.init_process_group``."""
    dist.init_process_group(
        backend=backend,
        init_method=f"tcp://{coordinator}",
        world_size=num_processes,
        rank=process_id,
        **kwargs,
    )


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """Processes in the fleet's group (1 without one)."""
    return dist.get_world_size() if _initialized() else 1


def process_index() -> int:
    """This process's rank in the fleet's group (0 without one)."""
    return dist.get_rank() if _initialized() else 0


def local_batch_slice(global_batch: int) -> slice:
    """The slice of the global instance batch this process owns under a
    pure "dp" sharding (contiguous per-process blocks, in rank order)."""
    per = global_batch // process_count()
    start = process_index() * per
    return slice(start, start + per)
