"""The port's ``parallel/distributed.py``: the batch-slicing arithmetic
under a mocked process topology, and ``initialize_multihost``'s call to
``torch.distributed`` (``tests/test_distributed.py``'s cases on the port).

``spawn_ranks`` is the gloo process group the other multi-process tests of
the port run in (``test_torch_parallel.py``, ``test_torch_fleet_resume.py``):
CPU children that import torch and the port, never JAX."""

import os
import socket
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest

import firewheel_tpu_torch.parallel.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the lines every child starts with: the port from this checkout, one
#: thread (the ranks share the test's cores), and the gloo group
CHILD_PRELUDE = r"""
import os, sys
rank, world, port, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
sys.path.insert(0, os.getcwd())
import numpy as np
import torch
torch.set_num_threads(1)
from firewheel_tpu_torch.parallel import initialize_multihost
initialize_multihost(f"localhost:{port}", world, rank, backend="gloo")
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_ranks(script: str, world: int, work: str):
    """Start ``world`` gloo ranks running ``CHILD_PRELUDE + script`` (in
    ``work``); returns their processes for :func:`wait_ranks`."""
    path = os.path.join(work, f"rank_script_{_free_port()}.py")
    with open(path, "w") as f:
        f.write(CHILD_PRELUDE + script)
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=f"{REPO}:{work}")
    port = str(_free_port())
    return [subprocess.Popen([sys.executable, path, str(r), str(world), port, work],
                             env=env, cwd=REPO, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def wait_ranks(procs, timeout: float = 120.0) -> list[str]:
    """Wait for every rank: each must exit 0 within ``timeout`` seconds;
    on any failure every rank is killed and the test fails with the
    failing rank's log."""
    logs = []
    try:
        for rank, p in enumerate(procs):
            try:
                out, _ = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                pytest.fail(f"rank {rank} outlived its {timeout} s")
            logs.append(out)
            if p.returncode != 0:
                pytest.fail(f"rank {rank} exited {p.returncode}:\n{out[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return logs


def spawn_ranks(script: str, world: int, work: str, timeout: float = 120.0) -> list[str]:
    """:func:`start_ranks`, then :func:`wait_ranks`."""
    return wait_ranks(start_ranks(script, world, work), timeout)


def _slices(global_batch, nproc):
    out = []
    with mock.patch.object(dist, "process_count", return_value=nproc):
        for rank in range(nproc):
            with mock.patch.object(dist, "process_index", return_value=rank):
                out.append(dist.local_batch_slice(global_batch))
    return out


@pytest.mark.parametrize("nproc", [1, 2, 4, 8])
def test_slices_partition_the_batch(nproc):
    for global_batch in (nproc, 4 * nproc, 64):
        if global_batch % nproc:
            continue
        covered = np.zeros(global_batch, bool)
        for s in _slices(global_batch, nproc):
            assert not covered[s].any(), "overlapping process slices"
            covered[s] = True
        assert covered.all(), "the processes did not cover the global batch"


def test_slices_are_contiguous_rank_ordered():
    assert _slices(32, 4) == [slice(0, 8), slice(8, 16), slice(16, 24), slice(24, 32)]


def test_slice_feeds_process_local_rows():
    global_params = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    shards = [global_params[s] for s in _slices(16, 4)]
    assert all(sh.shape == (4, 3) for sh in shards)
    np.testing.assert_array_equal(np.concatenate(shards), global_params)


def test_single_process_is_identity():
    assert _slices(8, 1) == [slice(0, 8)]
    # no process group: the topology of one process
    assert (dist.process_count(), dist.process_index()) == (1, 0)
    assert dist.local_batch_slice(8) == slice(0, 8)


@pytest.mark.parametrize("kwargs, backend", [({}, "nccl"), ({"backend": "gloo"}, "gloo")])
def test_initialize_multihost_forwards_args(kwargs, backend):
    with mock.patch.object(dist.dist, "init_process_group") as ini:
        dist.initialize_multihost("10.0.0.1:1234", 4, 2, timeout=None, **kwargs)
        ini.assert_called_once_with(
            backend=backend,
            init_method="tcp://10.0.0.1:1234",
            world_size=4,
            rank=2,
            timeout=None,
        )

