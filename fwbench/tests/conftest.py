"""The benchmark's tests: ``python -m pytest fwbench/tests -q`` from the
root.  Tests marked ``card`` need a CUDA card and skip without one."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="session")
def bench():
    from fwbench.harness import cell

    return cell.load_json(ROOT / "BENCHMARK.json")


def small(traffic: dict, **over) -> dict:
    """A traffic file cut to a size a CPU test can hold."""
    t = dict(traffic, batch=8, live=8, blocks=2, warm_chunks=3, trace_chunks=1,
             compare_sessions=3)
    t.update(over)
    return t
