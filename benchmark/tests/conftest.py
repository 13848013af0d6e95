"""Tests of the benchmark's harness, counters and plain reference, run by
``python -m pytest benchmark/tests -q`` from the repository root. Tests
that need the card carry the ``cuda`` marker and skip without one."""

import pytest
import torch

from benchmark import harness as H

# cells whose files are all under benchmark/ but which BENCHMARK.json does
# not list (PERF.md says why); the tests run them as the cells they would be
QUEUED = [{"name": "resnet18-percal", "config": "spaa-resnet18",
           "traffic": "percal11x50", "chips": 1}]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips elsewhere")


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def queued_cells(monkeypatch):
    """``BENCHMARK.json`` with the queued cells it does not list yet."""
    spec = H.benchmark_spec()
    known = {c["name"] for c in spec["workloads"]}
    spec["workloads"] += [c for c in QUEUED if c["name"] not in known]
    monkeypatch.setattr(H, "benchmark_spec", lambda: spec)
