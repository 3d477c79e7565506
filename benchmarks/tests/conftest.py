"""Shared helpers of the benchmark's CPU tests: tiny versions of the
cells, run on the CPU through the harness (the program's plain kernel
versions), never through the card check."""

import json
import sys
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmarks import harness  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    import torch

    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


@pytest.fixture(scope="session")
def bench():
    return json.loads((REPO / "BENCHMARK.json").read_text())


# each cell cut to a size a CPU test holds, its traffic otherwise as is
TINY = {
    "lnw-reads250-device": ({"batch_pairs": 24, "pool_batches": 2}, 40),
    "lnw-reads250-host": ({"batch_pairs": 24, "pool_batches": 2}, 40),
    "lnw-long16k-hirschberg": ({"batch_pairs": 3, "pool_batches": 2}, 300),
    "lnw-long16k-scores": ({"batch_pairs": 12, "pool_batches": 2,
                            "check_pairs": 5}, 200),
}


def tiny_cell(name, root=None):
    cell = harness.load_cell(name, root or harness.HERE)
    traffic, length = TINY.get(name, ({}, None))
    cell.traffic.update(traffic)
    if length:
        cell.config["reference_length"] = length
    return cell


def cpu_run(cell, bench, seed=2**31 + 11, trace=False, seconds=0.2,
            **kw):
    return harness.run(cell, seed, seconds, trace, "cpu", bench,
                       time.perf_counter(), log=lambda m: None, **kw)
