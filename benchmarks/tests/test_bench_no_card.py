"""Without a card a run exits non-zero and prints no result: it never
falls back to the CPU."""

import json
import subprocess
import sys

import pytest

from benchmarks.tests.conftest import REPO


@pytest.mark.parametrize("trace", ["0", "1"])
def test_a_run_without_a_card_fails_and_prints_nothing(trace):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible here")
    out = subprocess.run(
        [sys.executable, "benchmarks/run.py", "--workload",
         "lnw-reads250-device", "--seed", str(2**31 + 3), "--seconds", "1",
         "--trace", trace], capture_output=True, text=True, timeout=300,
        cwd=REPO)
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)
    assert "CUDA" in out.stderr
