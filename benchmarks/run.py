#!/usr/bin/env python3
"""Run one benchmark cell once and print its result as the last line.

    python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the repository root, on a machine with the cards the cell asks for;
without them it exits 2 and prints no result.  The caches that builds
leave (the program's kernels build under build/ in the checkout) stay
inside the checkout, at fixed paths.

The process runs one OpenMP thread (OMP_NUM_THREADS=1).  The program's
idle OpenMP workers spin on the cores that its own native threads (walk,
replay, format) need, and on an H100 machine of 8 host cores that made
whole runs differ by up to a third in pairs a second, more than any
bound can hold.  So the metrics leave out that cost, which a user's
process with the default thread count pays.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "bench-cache"
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["USE_FLAX"] = "0"
os.environ["OMP_NUM_THREADS"] = "1"
sys.path.insert(0, str(ROOT))

from benchmarks import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T_START))
