"""Phase timers and GCUPS accounting (tpu_align/runtime/profiler.py).

The reference accumulates per-phase microsecond buckets (memory management /
kernel / backtracking / printing) with gettimeofday timers (c++/timing.cpp:6-23)
and prints GCUPS = numCells / kernel_seconds * 1e-9 at exit
(cuda/LNW/LinearNeedlemanWunschV19.cu:669-680).  Same model here, on
time.perf_counter; a copy because the JAX package's runtime/__init__
imports its engine, which imports jax.  The port adds the launch counts of
the engine-path kernels (reset_launch_counts, launch_counts), which show
that a run went through the kernels.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class PhaseTimer:
    """Accumulating wall-clock phase buckets."""

    def __init__(self):
        self.seconds: dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] += time.perf_counter() - t0

    def add(self, name: str, secs: float) -> None:
        self.seconds[name] += secs

    @property
    def total(self) -> float:
        return sum(self.seconds.values())

    def gcups(self, num_cells: int, phase: str = "kernel") -> float:
        secs = self.seconds.get(phase, 0.0)
        if secs <= 0:
            return 0.0
        return num_cells / secs / 1e9

    def report(self) -> str:
        lines = [
            f"{name:>12}: {secs * 1e6:14.1f} us"
            for name, secs in sorted(self.seconds.items())
        ]
        lines.append(f"{'total':>12}: {self.total * 1e6:14.1f} us")
        return "\n".join(lines)


def _counter_modules():
    from tpu_align_torch.kernels import banded, fill, stagger
    from tpu_align_torch.traceback import device, hirschberg, walk_kernel

    return banded, fill, stagger, device, hirschberg, walk_kernel


def reset_launch_counts() -> None:
    """Set every engine-path kernel wrapper's launch count to 0 (the
    counts rise only where a wrapper launches its CUDA kernel, never for
    a plain version on CPU tensors)."""
    banded, fill, stagger, device, hirschberg, walk_kernel = \
        _counter_modules()
    stagger.launches = banded.launches = fill.launches = 0
    walk_kernel.walk_launches = walk_kernel.compact_launches = 0
    fill.last_rows_launches = stagger.last_rows_launches = 0
    hirschberg.launches = device.stream_finalized = 0


def launch_counts() -> dict:
    """The engine-path kernels' launch counts since the last reset, and
    the buckets whose device walk was finalized in the stream form."""
    banded, fill, stagger, device, hirschberg, walk_kernel = \
        _counter_modules()
    return {"stagger_fill": stagger.launches, "banded_fill": banded.launches,
            "rowscan_fill": fill.launches,
            "walk": walk_kernel.walk_launches,
            "compact": walk_kernel.compact_launches,
            "rowscan_last_rows": fill.last_rows_launches,
            "stagger_last_rows": stagger.last_rows_launches,
            "split_reduce": hirschberg.launches,
            "stream": device.stream_finalized}
