"""Phase timers, GCUPS accounting and the launch counters
(tpu_align/runtime/profiler.py).

The reference accumulates per-phase microsecond buckets (memory management /
kernel / backtracking / printing) with gettimeofday timers (c++/timing.cpp:6-23)
and prints GCUPS = numCells / kernel_seconds * 1e-9 at exit
(cuda/LNW/LinearNeedlemanWunschV19.cu:669-680).  Same model here, on
time.perf_counter; a copy because the JAX package's runtime/__init__
imports its engine, which imports jax.

The port nests phases: a sub-span's name is its parent's, a dot and its
own ("memmgmt.gather" inside "memmgmt"), and every span of the program
goes through PhaseTimer.phase.  A recording timer (record=True; the CLI's
-trace FILE, written by chrome_trace) also keeps each span.  It adds the
launch counts of the engine-path kernels (reset_launch_counts,
launch_counts), which show that a run went through the kernels, what
each fill launch held (count_fill), and what each launch of the band
wavefront ran on (count_band: its persistent warps, the cells its
scores step took in steady chunks, and those its LNW scores step took in
the gap-offset form); and one count the band wavefront's kernel keeps on
the card, fill_band_scores_cells: the real cells of the band items that
took its scores step, whatever the aligner.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import NamedTuple

import numpy as np


class Span(NamedTuple):
    """One recorded span: its name, its ends on time.monotonic_ns(), the
    name of the span open around it, and the batch and bucket it worked
    for (None outside a bucket)."""

    name: str
    start_ns: int
    end_ns: int
    parent: str | None
    batch: int
    bucket: int | None


class PhaseTimer:
    """Accumulating wall-clock phase buckets.

    `seconds` keeps every name; `total` sums the top-level (dotless)
    phases alone, so a sub-span is never counted twice, and report()
    lists each sub-span under its parent.

    record=True keeps each span in `spans` as well (a Span), and `clocks`
    holds the realtime and monotonic clocks read once, as the recording
    began, to put the spans on another clock's trace.  `batch` is the run
    the spans belong to (AlignmentEngine.run calls start_batch) and
    `bucket` the bucket, set around a bucket's work by on_bucket.  Without
    record a phase costs two clock reads and a dict add."""

    def __init__(self, record: bool = False):
        self.seconds: dict[str, float] = defaultdict(float)
        self.spans: list[Span] | None = [] if record else None
        self.clocks = ({"realtime": time.time_ns(),
                        "monotonic": time.monotonic_ns()} if record else None)
        self.batch = -1
        self.bucket: int | None = None
        self._open: list[str] = []

    @contextlib.contextmanager
    def phase(self, name: str):
        if self.spans is None:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.seconds[name] += time.perf_counter() - t0
            return
        parent = self._open[-1] if self._open else None
        self._open.append(name)
        t0 = time.monotonic_ns()
        try:
            yield
        finally:
            t1 = time.monotonic_ns()
            self._open.pop()
            self.seconds[name] += (t1 - t0) / 1e9
            self.spans.append(Span(name, t0, t1, parent, self.batch,
                                   self.bucket))

    @contextlib.contextmanager
    def on_bucket(self, bucket: int):
        """Spans inside carry this bucket id."""
        was, self.bucket = self.bucket, bucket
        try:
            yield
        finally:
            self.bucket = was

    def start_batch(self) -> None:
        """Spans from here on belong to the next batch (0 first)."""
        self.batch += 1
        self.bucket = None

    def add(self, name: str, secs: float) -> None:
        self.seconds[name] += secs

    @property
    def total(self) -> float:
        return sum(s for name, s in self.seconds.items() if "." not in name)

    def gcups(self, num_cells: int, phase: str = "kernel") -> float:
        secs = self.seconds.get(phase, 0.0)
        if secs <= 0:
            return 0.0
        return num_cells / secs / 1e9

    def report(self, sub_spans: bool = True) -> str:
        """A line a phase, each sub-span under its parent (sub_spans=False:
        the top-level phases alone, the reference's timer buckets)."""
        names = sorted((n for n in self.seconds if sub_spans or "." not in n),
                       key=lambda n: n.split("."))
        width = max([12, *map(len, names)])
        lines = [f"{name:>{width}}: {self.seconds[name] * 1e6:14.1f} us"
                 for name in names]
        lines.append(f"{'total':>{width}}: {self.total * 1e6:14.1f} us")
        return "\n".join(lines)


def chrome_trace(timer: PhaseTimer, counts: dict) -> dict:
    """A recording timer's spans, and `counts` (launch_counts()), as a
    Chrome trace (chrome://tracing, Perfetto): a complete event a span,
    its ts and dur in us on time.monotonic_ns(), then one counter event
    of the counts at the last span's end.  otherData names the clock and
    holds the clock pair read as the recording began, which maps the
    spans onto a torch.profiler trace of the same process
    (benchmarks/trace.py clock_offset)."""
    if timer.spans is None:
        raise ValueError("the timer did not record its spans "
                         "(PhaseTimer(record=True))")
    pid = os.getpid()
    events = [{"name": s.name, "cat": "phase", "ph": "X", "pid": pid,
               "tid": 0, "ts": s.start_ns / 1e3,
               "dur": (s.end_ns - s.start_ns) / 1e3,
               "args": {"parent": s.parent, "batch": s.batch,
                        "bucket": s.bucket}} for s in timer.spans]
    end = max((s.end_ns for s in timer.spans),
              default=timer.clocks["monotonic"])
    events.append({"name": "launches", "cat": "counter", "ph": "C",
                   "pid": pid, "tid": 0, "ts": end / 1e3, "args": counts})
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"clock": "monotonic", "clocks": dict(timer.clocks),
                          "counts": counts}}


# what the fill launches held since the last reset; count_fill adds to it
FILL_KEYS = ("fill_counted", "fill_pairs", "fill_warps", "fill_cells",
             "fill_chain_cells")
_fill = dict.fromkeys(FILL_KEYS, 0)
# what the band wavefront's launches (B2, every mode) ran on; count_band
# adds to it
BAND_KEYS = ("fill_band_counted", "fill_band_warps_max",
             "fill_band_warp_cells", "fill_band_steady_cells",
             "fill_band_offset_cells")
_band = dict.fromkeys(BAND_KEYS, 0)
# columns of a chunk of the band wavefront's sweep (csrc/rowscan_fill.cu)
BAND_CHUNK = 32


def band_cells(rlen, qlen, band: int) -> np.ndarray:
    """Each pair's cells (i, j), 1 <= i <= qlen, 1 <= j <= rlen, with
    |i - j| < band: the cells the banded fill computes.  The whole
    matrix less its two corners past the band, each a sum of
    max(0, a - k + 1) over k."""
    rlen = np.asarray(rlen, np.int64)
    qlen = np.asarray(qlen, np.int64)

    def corner(a, n):
        p = np.clip(np.minimum(n, a), 0, None)
        return p * (2 * a - p + 1) // 2

    return (rlen * qlen - corner(qlen - band, rlen)
            - corner(rlen - band, qlen))


def steady_cells(rlen, qlen, band_rows: int) -> int:
    """The cells the band wavefront's scores step computes in steady
    chunks: in each full band (all but a partial bottom band, qlen //
    band_rows a pair), the chunks of 32 steps after the first whose
    columns all lie in [1, rlen], rlen // 32 - 1 of them, each 32 steps of
    band_rows cells.  A shape count: it takes every full band to hold
    bases alone, as the kernel's choice also asks."""
    rlen = np.asarray(rlen, np.int64)
    qlen = np.asarray(qlen, np.int64)
    full = np.clip(qlen, 0, None) // band_rows
    chunks = np.clip(rlen // BAND_CHUNK - 1, 0, None)
    return int(np.sum(full * chunks) * BAND_CHUNK * band_rows)


def full_band_cells(rlen, qlen, band_rows: int) -> int:
    """The cells of the full bands of band_rows rows (all but a partial
    bottom band, qlen // band_rows a pair), rlen columns each: those the
    scores step takes where every one holds bases alone."""
    rlen = np.asarray(rlen, np.int64)
    qlen = np.asarray(qlen, np.int64)
    full = np.clip(qlen, 0, None) // band_rows
    return int(np.sum(full * np.clip(rlen, 0, None)) * band_rows)


def fill_work(kernel: str, rlen, qlen, band: int | None = None,
              band_rows: int | None = None) -> dict:
    """What one fill launch over pairs of these lengths holds, by
    FILL_KEYS: the launch (1); its real pairs, those with cells to fill
    (a bucket's padding rows have none); the warps it gives them; their
    cells, rlen x qlen (the banded fill's: those in `band`); and the cells
    of its largest pair, the longest chain of work one warp takes.

    Warps by kernel: "stagger" (B1, and its last-row variant) and
    "banded" (B3) run one warp a pair; "rowscan" (B2's band wavefront,
    and its last-row mode) one warp a band of `band_rows` query rows
    (kernels/fill.py band_rows), ceil(qlen / band_rows) a pair, which
    persistent warps take in turn (the card holds fewer at once on large
    launches)."""
    rlen = np.asarray(rlen, np.int64)
    qlen = np.asarray(qlen, np.int64)
    cells = band_cells(rlen, qlen, band) if kernel == "banded" \
        else rlen * qlen
    real = cells > 0
    pairs = int(np.count_nonzero(real))
    if kernel == "rowscan":
        if band_rows is None:
            raise ValueError("a rowscan launch needs its band_rows")
        warps = int(np.sum(-(-qlen[real] // band_rows)))
    elif kernel in ("stagger", "banded"):
        warps = pairs
    else:
        raise ValueError(f"unknown fill kernel {kernel!r}")
    return {"fill_counted": 1, "fill_pairs": pairs, "fill_warps": warps,
            "fill_cells": int(cells.sum()),
            "fill_chain_cells": int(cells.max(initial=0))}


def count_fill(kernel: str, rlen, qlen, band: int | None = None) -> None:
    """Add one fill launch to the counters (fill_work): called where the
    launch is made, from the lengths the host holds, never from a device
    tensor.  A "rowscan" launch, the band wavefront's, is counted in the
    band size its wrapper launched (kernels/fill.py launch_band_rows), and
    by count_band, with the persistent warps the wrapper read back from
    that launch (band_warps) and, where its full bands could take the
    scores step (launch_scores_step), its steady cells and, where that
    step ran in the gap-offset form (launch_offset_form), its full bands'
    cells."""
    band_rows = steady = offset = None
    if kernel == "rowscan":
        from tpu_align_torch.kernels import fill

        band_rows = fill.launch_band_rows
        steady = band_rows if fill.launch_scores_step else None
        offset = band_rows if fill.launch_offset_form else None
    for key, value in fill_work(kernel, rlen, qlen, band,
                                band_rows).items():
        _fill[key] += value
    if kernel == "rowscan":
        count_band(fill.band_warps, rlen, qlen, steady, offset)


def count_band(warps: int, rlen, qlen, steady_rows: int | None = None,
               offset_rows: int | None = None) -> None:
    """Add one launch of the band wavefront (B2) to the BAND_KEYS
    counters: the launch (1); the most persistent warps any launch ran
    (warps: the launch's grid x warps a block, which the card's occupancy
    for the instantiation's registers caps); its real cells, rlen x qlen,
    over its warps, the cells each persistent warp took on average; and,
    for a scores launch whose full bands of steady_rows rows take the
    scores step (None for any other), the cells of their steady chunks
    (steady_cells); and, for an LNW scores launch whose full bands of
    offset_rows rows take the scores step in the gap-offset form (None for
    any other), their cells (full_band_cells).  Both are shape counts, as
    the kernel would choose for bands of bases alone.  A launch of no
    warps adds no cells a warp."""
    cells = int(np.sum(np.asarray(rlen, np.int64)
                       * np.asarray(qlen, np.int64)))
    _band["fill_band_counted"] += 1
    _band["fill_band_warps_max"] = max(_band["fill_band_warps_max"], warps)
    if warps > 0:
        _band["fill_band_warp_cells"] += cells / warps
    if steady_rows is not None:
        _band["fill_band_steady_cells"] += steady_cells(rlen, qlen,
                                                        steady_rows)
    if offset_rows is not None:
        _band["fill_band_offset_cells"] += full_band_cells(rlen, qlen,
                                                           offset_rows)


def _counter_modules():
    from tpu_align_torch.kernels import banded, fill, stagger
    from tpu_align_torch.traceback import device, hirschberg, walk_kernel

    return banded, fill, stagger, device, hirschberg, walk_kernel


def reset_launch_counts() -> None:
    """Set every engine-path kernel wrapper's launch count, and the fill
    counters, to 0 (the counts rise only where a wrapper launches its
    CUDA kernel, never for a plain version on CPU tensors)."""
    banded, fill, stagger, device, hirschberg, walk_kernel = \
        _counter_modules()
    stagger.launches = banded.launches = fill.launches = 0
    walk_kernel.walk_launches = walk_kernel.compact_launches = 0
    fill.last_rows_launches = stagger.last_rows_launches = 0
    hirschberg.launches = device.stream_finalized = 0
    _fill.update(dict.fromkeys(FILL_KEYS, 0))
    _band.update(dict.fromkeys(BAND_KEYS, 0))
    fill.reset_scores_cells()


def launch_counts() -> dict:
    """The engine-path kernels' launch counts since the last reset, the
    buckets whose device walk was finalized in the stream form, the fill
    counters (FILL_KEYS: the fill launches AlignmentEngine and Hirschberg
    made, as count_fill counts them), the band wavefront's (BAND_KEYS,
    as count_band counts them) and fill_band_scores_cells, the cells its
    kernel counted in its scores step (kernels/fill.py scores_cells: read
    from each card once, after synchronising it, so call this outside a
    timed window)."""
    banded, fill, stagger, device, hirschberg, walk_kernel = \
        _counter_modules()
    return {"stagger_fill": stagger.launches, "banded_fill": banded.launches,
            "rowscan_fill": fill.launches,
            "walk": walk_kernel.walk_launches,
            "compact": walk_kernel.compact_launches,
            "rowscan_last_rows": fill.last_rows_launches,
            "stagger_last_rows": stagger.last_rows_launches,
            "split_reduce": hirschberg.launches,
            "stream": device.stream_finalized,
            **_fill, **_band,
            "fill_band_scores_cells": fill.scores_cells()}
