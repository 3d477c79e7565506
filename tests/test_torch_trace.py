"""The port's tracing (tpu_align_torch/runtime/profiler.py) on the CPU:
phase names nested under their parents, totals over the top-level phases
alone, the recorded spans with their parent, batch and bucket inside the
realtime window the clock pair maps them to, Hirschberg's phases as spans
of the engine's timer, the CLI's -trace file, and the fill counters'
arithmetic on hand-made buckets.  The counters on the card are in
tests/test_torch_cuda.py."""

import json
import time

import numpy as np
import pytest

from tpu_align_torch import Algorithm, AlignmentParams
from tpu_align_torch.cli import main as cli_main
from tpu_align_torch.io import BucketSpec, PairDataset, bucketize
from tpu_align_torch.runtime import profiler
from tpu_align_torch.runtime.engine import AlignmentEngine
from tpu_align_torch.runtime.profiler import PhaseTimer
from tpu_align_torch.traceback import hirschberg as th

PARAMS = AlignmentParams()
SPEC = BucketSpec(batch_pairs=8)
TOP = {"memmgmt", "dispatch", "kernel", "backtrack", "printing"}


def _pairs(seed: int, n: int, lo: int, hi: int):
    rng = np.random.default_rng(seed)

    def seq():
        return "".join(rng.choice(list("ACGT"), int(rng.integers(lo, hi))))

    return [(seq(), seq()) for _ in range(n)]


@pytest.fixture(scope="module")
def ds():
    # a few buckets of 8 rows or fewer, and a pair with an empty side
    # (the oracle's)
    return PairDataset.from_pairs(_pairs(5, 20, 5, 70) + [("", "ACG")])


def _engine(**kw):
    return AlignmentEngine(Algorithm.LNW, PARAMS, bucket_spec=SPEC,
                           device="cpu", output="blocks", **kw)


def _check_nesting(spans):
    """A dotted span's parent is its name up to the last dot, and lies
    around it; a dotless span is a top-level phase."""
    for s in spans:
        if "." not in s.name:
            assert s.name in TOP and s.parent is None, s
            continue
        assert s.parent == s.name.rsplit(".", 1)[0], s
        assert any(p.name == s.parent and p.start_ns <= s.start_ns
                   and s.end_ns <= p.end_ns and p.bucket in (s.bucket, None)
                   for p in spans), s


@pytest.mark.parametrize("traceback,with_traceback,inner", [
    ("host", True, {"kernel.wait", "kernel.convert"}),
    ("host", False, {"kernel.wait", "kernel.convert"}),
    ("device", True, {"backtrack.wait"}),
], ids=["host", "scores-only", "device"])
def test_engine_spans_nest_and_share_their_bucket(ds, traceback,
                                                  with_traceback, inner):
    engine = _engine(traceback=traceback, with_traceback=with_traceback)
    n = len(engine._buckets_of(ds))
    timer = PhaseTimer(record=True)
    out = engine.run(ds, timer=timer)
    assert out.timer is timer and n > 2
    _check_nesting(timer.spans)
    names = {s.name for s in timer.spans}
    assert {"memmgmt.group", "memmgmt.gather", "dispatch.upload",
            "dispatch.enqueue", "printing.blocks",
            "printing.finalize"} | inner <= names
    if traceback == "device":
        assert not {"kernel", "kernel.wait"} & names
    else:
        assert "backtrack.wait" not in names
    # one gather a bucket, in order; every bucket's spans carry its id
    assert [s.bucket for s in timer.spans
            if s.name == "memmgmt.gather"] == list(range(n))
    for name in ("dispatch", "dispatch.upload", "printing.blocks") + tuple(
            inner):
        assert sorted(s.bucket for s in timer.spans if s.name == name) == \
            list(range(n)), name
    assert {s.bucket for s in timer.spans
            if s.name in ("memmgmt.group", "printing.finalize")} == {None}
    assert {s.batch for s in timer.spans} == {0}
    # the spans are the seconds, every name; the total the top level's
    for name in names:
        got = sum(s.end_ns - s.start_ns for s in timer.spans
                  if s.name == name)
        assert got / 1e9 == pytest.approx(timer.seconds[name])
    assert timer.total == pytest.approx(sum(timer.seconds[k] for k in TOP
                                            if k in timer.seconds))
    assert out.output_bytes() == engine.run(ds).output_bytes()


def test_total_and_report_take_the_top_level_alone():
    t = PhaseTimer()
    t.add("kernel", 1.0)
    t.add("kernel.wait", 0.75)
    t.add("printing.blocks", 0.25)
    t.add("printing", 0.5)
    t.add("backtrack.leaves", 0.125)
    with t.phase("memmgmt"), t.phase("memmgmt.gather"):
        pass
    assert t.total == pytest.approx(1.5 + t.seconds["memmgmt"])
    labels = [line.split(":")[0].strip() for line in t.report().splitlines()]
    assert labels == ["backtrack.leaves", "kernel", "kernel.wait", "memmgmt",
                      "memmgmt.gather", "printing", "printing.blocks",
                      "total"]
    top = [line.split(":")[0] for line in t.report(sub_spans=False)
           .splitlines()]
    assert top == [f"{name:>12}" for name in ("kernel", "memmgmt",
                                              "printing", "total")]
    # recording off: no spans kept, no clocks read
    assert t.spans is None and t.clocks is None
    with pytest.raises(ValueError, match="record"):
        profiler.chrome_trace(t, profiler.launch_counts())


def test_a_recording_lies_in_the_realtime_window_around_it(ds):
    r0 = time.time_ns()
    timer = PhaseTimer(record=True)
    for _ in range(2):
        _engine(traceback="device").run(ds, timer=timer)
    r1 = time.time_ns()
    clocks = timer.clocks
    assert set(clocks) == {"realtime", "monotonic"}
    assert r0 <= clocks["realtime"] <= r1
    shift = clocks["realtime"] - clocks["monotonic"]
    slack = 1_000_000  # the two clocks were read a few us apart
    for s in timer.spans:
        assert r0 - slack <= s.start_ns + shift <= s.end_ns + shift \
            <= r1 + slack, s
    assert {s.batch for s in timer.spans} == {0, 1}
    first = max(s.end_ns for s in timer.spans if s.batch == 0)
    assert all(s.start_ns >= first for s in timer.spans if s.batch == 1)


@pytest.mark.parametrize("algo", [Algorithm.LNW, Algorithm.LSW,
                                  Algorithm.ANW], ids=lambda a: a.value)
def test_hirschberg_phases_are_spans_of_the_engine(algo):
    # queries past leaf_q = 128 rows, so the pairs split before the leaves
    ds = PairDataset.from_pairs(_pairs(11, 2, 280, 330))
    engine = AlignmentEngine(algo, PARAMS, device="cpu", output="blocks",
                             traceback="hirschberg")
    timer = PhaseTimer(record=True)
    out = engine.run(ds, timer=timer)
    _check_nesting(timer.spans)
    names = {s.name for s in timer.spans}
    assert names == {"backtrack", "backtrack.fill", "backtrack.reduce",
                     "backtrack.leaves", "printing"} | (
        {"backtrack.endpoints"} if algo is Algorithm.LSW else set())
    assert out.output_bytes() == engine.run(ds).output_bytes()


def test_phase_seconds_are_the_timers_spans():
    timer = PhaseTimer()
    secs = {"fill": 1.0}
    th.hirschberg_align_batch(Algorithm.LSW, PARAMS,
                              _pairs(12, 2, 280, 330), device="cpu",
                              phase_seconds=secs, timer=timer)
    assert set(secs) == set(th.PHASES)
    for name in th.PHASES:
        assert secs[name] == pytest.approx(
            timer.seconds[f"backtrack.{name}"] + (name == "fill"))


def test_cli_trace_writes_spans_clocks_and_counters(tmp_path):
    pairs = tmp_path / "pairs.txt"
    pairs.write_text("".join(f"{k}\n{r}\n{q}\n" for k, (r, q) in
                             enumerate(_pairs(6, 12, 5, 60))))
    args = ["-pairs", str(pairs), "-device", "cpu", "-batch-pairs", "8"]
    trace = tmp_path / "trace.json"
    assert cli_main(args + ["-out", str(tmp_path / "a"),
                            "-trace", str(trace)]) == 0
    assert cli_main(args + ["-out", str(tmp_path / "b")]) == 0
    assert (tmp_path / "a").read_bytes() == (tmp_path / "b").read_bytes()
    got = json.loads(trace.read_text())
    other = got["otherData"]
    assert other["clock"] == "monotonic"
    assert set(other["clocks"]) == {"realtime", "monotonic"}
    spans = [e for e in got["traceEvents"] if e["ph"] == "X"]
    counters = [e for e in got["traceEvents"] if e["ph"] == "C"]
    assert {e["name"] for e in spans} >= {"memmgmt", "memmgmt.gather",
                                          "dispatch.enqueue", "kernel.wait"}
    assert all(set(e["args"]) == {"parent", "batch", "bucket"}
               for e in spans)
    assert min(e["ts"] for e in spans) >= other["clocks"]["monotonic"] / 1e3
    assert len(counters) == 1
    # the plain versions on the CPU launch no kernel
    assert counters[0]["args"] == other["counts"] == {
        k: 0 for k in profiler.launch_counts()}


def test_fill_work_of_a_hand_made_bucket():
    # two real pairs and two padding rows
    rlen, qlen = [250, 100, 0, 0], [240, 300, 0, 0]
    want = {"fill_counted": 1, "fill_pairs": 2,
            "fill_cells": 250 * 240 + 100 * 300,
            "fill_chain_cells": 250 * 240}
    assert profiler.fill_work("stagger", rlen, qlen) == {
        **want, "fill_warps": 2}
    # the band wavefront: ceil(240 / 128) + ceil(300 / 128) bands, or
    # ceil(240 / 256) + ceil(300 / 256) of 256 rows
    assert profiler.fill_work("rowscan", rlen, qlen, band_rows=128) == {
        **want, "fill_warps": 2 + 3}
    assert profiler.fill_work("rowscan", rlen, qlen, band_rows=256) == {
        **want, "fill_warps": 1 + 2}
    with pytest.raises(ValueError, match="band_rows"):
        profiler.fill_work("rowscan", rlen, qlen)
    # band 2 on 3 x 3: rows 1..3 keep columns 1-2, 1-3, 2-3
    assert profiler.fill_work("banded", [3, 0], [3, 0], band=2) == {
        "fill_counted": 1, "fill_pairs": 1, "fill_warps": 1,
        "fill_cells": 7, "fill_chain_cells": 7}
    with pytest.raises(ValueError, match="unknown fill kernel"):
        profiler.fill_work("walk", rlen, qlen)


def _steady_by_the_kernels_loop(rlen, qlen, band_rows):
    """The steady cells of one pair as csrc/rowscan_fill.cu's scores step
    sweeps it: each full band's chunks of 32 steps, the first a ramp, then
    steady chunks while every lane's column stays within rlen."""
    cells = 0
    for i0 in range(0, max(qlen, 0), band_rows):
        if i0 + band_rows > qlen:  # the partial bottom band: general step
            break
        t0 = 32  # chunk 0 is the ramp-in
        while t0 + 32 <= rlen:
            cells += 32 * band_rows
            t0 += 32
    return cells


@pytest.mark.parametrize("band_rows", [128, 256])
@pytest.mark.parametrize("rlen,qlen", [
    (0, 0), (5, 0), (0, 512),            # no cell
    (31, 128), (63, 256), (63, 1024),    # the ramps alone
    (64, 127), (64, 255),                # one partial bottom band
    (64, 128), (64, 256), (65, 300),     # one steady chunk a full band
    (16384, 16384), (16384, 16421),      # the benchmark's pairs
    (16415, 16347), (1000, 513),
])
def test_fill_band_steady_cells_from_lengths(rlen, qlen, band_rows):
    """steady_cells of one pair against the kernel's chunk loop counted
    by hand, and through count_fill of a scores launch (what the wrapper
    leaves in kernels/fill.py) to launch_counts."""
    from tpu_align_torch.kernels import fill

    want = _steady_by_the_kernels_loop(rlen, qlen, band_rows)
    assert profiler.steady_cells([rlen], [qlen], band_rows) == want
    assert want <= rlen * qlen
    profiler.reset_launch_counts()
    old = (fill.launch_band_rows, fill.launch_scores_step, fill.band_warps)
    try:
        fill.launch_band_rows, fill.launch_scores_step = band_rows, True
        fill.band_warps = 4
        profiler.count_fill("rowscan", [rlen, 0], [qlen, 0])
        counts = profiler.launch_counts()
        assert counts["fill_band_steady_cells"] == want
        assert counts["fill_warps"] == (-(-qlen // band_rows)
                                        if rlen * qlen else 0)
        # a launch whose bands all take the general step adds none
        fill.launch_scores_step = False
        profiler.count_fill("rowscan", [rlen], [qlen])
        assert profiler.launch_counts()["fill_band_steady_cells"] == want
    finally:
        fill.launch_band_rows, fill.launch_scores_step, fill.band_warps = old
        profiler.reset_launch_counts()


def test_fill_band_steady_cells_share_of_a_long_bucket():
    """On 16 kbp pairs whose queries end anywhere in their last band, the
    steady chunks of full bands hold over 99 % of the cells at 128-row
    bands, as the scores cells' pairs do."""
    rng = np.random.default_rng(5)
    rlen = rng.integers(16300, 16500, 1024)
    qlen = rng.integers(16300, 16500, 1024)
    share = profiler.steady_cells(rlen, qlen, 128) / int(rlen @ qlen)
    assert 0.99 < share < 1


@pytest.mark.parametrize("band_rows", [128, 256])
@pytest.mark.parametrize("rlen,qlen", [
    (0, 0), (5, 0), (0, 512), (31, 100),  # no full band, or no column
    (64, 127), (64, 255), (64, 256),      # at a band's edge
    (31, 128), (65, 300), (1000, 513),    # full bands and a partial one
    (16384, 16384), (16415, 16347),       # the benchmark's pairs
])
def test_fill_band_offset_cells_from_lengths(rlen, qlen, band_rows):
    """fill_band_offset_cells: the cells of each full band (rlen x
    band_rows, qlen // band_rows of them), counted by hand, through
    count_fill of an LNW scores launch in the gap-offset form; an ANW
    scores launch (the scores step, not the form) adds none, though it
    adds steady cells."""
    from tpu_align_torch.kernels import fill

    want = rlen * band_rows * (qlen // band_rows)
    assert profiler.full_band_cells([rlen], [qlen], band_rows) == want
    assert want <= rlen * qlen
    profiler.reset_launch_counts()
    old = (fill.launch_band_rows, fill.launch_scores_step,
           fill.launch_offset_form, fill.band_warps)
    try:
        fill.launch_band_rows, fill.band_warps = band_rows, 4
        fill.launch_scores_step = fill.launch_offset_form = True
        profiler.count_fill("rowscan", [rlen, 0, 7], [qlen, 9, 0])
        assert profiler.launch_counts()["fill_band_offset_cells"] == want
        fill.launch_offset_form = False  # as an ANW launch leaves it
        profiler.count_fill("rowscan", [rlen], [qlen])
        counts = profiler.launch_counts()
        assert counts["fill_band_offset_cells"] == want
        assert counts["fill_band_steady_cells"] == 2 * profiler.steady_cells(
            [rlen], [qlen], band_rows)
    finally:
        (fill.launch_band_rows, fill.launch_scores_step,
         fill.launch_offset_form, fill.band_warps) = old
        profiler.reset_launch_counts()
    assert profiler.launch_counts()["fill_band_offset_cells"] == 0


@pytest.mark.parametrize("algo,weights,m,n,fits", [
    # LNW: match and mismatch less 2 x gap in a signed byte
    (Algorithm.LNW, {}, 16384, 16384, True),                 # 7, 3
    (Algorithm.LNW, dict(match=120, gap=-10), 512, 512, False),  # 140
    (Algorithm.LNW, dict(mismatch=-150, gap=-20), 512, 512, True),  # -110
    (Algorithm.LNW, dict(mismatch=-133), 512, 512, False),    # -129
    (Algorithm.LNW, dict(gap=-62), 16384, 16384, True),       # 127, 123
    (Algorithm.LNW, dict(gap=-63), 16384, 16384, False),      # 129
    (Algorithm.LNW, dict(match=200, mismatch=100, gap=50), 64, 64, True),
    # and (m + n) x (the larger shifted weight's size + |gap|) in int32
    (Algorithm.LNW, dict(gap=-62), 5_681_173, 5_681_174, True),
    (Algorithm.LNW, dict(gap=-62), 5_681_174, 5_681_174, False),
    # every other aligner: match and mismatch as they are, at any size
    (Algorithm.ANW, dict(match=120, gap=-10), 512, 512, True),
    (Algorithm.ANW, dict(mismatch=-150), 512, 512, False),
    (Algorithm.ANW, dict(match=128), 512, 512, False),
    (Algorithm.LSW, dict(match=120, gap=-10), 2**30, 2**30, True),
    (Algorithm.LSW, dict(mismatch=-129), 512, 512, False),
    (Algorithm.BSW, dict(match=127, mismatch=-128, gap=-100), 512, 512,
     True),
], ids=lambda v: getattr(v, "value", None))
def test_profile_fits_by_aligner(algo, weights, m, n, fits):
    """profile_fits, the host's copy of the kernel's choice: LNW's scores
    step runs in the gap-offset form, so its weights are shifted by 2 x
    gap and its int32 guard reads the bucket's size; ANW, LSW and BSW test
    their weights unshifted, as before the form."""
    from tpu_align_torch.kernels import fill

    assert fill.profile_fits(algo, AlignmentParams(**weights), m, n) is fits


@pytest.mark.parametrize("lane_rows", [4, 8])
@pytest.mark.parametrize("m", [1, 127, 128, 129, 255, 256, 257, 16415])
def test_band_size_bookkeeping_agrees(m, lane_rows):
    """One band size for the launcher and the counters: a bucket of b
    problems of m rows has as many bands in fill_work, and in count_fill
    of a launch the wrapper made in that band size, as kernels/fill.py
    bands_of (the launcher's count) gives, at each rows-a-lane."""
    from tpu_align_torch.kernels import fill

    rows, b, n = 32 * lane_rows, 6, 300
    warps = profiler.fill_work("rowscan", [n] * b, [m] * b,
                               band_rows=rows)["fill_warps"]
    assert warps == b * fill.bands_of(m, rows) == b * -(-m // rows)
    profiler.reset_launch_counts()
    old = fill.launch_band_rows
    try:
        fill.launch_band_rows = rows
        profiler.count_fill("rowscan", [n] * b, [m] * b)
        assert profiler.launch_counts()["fill_warps"] == warps
    finally:
        fill.launch_band_rows = old
        profiler.reset_launch_counts()
    assert fill.bands_of(0, rows) == 1  # qlen 0: row 0, one band


@pytest.mark.parametrize("algo", list(Algorithm), ids=lambda a: a.value)
def test_band_rows_by_the_launch_shape(algo):
    """8 rows a lane (256-row bands) only for the scores instantiations
    built with them (the entry point's resident warps, -1 for a size not
    built: LNW and ANW have them), and only where a launch's 256-row
    bands are at least WIDE_BANDS_A_WARP a resident warp; 4 rows a lane
    otherwise, and always in the dirs and last-row modes."""
    from tpu_align_torch.kernels import fill

    wide = algo in (Algorithm.LNW, Algorithm.ANW)

    def resident(rows):
        assert rows == fill.WIDE_BAND_ROWS
        return 3168 if wide else -1

    full = fill.WIDE_BANDS_A_WARP * 3168 * 256  # rows of a full launch
    assert fill.band_rows(False, 1, full, resident) == fill.BAND_ROWS == 128
    assert fill.band_rows(True, 1, full, resident) == (256 if wide else 128)
    assert fill.band_rows(True, 64, full // 64, resident) == \
        (256 if wide else 128)
    assert fill.band_rows(True, 64, full // 64 - 256, resident) == 128
    assert fill.band_rows(True, 1, 16384, resident) == 128


def test_band_cells_against_counting_them():
    rng = np.random.default_rng(3)
    shapes = [(1, 1, 1), (5, 4, 1), (3, 3, 2), (7, 40, 3), (40, 7, 3),
              (12, 12, 30)] + [tuple(int(x) for x in rng.integers(1, 60, 3))
                               for _ in range(40)]
    for n, m, band in shapes:
        i = np.arange(1, m + 1)[:, None]
        j = np.arange(1, n + 1)[None, :]
        want = int(np.count_nonzero(np.abs(i - j) < band))
        assert profiler.band_cells([n], [m], band).tolist() == [want], (
            n, m, band)


def test_counters_add_up_over_buckets_and_reset():
    ds = PairDataset.from_pairs(_pairs(9, 30, 1, 300))
    buckets = bucketize(ds, BucketSpec(batch_pairs=8))
    assert len(buckets) > 3
    profiler.reset_launch_counts()
    for b in buckets:
        profiler.count_fill("stagger", b.ref_len, b.qry_len)
    got = profiler.launch_counts()
    real = [b.ref_len[:b.num_real].astype(np.int64) * b.qry_len[:b.num_real]
            for b in buckets]
    assert got["fill_counted"] == len(buckets)
    assert got["fill_pairs"] == got["fill_warps"] == len(ds)
    assert got["fill_cells"] == sum(b.real_cells for b in buckets) \
        == ds.num_cells
    assert got["fill_chain_cells"] == sum(int(c.max()) for c in real)
    profiler.reset_launch_counts()
    assert all(v == 0 for v in profiler.launch_counts().values())


def test_plain_versions_count_no_launch(ds):
    profiler.reset_launch_counts()
    _engine(traceback="device").run(ds)
    counts = profiler.launch_counts()
    del counts["stream"]  # finalized walks, launched or not
    assert all(v == 0 for v in counts.values()), counts


def test_scores_step_cells_are_counted_by_the_kernel_alone(monkeypatch):
    """fill_band_scores_cells is in launch_counts(): the sum of each
    device's count as the band wavefront's kernel leaves it, read once
    (after a synchronise of that device), and zeroed by
    reset_launch_counts; a run of the plain versions, which never count,
    leaves it 0, though LSW's scores-only buckets take the "rowscan"
    fill."""
    import torch

    from tpu_align_torch.kernels import fill

    profiler.reset_launch_counts()
    assert profiler.launch_counts()["fill_band_scores_cells"] == 0
    pairs = _pairs(12, 6, 300, 400)
    engine = AlignmentEngine(Algorithm.LSW, PARAMS, bucket_spec=SPEC,
                             device="cpu", output="blocks",
                             with_traceback=False, kernel="rowscan")
    calls = []
    real = fill.fill_bucket_async
    monkeypatch.setattr(fill, "fill_bucket_async",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    engine.run(PairDataset.from_pairs(pairs))
    assert calls
    assert profiler.launch_counts()["fill_band_scores_cells"] == 0
    # two devices' counts as a launch leaves them
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    counters = {torch.device("cuda", 0): torch.tensor([128 * 16_384]),
                torch.device("cuda", 1): torch.tensor([5])}
    monkeypatch.setattr(fill, "_scores_cells", counters)
    assert profiler.launch_counts()["fill_band_scores_cells"] == \
        128 * 16_384 + 5
    assert synced == list(counters)
    profiler.reset_launch_counts()
    assert all(int(c) == 0 for c in counters.values())
    assert profiler.launch_counts()["fill_band_scores_cells"] == 0
