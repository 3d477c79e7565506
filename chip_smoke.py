#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port: its main path on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py            # every phase below
    python3 chip_smoke.py --profile  # also profile the device-walk and
                                     # -kernel rowscan e2e runs

Phases (each raises on failure, so the script exits non-zero and never
prints its last line; copied alone, without tpu_align_torch beside it, the
script exits 1 before the first phase):
  1. card     -- require CUDA; print the card's name and power limit
  2. build    -- compile the sm_90a kernel library from csrc/ (one nvcc per
                 source, in parallel; timed) and, beside it, the port's
                 native host library from native/tpualign.cpp (g++)
  2a. dpx     -- the DPX op layer: all 36 functions on 2**20 random
                 triples through csrc/dpx_apply.cu, every value and
                 predicate equal to the plain version; timed
  2b. s16x2   -- the s16x2 experiment: `exp_s16x2.main()` (its JSON
                 lines), then both variants of csrc/s16x2_core.cu equal to
                 run_core_reference at 32 x 8192 and 32 x 131072 lanes and
                 4096 steps, and on whole-range int32 words (the halves
                 wrap); both widths timed
  3. kernel   -- the fill kernels against their plain PyTorch versions on
                 the card: the stagger fill for LNW, LSW and ANW at S=32
                 and S=16, and the banded fill (BSW) at bands 16, 3, 1, 20
                 and 32, dirs on and off, on synthetic 250-bp pairs,
                 tie-rich "AC" pairs, edge pairs and the main path's own
                 2048-pair buckets, and (stagger) a seam bucket: lengths
                 1, 4, 5, 31-33, 63-65, 127-129 and 257 on both sides, LSW
                 ties within a lane's rows and across a band seam, empty
                 sides, padding lanes; exact equality of scores, start
                 cells and every defined direction code; then the banded
                 fill at band 14,529 (K8 = 29,064: the lanes' slots in a
                 global scratch) on two long pairs with runs of 14,528
                 indels (`utils/synthetic.py` `wide_band_bucket`), dirs on
                 and off, each call's time printed
  4. walk     -- from those CUDA fills (LNW, LSW and ANW at S=32 and 16,
                 BSW at bands 16, 3, 1, 20 and 32), the walk and compaction
                 kernels against their plain versions on the same device
                 tensors, for the stagger walk also on the seam bucket and
                 the long-run bucket (257 bp against 1-8 bp both ways,
                 `utils/synthetic.py` `long_run_bucket`), for the banded
                 walk also on runs of up to 128 indels to the band's edge
                 slots (`band_run_pairs`) at those bands and at 64 (four
                 words a lane) and 129 (a 128-slot window that a run of
                 128 leaves), and at band 14,529 on the wide-band bucket,
                 whose runs take the window to both edges of the frame:
                 packed word for word, nev, the kept slots, flat, max_nev,
                 total; then
                 stream mode forced with ev_max=2 for each aligner,
                 replayed blocks equal to the oracle
  4a. pywalk  -- the main path's first 2048-pair 250-bp bucket, filled on
                 the card for LNW, LSW and ANW (S=32) and BSW (band 16),
                 through five traceback paths: the moves mode
                 (device_traceback_bucket) with the native and the Python
                 replay, the events path with the native replay, and the
                 host walk, native and NumPy (traceback_bucket); all five
                 AlignmentResults identical, the walk launched 3 times
                 and the compaction once an aligner (counts set to 0
                 before, read after); each path's wall printed beside
                 the card's name and power limit
  5. goldens  -- `tpu-align-torch -device cuda` reproduces goldens/lnw,
                 lsw, anw and bsw byte for byte, with -traceback host and
                 device, and lnw, lsw and anw with -kernel rowscan
  6. e2e      -- 100,000 pairs x 250 bp (seed 42) through AlignmentEngine
                 with the CLI defaults: LNW with host traceback (fill
                 launches == buckets) and LNW, ANW and BSW with device
                 traceback (fill, walk and compaction launches == buckets
                 each; buckets in stream mode); 500 sampled blocks equal
                 the oracle's in each; then LSW with device traceback on
                 20,000 pairs, 200 sampled blocks; then LNW through
                 -kernel rowscan with host traceback on the 100,000 pairs,
                 500 sampled blocks.  Phase reports, pairs/s, the LNW fill
                 sweep in GCUPS
  7. rowscan  -- the row-sweep fill (B2, a band wavefront in every mode)
                 against its plain version on the kernel phase's cases, on the
                 2048-pair 250-bp bucket with a qlen = 1 and a qlen = M lane,
                 and on the wavefront's seam bucket (qlen 1, 127-129, 255-257 x
                 rlen 1, 31-33, 65, planted LSW and BSW ties in and across
                 bands 0 and 1, empty sides, an empty reference under three
                 bands; `utils/synthetic.py` `rowscan_seam_bucket`): LNW, LSW,
                 ANW and BSW, dirs on and off; LSW's two end-point fills at
                 phase 8's 64 x 16,384^2 (128 bands a pair; the forward fill,
                 then the reversed prefixes up to each end cell, as Hirschberg
                 makes them), scores and start cells; its last rows (the band
                 wavefront; LNW, ANW with open_top all gap_open, all 0 and
                 mixed) and the stagger fill's last-row variant against the
                 plain version and each other, there, at the wavefront's row
                 seams (qlen 1, 127-129, 4,095, 8,192 at N = 8, 4,096, 16,384),
                 on 128 problems of mixed lengths, and at the top split levels
                 of a 16,384 x 4,096 pair (2 x 8,192 x 4,096), of the 64 pairs
                 (128 x 8,192 x 16,384) and of the long pair (2 x 65,536 x
                 16,384) of phase 8; the split reduction against its plain
                 version, also on the shapes its grid splits differently
                 (`utils/synthetic.py` `SPLIT_REDUCE_SHAPES`: one
                 subproblem, K no multiple of 32, a part-full last chunk,
                 maxima tied across chunks, widths past the rows); exact
                 everywhere
  8. hirsch   -- Hirschberg on the card byte-identical to the same call on
                 CPU (the plain versions) for 8 pairs of 1-2 kbp, LNW, LSW
                 and ANW, and with the stagger last rows for LNW and ANW;
                 then the full-width runs, scripts/bench_long.py's
                 generator (seed 42): LNW 131,072 x 16,384, and LNW, ANW
                 and LSW at 64 x (16,384 x 16,384).  Each rescore equals
                 the row-sweep kernel's whole-pair score, and the lines
                 give back the sequences.  Wall, GCUPS-effective, phases
                 (LSW's end points, two row-sweep fills, on a line of
                 their own).  Then the LNW 64 x 16,384^2 run once more,
                 the split reduction's arguments captured at each of its
                 7 levels and each level's output held against the plain
                 version
  9. timing   -- kernels beside their plain versions, in turns (plain,
                 kernel, kernel, plain), CUDA events: the LNW fill on one
                 256-pair and one 2048-pair bucket at 250 bp; the LSW, ANW
                 and banded fills, the three stagger fills scores-only,
                 the LNW, LSW, affine and banded walks and the
                 compaction on the 2048-pair bucket, these also by
                 torch.profiler (device time, with the longest lane's
                 moves and the ns a move; the banded walk also at band
                 20); the row-sweep fill of each aligner there, dirs on,
                 and LNW's and LSW's scores-only, also by torch.profiler;
                 LNW's and ANW's scores-only fills on WIDE_SCORES problems
                 (4,000-4,096 x 3,996-4,000 bp, partial bottom bands), a
                 shape whose launch takes 256-row bands on its own: the
                 band size asserted, scores equal to the plain version's,
                 device time by torch.profiler and the bound;
                 LSW's scores-only fill at the end points' shape of phase
                 8 (64 x 16,384 x 16,384); both last-row fills at the
                 split-level shape, and the row sweep's (the band
                 wavefront's) device time by torch.profiler at the three
                 top split levels of phase 7; the banded fill's device
                 time by torch.profiler, dirs on and off, and at band
                 14,529; the split reduction at the 64-pair top level (64
                 subproblems, 16,384 columns), its device time by
                 torch.profiler there and at each level captured in phase
                 8; each DPX function's device time, its calls rotating
                 through 16 argument sets past the card's L2, and the DPX
                 wrapper's host cost a call
  10. profile -- the BSW e2e run of phase 6 once more under
                 torch.profiler (with --profile, each device-traceback
                 run and the -kernel rowscan run): device time by kernel,
                 device busy time and the idle share of the run's wall;
                 last of the timed phases, since later profiler sessions
                 drop records
  11. parity  -- `tpu_align_torch.scripts.hw_parity` on the card:
                 PARITY_PAIRS mixed-length pairs (20-250 bp, seed 7) in
                 its wide buckets, all 14 configurations, each one's full
                 text equal to the oracle's and its fill (and device walk
                 and compaction) launched once a bucket; then goldens/
                 lnw-all and lsw-all through `-all-paths -device cuda`
  12. fuzz    -- fixed seed ranges of `scripts.fuzz_engine` (all four
                 aligners, host and device traceback, -kernel rowscan;
                 against the scalar oracle) and `scripts.fuzz_sweep`
                 (every fill, walk and compaction against its plain
                 version, the strings against the oracle, each block
                 re-scored), the seeds covered printed
  13. mesh    -- the engine on a `pairs` mesh (distributed/), each after
                 warmup: LNW with device traceback on the 100,000 pairs
                 over every visible card and over 2 shards of cuda:0,
                 each byte-identical to the one-device run, the 2-shard
                 run with 2 x buckets launches of the stagger fill, the
                 walk and the compaction; ANW and BSW with device
                 traceback and LNW with host traceback (the stagger fill
                 and -kernel rowscan) on 2 shards of the first MESH_PAIRS
                 pairs, the same; global_stats against
                 numpy; then two processes through a gloo rendezvous
                 (multihost: initialize, host_shard, renumber, a file
                 each, global_stats across them), merged and equal to the
                 one-process text.  Walls printed
Every timing line gives the kernel's bound (the larger of its bytes over
the card's HBM rate and its integer operations over its int32 rate) and,
where one PyTorch call computes the same function, that call's time.  The
line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import functools
import json
import os
import random
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
TIMING_REPS = 20
PLAIN_REPS = 2
E2E_PAIRS = 100_000  # LNW host and device, ANW and BSW device traceback
LSW_E2E_PAIRS = 20_000  # LSW, device traceback
# 16: the CLI default, K8 == 2*band, a slot a lane; 3: K8 > 2*band; 20:
# K8 = 40, two slots a lane
BANDS = (16, 3, 1, 20, 32)
# the banded walk's widest layouts: four words a lane (K8 = 128) and, past
# it, a 128-slot window that moves with the cursor (K8 = 264)
WIDE_WALK_BANDS = (64, 129)
# the banded fill past one warp's shared memory (K8 = 29,064): the lanes'
# slots in a global scratch; on two long pairs with runs of band - 1 indels
WIDE_BAND = 14529
# pairs and query length of the scores-only fills that a launch of their
# own puts in 256-row bands (kernels/fill.py band_rows): the crossover
# grid's LNW 4,000 bp x 1,024 pairs, 16 wide bands a pair
WIDE_SCORES = (1024, 4000)
HIRSCH_CHECK = (8, 1000, 2000)  # pairs, shortest and longest reference
SPLIT_LEVEL = (16384, 4096)  # query x reference of the split-shape pair
# qlen of the last-row problems at the band wavefront's row seams (bands of
# 128 rows) and at Hirschberg's depths, and the widths they run at
LAST_ROW_SEAMS = (1, 127, 128, 129, 4095, 8192)
LAST_ROW_WIDTHS = (8, 4096, 16384)
# full-width Hirschberg runs: (algorithm, pairs, query, reference)
LONG_RUNS = (("lnw", 1, 131072, 16384), ("lnw", 64, 16384, 16384),
             ("anw", 64, 16384, 16384), ("lsw", 64, 16384, 16384))
DPX_N = 1 << 20  # triples through each DPX function
# hw_parity's mixed-length set (20-250 bp, seed 7; its oracle about 1.4
# ms a pair on the card host's 8 CPUs) and the fuzzers' seed ranges (about
# 2 s a seed each there), each phase sized to under a minute
PARITY_PAIRS = 16384
FUZZ_ENGINE_SEEDS = (5000, 5025)
FUZZ_SWEEP_SEEDS = (100, 130)
# the mesh phase's side runs (ANW and BSW device, LNW host traceback, and
# the two-process run): the first MESH_PAIRS pairs of the main path's set
MESH_PAIRS = 16384
# argument sets the DPX device times rotate through, one rotation across
# all the functions: 16 x 3 x 4 MB, four times the card's 50 MB L2, so a
# call's inputs are the sets least recently read and come from HBM, and
# no function starts on the sets the one before it left in L2
DPX_SETS = 16
# Bounds: the least time the card could take, on the published peaks of
# an H100 SXM (NVIDIA's data sheet, Hopper white paper): 3.35 TB/s of HBM;
# 132 SMs x 64 int32 lanes x 1.98 GHz boost = 16.7 T int32 (or DPX)
# lane-operations a second.
HBM_BYTES_S = 3.35e12
INT_OPS_S = 132 * 64 * 1.98e9
# the fewest integer lane-operations a DP cell takes, a fused DPX add-max
# counted as one: the substitution weight, two gap add-maxes and the
# direction code (LNW); LSW and BSW clamp at 0 as well; ANW adds E's and
# F's add-max and a max.  Scores-only fills write no direction code.
CELL_OPS = {"lnw": 4, "lsw": 5, "bsw": 5, "anw": 7}


def _say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def _smi() -> str:
    """The first card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def phase_card():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs a CUDA card")
    smi = _smi()
    name = torch.cuda.get_device_name(0)
    _say("card", f"torch {torch.__version__} cuda {torch.version.cuda}; "
         f"device 0: {name}; {torch.cuda.device_count()} visible")
    print(smi, flush=True)
    return name


def phase_build():
    """The kernel library (one nvcc per source, all started together) and,
    beside it in a thread, the port's native host library (g++)."""
    from concurrent.futures import ThreadPoolExecutor

    from tpu_align_torch import native
    from tpu_align_torch.kernels import _build
    from tpu_align_torch.native import binding

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    with ThreadPoolExecutor(1) as pool:
        host = pool.submit(timed, lambda: native.require("chip_smoke"))
        secs = timed(_build.library)
        host_secs = host.result()
    so = _build.library_path()
    _say("build", f"{so.relative_to(REPO)} loaded in {secs:.2f} s")
    log = so.parent / "nvcc.log"
    if log.exists():  # absent when an earlier run built this hash
        for line in log.read_text().splitlines():
            _say("build", line)
    _say("build", f"{binding.library_path().relative_to(REPO)} (native host "
         f"library, g++) loaded in {host_secs:.2f} s")


def _compare(got, want, num_real: int, label: str, codes) -> int:
    """Exact comparison of a kernel fill with the plain version's on the
    real rows; codes(dirs, lo, hi) decodes the defined cells of pairs
    lo..hi.  Returns the largest absolute difference (0)."""
    import torch

    err = 0
    for name, g, w in zip(("scores", "srow", "scol"), got[:3], want[:3]):
        d = (g[:num_real].long() - w[:num_real].long()).abs().max().item()
        err = max(err, d)
        if d:
            raise AssertionError(f"{label}: {name} differs by up to {d}")
    if (got[3] is None) != (want[3] is None):
        raise AssertionError(f"{label}: dirs present on one side only")
    if got[3] is not None:
        if got[3].shape != want[3].shape:
            raise AssertionError(f"{label}: dirs shape {tuple(got[3].shape)}"
                                 f" != {tuple(want[3].shape)}")
        for lo in range(0, num_real, 256):
            hi = min(lo + 256, num_real)
            cg, cw = codes(got[3], lo, hi), codes(want[3], lo, hi)
            d = (cg - cw).abs().max().item()
            err = max(err, d)
            if not torch.equal(cg, cw):
                raise AssertionError(f"{label}: dirs differ at a defined "
                                     f"cell (pairs {lo}..{hi})")
    return err


def _check_cases(main_buckets):
    """(label, buckets) of the kernel and walk phases."""
    from tpu_align_torch.io import BucketSpec, PairDataset, bucketize
    from tpu_align_torch.utils.synthetic import synthetic_dataset

    edge = PairDataset.from_pairs([
        ("A", "A"), ("A", "T"), ("AAAA", "TTTT"), ("ACGTACGTACGT", "ACG"),
        ("ACG", "ACGTACGTACGT"), ("A" * 129, "A" * 70),
        ("ACGT" * 12, "ACGT" * 12),
    ])
    spec = BucketSpec(batch_pairs=256)
    return [
        ("synthetic-250bp",
         bucketize(synthetic_dataset(256, uniform_len=250, seed=42), spec)),
        ("tie-rich-AC",
         bucketize(synthetic_dataset(64, min_len=2, max_len=70, seed=7,
                                     alphabet="AC"), spec)),
        ("edge", bucketize(edge, spec)),
        ("main-path", [main_buckets[0], main_buckets[-1]]),
    ]


def _variants():
    """(algorithm, params, layout) of every fill: the stagger fill of LNW,
    LSW and ANW at S = 32 and 16, the banded fill of BSW at each band."""
    from tpu_align_torch import Algorithm, AlignmentParams

    out = [(a, AlignmentParams(), {"stripe_s": s})
           for a in (Algorithm.LNW, Algorithm.LSW, Algorithm.ANW)
           for s in (32, 16)]
    out += [(Algorithm.BSW, AlignmentParams(band=band), {"band": band})
            for band in BANDS]
    return out


def _fill(algo, params, tensors, layout, plain=False, with_traceback=True):
    """The fill kernel (or its plain version) of an algorithm on its
    layout."""
    from tpu_align_torch.kernels import banded as tb
    from tpu_align_torch.kernels import stagger as ts

    if algo.is_banded:
        fn = tb.fill_banded_reference if plain else tb.fill_banded_bucket_async
        return fn(algo, params, *tensors, with_traceback=with_traceback)
    fn = ts.fill_stagger_reference if plain else ts.fill_stagger_bucket_async
    return fn(algo, params, *tensors, with_traceback=with_traceback,
              stripe_s=layout["stripe_s"])


def _layout_label(layout) -> str:
    return (f"S={layout['stripe_s']}" if "stripe_s" in layout
            else f"band={layout['band']}")


def phase_kernel(cases):
    """Returns {(algorithm, layout label): largest difference (0)}."""
    import torch

    from tpu_align_torch import Algorithm
    from tpu_align_torch.convert import bucket_to_tensors
    from tpu_align_torch.kernels import banded as tb
    from tpu_align_torch.kernels import stagger as ts
    from tpu_align_torch.utils.synthetic import seam_bucket

    errs = {}
    for algo, params, layout in _variants():
        if algo.is_banded:
            def codes(d, lo, hi, rl=None, ql=None, band=params.band):
                return tb.defined_codes(d[:, lo:hi], rl[lo:hi], ql[lo:hi],
                                        band)
        else:
            def codes(d, lo, hi, rl=None, ql=None, algo=algo):
                return ts.defined_codes(algo, d[..., lo:hi], rl[lo:hi],
                                        ql[lo:hi])
        err = 0
        items = [(label, k, b, bucket_to_tensors(b, DEVICE))
                 for label, buckets in cases for k, b in enumerate(buckets)]
        if not algo.is_banded:
            items.append(("seams", 0, *seam_bucket(DEVICE)))
        for label, k, b, tensors in items:
            for tb_on in (True, False):
                got = _fill(algo, params, tensors, layout,
                            with_traceback=tb_on)
                want = _fill(algo, params, tensors, layout, plain=True,
                             with_traceback=tb_on)
                torch.cuda.synchronize()
                name = (f"{algo.value} {label} bucket {k} "
                        f"({b.batch}x{b.padded_qry}x{b.padded_ref}) "
                        f"{_layout_label(layout)} "
                        f"dirs={'on' if tb_on else 'off'}")
                err = max(err, _compare(
                    got, want, b.num_real, name,
                    lambda d, lo, hi: codes(d, lo, hi, tensors[2],
                                            tensors[3])))
                _say("kernel", f"{name}: exact")
        errs[(algo, _layout_label(layout))] = err
    errs[(Algorithm.BSW, f"band={WIDE_BAND}")] = _check_wide_band()
    return errs


def _check_wide_band() -> int:
    """The banded fill at WIDE_BAND on wide_band_bucket's two long pairs,
    dirs on and off, against the plain version (every valid cell, the
    dirs decoded 16 word rows at a time), each call's wall time printed.
    Returns the largest difference (0)."""
    import torch

    from tpu_align_torch import Algorithm, AlignmentParams
    from tpu_align_torch.kernels import banded as tb
    from tpu_align_torch.utils.synthetic import wide_band_bucket

    params = AlignmentParams(band=WIDE_BAND)
    b, t = wide_band_bucket(WIDE_BAND, DEVICE)
    nr = b.num_real
    err = 0
    for tb_on in (True, False):
        secs = []
        outs = []
        for fn in (tb.fill_banded_bucket_async, tb.fill_banded_reference):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(fn(Algorithm.BSW, params, *t, with_traceback=tb_on))
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        got, want = outs
        name = (f"bsw wide-band bucket ({b.batch}x{b.padded_qry}x"
                f"{b.padded_ref}, qlen {b.qry_len[:nr].tolist()}) "
                f"band={WIDE_BAND} (K8 {tb.frame_width(WIDE_BAND)}, slots "
                f"in the global scratch) dirs={'on' if tb_on else 'off'}")
        err = max(err, _compare((*got[:3], None), (*want[:3], None), nr,
                                name, None))
        if (got[3] is None) != (want[3] is None):
            raise AssertionError(f"{name}: dirs present on one side only")
        if got[3] is not None:
            lens = (t[2][:nr], t[3][:nr], WIDE_BAND)
            for w0 in range(0, got[3].shape[0], 16):
                cg, cw = (tb.defined_codes(d[w0:w0 + 16, :nr], *lens,
                                           first_word=w0)
                          for d in (got[3], want[3]))
                if not torch.equal(cg, cw):
                    raise AssertionError(f"{name}: dirs differ at a defined "
                                         f"cell (word rows {w0}..)")
        _say("kernel", f"{name}: exact (scores {got[0][:nr].tolist()}); "
             f"kernel {secs[0]:.3f} s, plain {secs[1]:.3f} s")
    return err


def _walk_diff(got, want, got_c, want_c, label: str) -> int:
    """Exact comparison of the walk and compaction kernels' outputs with
    the plain versions'; returns the largest absolute difference (0)."""
    import torch

    err = 0
    ev_max = want[1].shape[0]
    kept = (torch.arange(ev_max, device=want[2].device)[:, None]
            < want[2][None, :])  # slots below min(nev, ev_max)
    for name, g, w in (("packed", got[0], want[0]), ("nev", got[2], want[2]),
                       ("slots", got[1].to(torch.int32)[kept],
                        want[1].to(torch.int32)[kept]),
                       ("flat", got_c[0], want_c[0]),
                       ("max_nev", got_c[2], want_c[2]),
                       ("total", got_c[3], want_c[3])):
        if g.shape != w.shape:
            raise AssertionError(f"{label}: {name} shape {tuple(g.shape)} "
                                 f"!= {tuple(w.shape)}")
        g64, w64 = g.to(torch.int64), w.to(torch.int64)
        d = (g64 - w64).abs().max().item() if g.numel() else 0
        err = max(err, d)
        if not torch.equal(g64, w64):
            raise AssertionError(f"{label}: {name} differs by up to {d}")
    return err


def phase_walk(cases):
    """Returns {algorithm: largest difference (0)} of the walk and the
    compaction on that algorithm's fills."""
    import torch

    from tpu_align_torch import Algorithm, AlignmentParams
    from tpu_align_torch.io import BucketSpec, PairDataset, bucketize
    from tpu_align_torch.oracle.api import align_pair
    from tpu_align_torch.utils.synthetic import (
        band_run_pairs,
        long_run_bucket,
        seam_bucket,
        synthetic_dataset,
        wide_band_bucket,
    )
    from tpu_align_torch.convert import bucket_to_tensors
    from tpu_align_torch.kernels import banded as tb
    from tpu_align_torch.kernels import stagger as ts
    from tpu_align_torch.traceback import device as td
    from tpu_align_torch.traceback import walk_kernel as wk

    pairs = (band_run_pairs(runs=(2, 19, 31, 63, 128))
             + band_run_pairs(runs=(63, 128), flanks=(150, 150)))
    (runs,) = bucketize(PairDataset.from_pairs(pairs),
                        BucketSpec(batch_pairs=len(pairs), query_multiple=512,
                                   ref_multiple=512))
    wide = [(Algorithm.BSW, AlignmentParams(band=band), {"band": band})
            for band in WIDE_WALK_BANDS]
    errs = {a: 0 for a in Algorithm}
    for algo, params, layout in _variants() + wide:
        s = layout.get("stripe_s", ts.STRIPE_S)
        items = ([] if layout.get("band") in WIDE_WALK_BANDS else
                 [(label, k, b, bucket_to_tensors(b, DEVICE))
                  for label, buckets in cases
                  for k, b in enumerate(buckets)])
        if algo.is_banded:
            items.append(("band-runs", 0, runs,
                          bucket_to_tensors(runs, DEVICE)))
        else:
            items += [("seams", 0, *seam_bucket(DEVICE)),
                      ("long-runs", 0, *long_run_bucket(DEVICE))]
        for label, k, b, tensors in items:
            sc, sr, sj, dirs = _fill(algo, params, tensors, layout)
            got = wk.device_walk(algo, params, dirs, sr, sj, sc, s)
            got_c = wk.compact_events(got[1], got[2])
            want = td.device_walk_reference(algo, params, dirs, sr, sj, sc, s)
            want_c = td.compact_events_reference(want[1], want[2])
            torch.cuda.synchronize()
            name = (f"{algo.value} {label} bucket {k} "
                    f"({b.batch}x{b.padded_qry}x{b.padded_ref}) "
                    f"{_layout_label(layout)}")
            errs[algo] = max(errs[algo], _walk_diff(got, want, got_c,
                                                    want_c, name))
            _say("walk", f"{name}: exact (max_nev {int(got_c[2])}, "
                 f"total {int(got_c[3])} of {got_c[0].numel()} slots)")
    # the wide band: runs of WIDE_BAND - 1 indels take the cursor's window
    # to both edges of a 29,064-slot frame
    params = AlignmentParams(band=WIDE_BAND)
    b, t = wide_band_bucket(WIDE_BAND, DEVICE)
    sc, sr, sj, dirs = tb.fill_banded_bucket_async(Algorithm.BSW, params,
                                                   *t)
    got = wk.device_walk(Algorithm.BSW, params, dirs, sr, sj, sc, 32)
    got_c = wk.compact_events(got[1], got[2])
    want = td.device_walk_reference(Algorithm.BSW, params, dirs, sr, sj, sc,
                                    32)
    want_c = td.compact_events_reference(want[1], want[2])
    torch.cuda.synchronize()
    name = (f"bsw wide-band bucket ({b.batch}x{b.padded_qry}x"
            f"{b.padded_ref}) band={WIDE_BAND}")
    errs[Algorithm.BSW] = max(errs[Algorithm.BSW],
                              _walk_diff(got, want, got_c, want_c, name))
    _say("walk", f"{name}: exact (longest lane "
         f"{int(td.lane_moves(got[0]).max())} moves)")
    # stream mode forced through the wrapper: every lane of these mutated
    # copies has more than 2 indels, so ev_max=2 overflows and the packed
    # moves replay
    (b,) = bucketize(synthetic_dataset(32, uniform_len=120, seed=11,
                                       indel_rate=0.05),
                     BucketSpec(batch_pairs=32))
    for algo, params, layout in _variants():
        if layout not in ({"stripe_s": ts.STRIPE_S}, {"band": 16}):
            continue
        sc, sr, sj, dirs = _fill(algo, params, bucket_to_tensors(b, DEVICE),
                                 layout)
        fin = td.finalize_any(td.device_walk_dispatch_events(
            algo, params, dirs, sr, sj, sc, ts.STRIPE_S,
            extras=(sc, sr, sj), ev_max=2))
        if fin[0] != "stream":
            raise AssertionError(f"{algo.value}: ev_max=2 gave {fin[0]} "
                                 "mode")
        _, out_buf, out_lens = td.bucket_arrays_from_finalized(
            algo, b, params, fin)
        for row in range(b.num_real):
            want = align_pair(algo, params,
                              b.ref_tokens[row, :b.ref_len[row]].tobytes()
                              .decode(),
                              b.qry_tokens[row, :b.qry_len[row]].tobytes()
                              .decode())
            n = int(out_lens[row])
            lines = tuple(out_buf[row, x, :n].tobytes().decode()
                          for x in range(3))
            if (int(fin[3][row]), lines) != (want.score, (
                    want.ref_aligned, want.relation, want.query_aligned)):
                raise AssertionError(f"{algo.value} stream mode: row {row} "
                                     "differs from the oracle")
        _say("walk", f"{algo.value}: ev_max=2 takes stream mode; "
             f"{b.num_real} replayed alignments equal the oracle")
    return errs


def _same_results(got, want, label: str) -> None:
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} results, want "
                             f"{len(want)}")
    for g, w in zip(got, want):
        if (g.pair_num, g.score, g.ref_aligned, g.relation,
                g.query_aligned) != (w.pair_num, w.score, w.ref_aligned,
                                     w.relation, w.query_aligned):
            raise AssertionError(f"{label}: pair {w.pair_num} differs")


def phase_pywalk(main_buckets) -> dict:
    """One full 2048-pair bucket of the main path's workload through each
    traceback path from one card fill: the moves mode with the native and
    the Python replay (device_traceback_bucket), the events path
    (device_walk_dispatch_events, finalize_any, the native replay), and
    the host walk, native and NumPy (traceback_bucket), for LNW, LSW and
    ANW (stagger, S = 32) and BSW (banded, band 16).  The five give
    identical AlignmentResults; the walk and compaction launch counts of
    each aligner's run are set to 0 just before it and read just after.
    Returns {algorithm: launch counts}."""
    import torch

    from tpu_align_torch import Algorithm, AlignmentParams
    from tpu_align_torch.convert import bucket_to_tensors, fill_to_numpy
    from tpu_align_torch.core.result import results_from_arrays
    from tpu_align_torch.kernels import stagger as ts
    from tpu_align_torch.traceback import device as td
    from tpu_align_torch.traceback.host import traceback_bucket

    b = main_buckets[0]
    if b.num_real != 2048:
        raise AssertionError(f"the first bucket holds {b.num_real} pairs")
    smi = _smi()
    out = {}
    for algo in Algorithm:
        if algo.is_banded:
            params, layout = AlignmentParams(band=16), {"band": 16}
        else:
            params, layout = AlignmentParams(), {"stripe_s": ts.STRIPE_S}
        sc, sr, sj, dirs = _fill(algo, params, bucket_to_tensors(b, DEVICE),
                                 layout)
        fill = fill_to_numpy(sc, sr, sj, dirs, **layout)
        s = ts.STRIPE_S

        def events_path():
            fin = td.finalize_any(td.device_walk_dispatch_events(
                algo, params, dirs, sr, sj, sc, s, extras=(sc, sr, sj)))
            arrays = td.bucket_arrays_from_finalized(algo, b, params, fin)
            return results_from_arrays(b.pair_ids, *arrays, b.num_real)

        paths = {
            "moves, native replay": lambda: td.device_traceback_bucket(
                algo, b, sc, sr, sj, dirs, params, s),
            "moves, Python replay": lambda: td.device_traceback_bucket(
                algo, b, sc, sr, sj, dirs, params, s, use_native=False),
            "events, native replay": events_path,
            "host walk, native": lambda: traceback_bucket(algo, b, fill,
                                                          params),
            "host walk, NumPy": lambda: traceback_bucket(
                algo, b, fill, params, use_native=False),
        }
        torch.cuda.synchronize()
        _reset_counts()
        results, walls = {}, {}
        for name, fn in paths.items():
            t0 = time.perf_counter()
            results[name] = fn()
            walls[name] = time.perf_counter() - t0
        counts = _counts()
        label = (f"{algo.value} {b.batch}x{b.padded_qry}x{b.padded_ref} "
                 f"{_layout_label(layout)}")
        want = results["host walk, native"]
        if len(want) != b.num_real:
            raise AssertionError(f"{label}: {len(want)} results")
        for name, got in results.items():
            _same_results(got, want, f"{label} {name}")
        # three walks (two moves, one events) and one compaction
        if (counts["walk"], counts["compact"]) != (3, 1):
            raise AssertionError(f"{label}: walk launches {counts['walk']},"
                                 f" compaction {counts['compact']}")
        for name, wall in walls.items():
            _say("pywalk", f"{label} {name}: {wall:.4f} s ({smi})")
        _say("pywalk", f"{label}: the five paths identical over "
             f"{len(want)} pairs; walk launches {counts['walk']}, "
             f"compaction {counts['compact']}")
        out[algo] = counts
    return out


def _cli_golden(phase: str, tree: str, algo: str, extra) -> None:
    """`tpu-align-torch -device DEVICE` over goldens/<tree> must print its
    align-output.txt byte for byte."""
    from tpu_align_torch.cli import main as cli_main

    d = os.path.join(REPO, "goldens", tree)
    with open(os.path.join(d, "align-output.txt"), "rb") as f:
        want = f.read()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out.txt")
        rc = cli_main(["-pairs", os.path.join(d, "input-data.txt"),
                       "-algorithm", algo, *extra,
                       "-device", DEVICE, "-out", out])
        if rc != 0:
            raise RuntimeError(f"tpu_align_torch.cli exited {rc}")
        with open(out, "rb") as f:
            got = f.read()
    label = f"goldens/{tree} {' '.join(extra)}"
    if got != want:
        raise AssertionError(f"{label}: output differs from "
                             "align-output.txt")
    _say(phase, f"{label} byte-identical ({len(got)} bytes)")


def phase_goldens():
    for algo in ("lnw", "lsw", "anw", "bsw"):
        flags = [["-traceback", "host"], ["-traceback", "device"]]
        if algo != "bsw":
            flags.append(["-traceback", "host", "-kernel", "rowscan"])
        for extra in flags:
            _cli_golden("goldens", algo, algo, extra)


def phase_parity() -> dict:
    """hw_parity's 14 configurations over PARITY_PAIRS mixed-length pairs,
    full text against the oracle, each through its kernels; then the
    all-paths goldens through the CLI on the card."""
    from tpu_align_torch.scripts import hw_parity

    t0 = time.perf_counter()
    rec = hw_parity.run(PARITY_PAIRS, device=DEVICE,
                        log=lambda s: _say("parity", s))
    secs = time.perf_counter() - t0
    bad = [r for r in rec["configs"] if not r["ok"]]
    if bad:
        raise AssertionError(f"parity: {len(bad)} of {len(rec['configs'])} "
                             "configurations differ from the oracle")
    _say("parity", f"{PARITY_PAIRS} mixed-length pairs in "
         f"{len(rec['buckets'])} buckets, {len(rec['configs'])} "
         f"configurations: full text equal to the oracle in {secs:.1f} s "
         f"(oracle {rec['oracle']['wall_s']:.1f} s)")
    for tree, algo in (("lnw-all", "lnw"), ("lsw-all", "lsw")):
        _cli_golden("parity", tree, algo, ["-all-paths"])
    return rec


def phase_fuzz() -> None:
    """Fixed seed ranges of the engine and kernel fuzzers on the card."""
    from tpu_align_torch.scripts import fuzz_engine, fuzz_sweep

    for mod, seeds in ((fuzz_engine, FUZZ_ENGINE_SEEDS),
                       (fuzz_sweep, FUZZ_SWEEP_SEEDS)):
        rec = mod.run(seeds, DEVICE, log=lambda s: _say("fuzz", s))
        if not rec["ok"]:
            raise AssertionError(f"fuzz: {len(rec['failures'])} failures in "
                                 f"seeds {seeds[0]}..{seeds[1] - 1}")
        _say("fuzz", f"{mod.__name__.rsplit('.', 1)[1]}: seeds "
             f"{seeds[0]}..{seeds[1] - 1} covered, no mismatch "
             f"({rec['seconds']:.1f} s)")


def _kernel_sweep_ms(buckets, params) -> float:
    """All buckets' fills back to back (dirs on), timed with CUDA events."""
    import torch

    from tpu_align_torch import Algorithm
    from tpu_align_torch.convert import bucket_to_tensors
    from tpu_align_torch.kernels.stagger import fill_stagger_bucket_async

    staged = [bucket_to_tensors(b, DEVICE) for b in buckets]
    for t in staged[:2]:  # warm-up
        fill_stagger_bucket_async(Algorithm.LNW, params, *t)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    for t in staged:
        fill_stagger_bucket_async(Algorithm.LNW, params, *t)
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _check_blocks(out, ds, algo, params, samples: int, label: str) -> None:
    """Output shape, then sampled blocks and scores against the oracle."""
    from tpu_align_torch.oracle.api import align_pair

    n = len(ds)
    scores = out.scores()
    if scores.shape != (n,):
        raise AssertionError(f"{label}: scores shape {scores.shape}")
    lines = out.output_bytes().split(b"\n")
    if len(lines) != 4 * n + 1:
        raise AssertionError(f"{label}: {len(lines)} output lines for {n} "
                             "pairs")
    rng = np.random.default_rng(0)
    for i in np.sort(rng.choice(n, samples, replace=False)):
        i = int(i)
        want = align_pair(algo, params, *ds.pair(i), pair_num=i)
        got = b"\n".join(lines[4 * i: 4 * i + 4]) + b"\n"
        if got != want.block().encode():
            raise AssertionError(f"{label}: pair {i}: block differs from "
                                 "the oracle")
        if int(scores[i]) != want.score:
            raise AssertionError(f"{label}: pair {i}: score differs from "
                                 "the oracle")
    _say("e2e", f"{label}: {samples} sampled blocks byte-identical to the "
         "oracle")


def _reset_counts() -> None:
    from tpu_align_torch.runtime.profiler import reset_launch_counts

    reset_launch_counts()


def _counts() -> dict:
    from tpu_align_torch.runtime.profiler import launch_counts

    return launch_counts()


FILLS = ("stagger_fill", "banded_fill", "rowscan_fill")


def _fill_kind(engine) -> str:
    if engine.algorithm.is_banded:
        return "banded_fill"
    return "rowscan_fill" if engine.kernel == "rowscan" else "stagger_fill"


def _run_e2e(engine, ds, label: str, n_buckets: int, device_walk: bool):
    """Drive one path: warm up, set the counts to 0, run, read the counts
    and check each launch count against the buckets."""
    import torch

    engine.run(ds.slice(0, 8192))  # warm-up: pinned pools, walker threads
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    out = engine.run(ds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    fill = _fill_kind(engine)
    kernels = (fill, "walk", "compact") if device_walk else (fill,)
    for k in kernels:
        if counts[k] != n_buckets:
            raise AssertionError(f"{label}: {k} launches {counts[k]} != "
                                 f"buckets {n_buckets}")
    for other in FILLS:
        if other != fill and counts[other]:
            raise AssertionError(f"{label}: {other} launched "
                                 f"{counts[other]} times")
    if not device_walk and (counts["walk"] or counts["compact"]):
        raise AssertionError(f"{label}: the host walk launched walk kernels")
    _say("e2e", f"{label}: {len(ds)} pairs in {n_buckets} buckets; "
         + ", ".join(f"{k} launches {counts[k]}" for k in kernels)
         + (f"; buckets in stream mode {counts['stream']}"
            if device_walk else ""))
    for line in out.timer.report().splitlines():
        _say("e2e", f"{label}: {line}")
    _say("e2e", f"{label}: wall {wall:.4f} s, {len(ds) / wall:.1f} pairs/s")
    return out, counts


def _profile(engine, ds, label: str) -> tuple[float, float]:
    """One more run under torch.profiler: device busy time by kernel and
    the idle share of the run's wall time.  Returns (busy, wall) in ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        engine.run(ds)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type.name == "CUDA")
    busy, at = 0.0, None
    for s, e in spans:  # union of device intervals
        if at is None or s > at:
            busy += e - s
            at = e
        elif e > at:
            busy += e - at
            at = e
    def device_us(ev):
        return getattr(ev, "self_device_time_total", 0)

    for ev in sorted(prof.key_averages(), key=device_us, reverse=True)[:8]:
        t = device_us(ev)
        if t:
            _say("profile", f"{label}: {ev.key[:60]}: {t / 1e3:.3f} ms in "
                 f"{ev.count} calls")
    _say("profile", f"{label}: device busy {busy / 1e3:.3f} ms of a "
         f"{wall_us / 1e3:.3f} ms profiled wall, idle share "
         f"{1 - busy / wall_us:.3f}")
    return busy / 1e3, wall_us / 1e3


def phase_e2e(ds, main_buckets, profile: bool):
    """The e2e runs; returns (launch counts by label, the (engine, label)
    of each run phase_profile profiles: the BSW run always, every
    device-traceback run and the -kernel rowscan run with --profile)."""
    from tpu_align_torch import Algorithm, AlignmentParams
    from tpu_align_torch.io import BucketSpec, bucketize
    from tpu_align_torch.utils.synthetic import synthetic_dataset
    from tpu_align_torch.runtime.engine import AlignmentEngine

    params = AlignmentParams()
    runs = {}
    profiled = []
    # CLI defaults: -batch-pairs 2048, -max-inflight 4, -stripe 32,
    # -band 16, blocks
    for algo, tb, kernel in ((Algorithm.LNW, "host", "auto"),
                             (Algorithm.LNW, "device", "auto"),
                             (Algorithm.ANW, "device", "auto"),
                             (Algorithm.BSW, "device", "auto"),
                             (Algorithm.LNW, "host", "rowscan")):
        label = f"{algo.value}-{tb}" + ("-rowscan" if kernel == "rowscan"
                                        else "")
        engine = AlignmentEngine(algo, params, device=DEVICE,
                                 output="blocks", traceback=tb,
                                 kernel=kernel)
        out, counts = _run_e2e(engine, ds, label, len(main_buckets),
                               tb == "device")
        _check_blocks(out, ds, algo, params, min(500, len(ds)), label)
        runs[label] = counts
        if algo.is_banded or (profile and (tb == "device"
                                           or kernel == "rowscan")):
            profiled.append((engine, label))
    kernel_ms = _kernel_sweep_ms(main_buckets, params)
    gcups = ds.num_cells / (kernel_ms / 1e3) / 1e9
    _say("e2e", f"lnw fill sweep {kernel_ms:.3f} ms over {len(main_buckets)}"
         f" buckets, {gcups:.3f} GCUPS ({ds.num_cells} cells)")
    lsw_ds = synthetic_dataset(LSW_E2E_PAIRS, uniform_len=250, seed=43)
    n = len(bucketize(lsw_ds, BucketSpec(batch_pairs=2048)))
    engine = AlignmentEngine(Algorithm.LSW, params, device=DEVICE,
                             output="blocks", traceback="device")
    out, runs["lsw-device"] = _run_e2e(engine, lsw_ds, "lsw-device", n, True)
    _check_blocks(out, lsw_ds, Algorithm.LSW, params,
                  min(200, len(lsw_ds)), "lsw-device")
    return runs, profiled


def phase_profile(ds, profiled) -> None:
    """The e2e runs phase_e2e picked, once more under torch.profiler:
    device busy time by kernel and the idle share.  Last in the script:
    after a profiled run of the engine, later profiler sessions drop
    records (device_ms)."""
    for engine, label in profiled:
        _profile(engine, ds, label)


_MESH_CHILD = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from tpu_align_torch import Algorithm
from tpu_align_torch.distributed import (
    global_stats, host_shard, initialize, make_pairs_mesh, renumber)
from tpu_align_torch.io import parse_pair_file
from tpu_align_torch.runtime.engine import AlignmentEngine

rdv, rank, pairs, out, want_max, want_cells = sys.argv[1:]
assert initialize(rdv, 2, int(rank)) == (int(rank), 2)
shard, ids = host_shard(parse_pair_file(pairs))
mesh = make_pairs_mesh(["cuda:0"])
res = AlignmentEngine(Algorithm.LNW, device="cuda", traceback="device",
                      output="records", mesh=mesh).run(shard)
renumber(res.results, ids)
with open(out, "w") as f:
    f.write("".join(r.block() for r in res.results))
cells = shard.ref_len.astype(np.int64) * shard.qry_len
got = global_stats(mesh, res.scores(), cells)
assert got == (int(want_max), int(want_cells)), got
dist.destroy_process_group()
"""


def _mesh_run(engine, ds, label: str, want: bytes, fill: str,
              device_walk: bool) -> float:
    """warmup, then one timed run with the counts set to 0 just before it;
    the blocks must equal `want` and each shard's fill (and walk and
    compaction) must have launched once a bucket.  Returns the wall."""
    import torch

    engine.warmup(ds)
    _reset_counts()
    t0 = time.perf_counter()
    out = engine.run(ds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    n = engine.mesh.size * len(engine._buckets_of(ds))
    walks = n if device_walk else 0
    got = (counts[fill], counts["walk"], counts["compact"])
    if got != (n, walks, walks):
        raise AssertionError(f"mesh: {label}: {fill}, walk, compact "
                             f"launches {got} != {(n, walks, walks)}")
    if out.output_bytes() != want:
        raise AssertionError(f"mesh: {label}: blocks differ from the "
                             "one-device run")
    _say("mesh", f"{label}: {len(ds)} pairs, {engine.mesh.size} shard(s), "
         f"launches {fill} {got[0]}, walk {got[1]}, compact {got[2]}; wall "
         f"{wall:.4f} s, {len(ds) / wall:.1f} pairs/s")
    return wall


def phase_mesh(ds) -> dict:
    """The engine on a `pairs` mesh against the one-device run; returns
    the walls by label."""
    from tpu_align_torch import Algorithm, AlignmentParams
    from tpu_align_torch.distributed import (
        global_stats,
        make_pairs_mesh,
        merge_output_files,
    )
    from tpu_align_torch.io.dataset import write_pair_file
    from tpu_align_torch.runtime.engine import AlignmentEngine

    t_phase = time.perf_counter()
    params = AlignmentParams()
    meshes = {"every card": make_pairs_mesh(),
              "2 x cuda:0": make_pairs_mesh(["cuda:0", "cuda:0"])}
    small = ds.slice(0, MESH_PAIRS)
    walls = {}
    for algo, tb, kernel, data in (
            (Algorithm.LNW, "device", "auto", ds),
            (Algorithm.ANW, "device", "auto", small),
            (Algorithm.BSW, "device", "auto", small),
            (Algorithm.LNW, "host", "auto", small),
            (Algorithm.LNW, "host", "rowscan", small)):
        one = AlignmentEngine(algo, params, device=DEVICE, output="blocks",
                              traceback=tb, kernel=kernel)
        fill = _fill_kind(one)
        label = f"{algo.value}-{tb}" + (
            "-rowscan" if kernel == "rowscan" else "") + f" {len(data)}"
        want = one.run(data)
        walls[f"{label} one device"] = _mesh_run(
            one, data, f"{label} one device", want.output_bytes(), fill,
            tb == "device")
        for name, mesh in meshes.items():
            if data is small and name == "every card":
                continue
            engine = AlignmentEngine(algo, params, device=DEVICE,
                                     output="blocks", traceback=tb,
                                     kernel=kernel, mesh=mesh)
            walls[f"{label} {name}"] = _mesh_run(
                engine, data, f"{label} {name}", want.output_bytes(), fill,
                tb == "device")
        if algo is Algorithm.ANW:
            cells = small.ref_len.astype(np.int64) * small.qry_len
            got = global_stats(meshes["2 x cuda:0"], want.scores(), cells)
            if got != (int(want.scores().max()), int(cells.sum())):
                raise AssertionError(f"mesh: global_stats {got}")
            _say("mesh", f"global_stats over 2 shards: max {got[0]}, "
                 f"cells {got[1]}, equal to numpy's")
    one = AlignmentEngine(Algorithm.LNW, params, device=DEVICE,
                          traceback="device", output="records")
    want = one.run(small)
    with tempfile.TemporaryDirectory() as tmp:
        pairs = os.path.join(tmp, "pairs.txt")
        write_pair_file(pairs, list(small.pairs()))
        outs = [os.path.join(tmp, f"host{r}.txt") for r in range(2)]
        cells = int((small.ref_len.astype(np.int64) * small.qry_len).sum())
        env = {**os.environ, "PYTHONPATH": REPO}
        for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
            env.pop(k, None)
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-c", _MESH_CHILD, f"file://{tmp}/rdv", str(r),
             pairs, outs[r], str(int(want.scores().max())), str(cells)],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(2)]
        try:
            errs = [p.communicate(timeout=300)[1] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=60)
        walls["two processes"] = time.perf_counter() - t0
        if [p.returncode for p in procs] != [0, 0]:
            raise AssertionError("mesh: two-process run failed: "
                                 + " | ".join(e[-2000:] for e in errs))
        merged = os.path.join(tmp, "merged.txt")
        merge_output_files(outs, merged)
        with open(merged) as f:
            if f.read() != want.output_text():
                raise AssertionError("mesh: the two processes' merged "
                                     "output differs from one process's")
    _say("mesh", f"two processes (gloo, file rendezvous) over "
         f"{MESH_PAIRS} pairs on cuda:0: merged output equal to the "
         f"one-process text; wall {walls['two processes']:.2f} s, "
         "process start-up included")
    _say("mesh", f"phase wall {time.perf_counter() - t_phase:.1f} s")
    return walls


def _mutated_pair(rnd, qlen: int, rlen: int) -> tuple[str, str]:
    """scripts/bench_long.py's generator: the reference is random ACGT, the
    query the reference tiled to qlen with 10 % point mutations."""
    ref = "".join(rnd.choice("ACGT") for _ in range(rlen))
    qry = "".join(rnd.choice("ACGT") if rnd.random() < 0.1 else c
                  for c in (ref * -(-qlen // rlen))[:qlen])
    return ref, qry


@functools.lru_cache(maxsize=None)
def _long_pairs(pairs: int, qlen: int, rlen: int, seed: int = 42):
    rnd = random.Random(seed)
    return [_mutated_pair(rnd, qlen, rlen) for _ in range(pairs)]


def _pair_tensors(pairs):
    """(refs (B, N), qrys (B, M) uint8, rlen, qlen (B,) int32) on the card
    for pairs of equal lengths."""
    import torch

    def tok(seqs):
        return torch.from_numpy(np.stack([
            np.frombuffer(x.encode("ascii"), np.uint8) for x in seqs]))

    refs, qrys = tok([r for r, _ in pairs]), tok([q for _, q in pairs])
    n = len(pairs)
    return tuple(x.to(DEVICE) for x in (
        refs, qrys, torch.full((n,), refs.shape[1], dtype=torch.int32),
        torch.full((n,), qrys.shape[1], dtype=torch.int32)))


def _problems(lens, seed: int):
    """Random ACGT problems of the given (qlen, rlen), each query a 90 %
    copy of its reference, padded to the longest: the last-row fill's
    (ref, qry, ref_len, qry_len) on the card."""
    import torch

    rng = np.random.default_rng(seed)
    m = max(max(q for q, _ in lens), 1)
    n = max(max(r for _, r in lens), 1)
    refs = rng.integers(0, 4, (len(lens), n))
    qrys = rng.integers(0, 4, (len(lens), m))
    k = min(m, n)
    qrys[:, :k] = np.where(rng.random((len(lens), k)) < 0.9, refs[:, :k],
                           qrys[:, :k])
    letters = np.frombuffer(b"ACGT", np.uint8)
    arrays = (letters[refs], letters[qrys],
              np.array([r for _, r in lens], np.int32),
              np.array([q for q, _ in lens], np.int32))
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(DEVICE)
                 for x in arrays)


def _top_level(pairs):
    """Hirschberg's top split level over pairs: each pair's top half and
    its reversed bottom half, as the last-row fill's batch on the card."""
    import torch

    from tpu_align_torch.traceback import hirschberg as th

    probs = []
    for ref, qry in pairs:
        rt, qt = th._tokens(ref), th._tokens(qry)
        mid = len(qry) // 2
        probs += [(rt, qt[:mid]), (rt[::-1].copy(), qt[mid:][::-1].copy())]
    return th._batch_problems(probs, torch.device(DEVICE))


def _levels():
    """The last-row fill's shapes on the Hirschberg path: the top split
    level of a SPLIT_LEVEL pair, of the 64 pairs and of the long pair of
    LONG_RUNS."""
    return {"split level": _top_level(_long_pairs(1, *SPLIT_LEVEL)),
            "64-pair top level": _top_level(_long_pairs(*LONG_RUNS[1][1:])),
            "long pair's top level": _top_level(
                _long_pairs(*LONG_RUNS[0][1:]))}


def _last_rows_diff(got, want, ref_len, num_real: int, label: str) -> int:
    """Exact comparison of two last-row fills: scores, then hlast (and
    flast) at every defined entry j <= rlen of the real lanes.  Returns
    the largest absolute difference (0)."""
    import torch

    err = (got[0][:num_real].long() - want[0][:num_real].long()).abs()
    err = err.max().item()
    if err:
        raise AssertionError(f"{label}: scores differ by up to {err}")
    n = got[1].shape[0]
    defined = (torch.arange(1, n + 1, device=got[1].device)[:, None]
               <= ref_len[None, :num_real].to(got[1].device))
    for name, g, w in (("hlast", got[1], want[1]), ("flast", got[2], want[2])):
        if (g is None) != (w is None):
            raise AssertionError(f"{label}: {name} on one side only")
        if g is None:
            continue
        if g.shape != w.shape:
            raise AssertionError(f"{label}: {name} shape {tuple(g.shape)} "
                                 f"!= {tuple(w.shape)}")
        d = torch.where(defined, (g[:, :num_real].long()
                                  - w[:, :num_real].long()).abs(), 0)
        d = d.max().item()
        if d:
            raise AssertionError(f"{label}: {name} differs by up to {d}")
    return err


def _split_inputs(k: int, n: int):
    """utils/synthetic.py's random split-reduction inputs (seed 24) on the
    card: ties, NEG entries, an all-NEG subproblem, widths 0..n."""
    import torch

    from tpu_align_torch.utils.synthetic import split_reduce_inputs

    return [torch.from_numpy(x).to(DEVICE)
            for x in split_reduce_inputs(k, n, seed=24)]


def phase_rowscan(cases, main_buckets):
    """The row-sweep fill, both last-row fills and the split reduction
    against their plain versions.  Returns (errs {kernel: largest
    difference (0)}, the split-level inputs the timing phase reuses)."""
    import torch

    from tpu_align_torch import Algorithm, AlignmentParams
    from tpu_align_torch.convert import bucket_to_tensors
    from tpu_align_torch.kernels import fill as rs
    from tpu_align_torch.kernels import stagger as ts
    from tpu_align_torch.traceback import hirschberg as th
    from tpu_align_torch.utils.synthetic import (
        SPLIT_REDUCE_SHAPES,
        rowscan_seam_bucket,
        split_reduce_inputs,
    )

    params = AlignmentParams()
    b = main_buckets[0]
    edges = list(bucket_to_tensors(b, DEVICE))
    edges[3] = edges[3].clone()
    edges[3][0] = 1                # qlen = 1
    edges[3][1] = b.padded_qry     # qlen = M
    sets = [(label, [(k, bk, bucket_to_tensors(bk, DEVICE))
                     for k, bk in enumerate(buckets)])
            for label, buckets in cases]
    sets.append(("main-path qlen 1 and M", [(0, b, tuple(edges))]))
    seams, seam_t = rowscan_seam_bucket(DEVICE)
    sets.append(("band seams and ties", [(0, seams, tuple(seam_t))]))
    errs = {"rowscan_fill": 0, "lsw_rowscan_endpoints": 0,
            "rowscan_last_rows": 0, "stagger_last_rows": 0,
            "split_reduce": 0}
    for algo in (Algorithm.LNW, Algorithm.LSW, Algorithm.ANW, Algorithm.BSW):
        for label, items in sets:
            for k, bk, t in items:
                for tb_on in (True, False):
                    got = rs.fill_bucket_async(algo, params, *t,
                                               with_traceback=tb_on)
                    want = rs.fill_rowscan_reference(algo, params, *t,
                                                     with_traceback=tb_on)
                    torch.cuda.synchronize()
                    name = (f"{algo.value} {label} bucket {k} "
                            f"({bk.batch}x{bk.padded_qry}x{bk.padded_ref}) "
                            f"rowscan dirs={'on' if tb_on else 'off'}")
                    errs["rowscan_fill"] = max(errs["rowscan_fill"], _compare(
                        got, want, bk.num_real, name,
                        lambda d, lo, hi: rs.defined_codes(
                            algo, d[:, lo:hi], t[2][lo:hi], t[3][lo:hi])))
                    _say("rowscan", f"{name}: exact")
    errs["lsw_rowscan_endpoints"] = _check_endpoints(params)

    go = params.gap_open
    size = max(b.batch, 256)  # the most problems a check below takes
    mixed = np.where(np.random.default_rng(3).random(size) < 0.5, 0, go)
    tops = {"none": None, "all go": np.full(size, go),
            "all 0": np.zeros(size), "mixed": mixed}
    q, r = SPLIT_LEVEL
    levels = _levels()
    split = levels["split level"]
    lnw, anw = Algorithm.LNW, Algorithm.ANW
    checks = [(lnw, "none", tuple(edges), b.num_real, "2048-pair"),
              (anw, "none", tuple(edges), b.num_real, "2048-pair"),
              (anw, "all go", tuple(edges), b.num_real, "2048-pair"),
              (anw, "all 0", tuple(edges), b.num_real, "2048-pair"),
              (anw, "mixed", tuple(edges), b.num_real, "2048-pair"),
              (lnw, "none", split, 2, "split-level"),
              (anw, "all go", split, 2, "split-level"),
              (anw, "mixed", split, 2, "split-level")]
    # the wavefront's row seams at each width, with mixed widths
    for n in LAST_ROW_WIDTHS:
        lens = [(x, n if k % 2 == 0 else max(1, n // 3))
                for k, x in enumerate(LAST_ROW_SEAMS)]
        t = _problems(lens, n)
        checks += [(lnw, "none", t, len(lens), f"row seams, N={n}"),
                   (anw, "mixed", t, len(lens), f"row seams, N={n}")]
    rng = np.random.default_rng(128)
    lens = [(int(rng.integers(1, 2000)), int(rng.integers(1, 3000)))
            for _ in range(128)]
    lens[5], lens[9] = (0, 300), (400, 0)  # an empty query and reference
    t = _problems(lens, 128)
    checks += [(lnw, "none", t, 128, "128 mixed problems"),
               (anw, "mixed", t, 128, "128 mixed problems")]
    for where in ("64-pair top level", "long pair's top level"):
        t = levels[where]
        checks += [(lnw, "none", t, t[0].shape[0], where),
                   (anw, "all go", t, t[0].shape[0], where)]
    lr = {}
    for algo, kind, t, nr, where in checks:
        top = tops[kind]
        ot = (None if top is None else
              torch.from_numpy(top[:t[0].shape[0]].astype(np.int32))
              .to(DEVICE))
        got_r = rs.fill_last_rows_async(algo, params, *t, open_top=ot)
        got_s = ts.fill_stagger_last_rows_async(algo, params, *t, open_top=ot)
        want = rs.last_rows_reference(algo, params, *t, open_top=ot)
        torch.cuda.synchronize()
        shape = "x".join(str(x) for x in (t[0].shape[0], t[1].shape[1],
                                          t[0].shape[1]))
        name = f"{algo.value} last rows, {where} ({shape}), open_top {kind}"
        errs["rowscan_last_rows"] = max(
            errs["rowscan_last_rows"],
            _last_rows_diff(got_r, want, t[2], nr, name + " rowscan"))
        errs["stagger_last_rows"] = max(
            errs["stagger_last_rows"],
            _last_rows_diff(got_s, want, t[2], nr, name + " stagger"),
            _last_rows_diff(got_s, got_r, t[2], nr, name + " stagger/rowscan"))
        _say("rowscan", f"{name}: rowscan, stagger and plain exact "
             f"(score of problem 0: {int(got_r[0][0])})")
        if where == "split-level" and kind != "mixed":
            lr[algo] = got_r

    # the split-level rows through the combine, then random rows with
    # ties and sentinels at the 64-pair top level's width
    g, ge = params.gap, params.gap_extend

    def vec(*xs):
        return [torch.tensor(x, dtype=torch.int32, device=DEVICE)
                for x in xs]

    mid = q // 2
    reduce_cases = [
        ("lnw split level", [lr[Algorithm.LNW][1], None,
                             *vec([mid * g], [(q - mid) * g], [r], [0])]),
        ("anw split level", [lr[Algorithm.ANW][1], lr[Algorithm.ANW][2],
                             *vec([go + mid * ge], [go + (q - mid) * ge],
                                  [r], [go])]),
    ]
    rand = _split_inputs(64, 16384)
    reduce_cases += [("random 64 subs x 16384, linear",
                      [rand[0], None, *rand[2:]]),
                     ("random 64 subs x 16384, affine", rand)]
    # the shapes the kernel's grid splits differently
    for k, n, kind in SPLIT_REDUCE_SHAPES:
        x = [torch.from_numpy(v).to(DEVICE)
             for v in split_reduce_inputs(k, n, kind)]
        reduce_cases += [(f"{kind} {k} subs x {n}, linear",
                          [x[0], None, *x[2:]]),
                         (f"{kind} {k} subs x {n}, affine", x)]
    for name, args in reduce_cases:
        got = th.split_reduce(*args)
        want = th.split_reduce_reference(*args)
        torch.cuda.synchronize()
        d = (got.long() - want.long()).abs().max().item()
        if d:
            raise AssertionError(f"split_reduce {name}: differs by up to {d}")
        errs["split_reduce"] = max(errs["split_reduce"], d)
        _say("rowscan", f"split_reduce {name}: exact "
             f"(first split column {int(got[0, 0])})")
    return errs, (levels, rand)


def _check_endpoints(params) -> int:
    """LSW Hirschberg's end-point fills at phase 8's full width (64 pairs
    of 16,384^2, 128 bands a pair, the bests passed down the bands) against
    the plain version: the forward fill, then the fill of each pair's
    prefixes up to the end cell, reversed, as _local_endpoints_batch makes
    them.  Returns the largest difference (0) of scores and cells."""
    import torch

    from tpu_align_torch import Algorithm
    from tpu_align_torch.kernels import fill as rs
    from tpu_align_torch.traceback import hirschberg as th

    _, npairs, q, r = LONG_RUNS[3]
    pairs = _long_pairs(npairs, q, r)
    lsw = Algorithm.LSW
    err = 0
    t = _pair_tensors(pairs)
    for which in ("forward", "reversed"):
        got = rs.fill_bucket_async(lsw, params, *t, with_traceback=False)
        want = rs.fill_rowscan_reference(lsw, params, *t,
                                         with_traceback=False)
        torch.cuda.synchronize()
        err = max(err, _compare(got, want, npairs, f"lsw end points, "
                                f"{which} fill ({npairs} x {q} x {r})",
                                None))
        _say("rowscan", f"lsw end points, {which} fill: scores and cells "
             f"exact (pair 0: {int(got[0][0])} at ({int(got[1][0])}, "
             f"{int(got[2][0])}))")
        if which == "reversed":
            break
        ers, ecs = want[1].tolist(), want[2].tolist()
        t = th._batch_problems([
            (np.frombuffer(ref.encode("ascii"), np.uint8)[:ec][::-1].copy(),
             np.frombuffer(qry.encode("ascii"), np.uint8)[:er][::-1].copy())
            for (ref, qry), er, ec in zip(pairs, ers, ecs)],
            torch.device(DEVICE))
    return err


def phase_hirschberg():
    """Hirschberg on the card against the plain run, then the full-width
    runs.  Returns {label: launch counts}."""
    import torch

    from tpu_align_torch import Algorithm, AlignmentParams
    from tpu_align_torch.kernels import fill as rs
    from tpu_align_torch.traceback import hirschberg as th

    params = AlignmentParams()
    n, lo, hi = HIRSCH_CHECK
    rnd = random.Random(7)
    pairs = [_mutated_pair(rnd, rnd.randint(lo, hi), rnd.randint(lo, hi))
             for _ in range(n)]
    runs = {}
    for algo, last_rows in ((Algorithm.LNW, "auto"), (Algorithm.LSW, "auto"),
                            (Algorithm.ANW, "auto"),
                            (Algorithm.LNW, "stagger"),
                            (Algorithm.ANW, "stagger")):
        th.LAST_ROWS_KERNEL = last_rows
        try:
            _reset_counts()
            got = th.hirschberg_align_batch(algo, params, pairs,
                                            device=DEVICE)
            torch.cuda.synchronize()
            counts = _counts()
            want = th.hirschberg_align_batch(algo, params, pairs,
                                             device="cpu")
        finally:
            th.LAST_ROWS_KERNEL = "auto"
        label = f"{algo.value} {n} pairs of {lo}-{hi} bp, last rows {last_rows}"
        for k, (x, y) in enumerate(zip(got, want)):
            if x.block() != y.block():
                raise AssertionError(f"hirschberg {label}: pair {k} differs "
                                     "from the run on CPU")
        _check_hirschberg_counts(algo, counts, label, last_rows)
        runs[f"{algo.value}-{last_rows}"] = counts
        _say("hirsch", f"{label}: byte-identical to the CPU run; "
             + _count_text(counts))

    for name, npairs, q, r in LONG_RUNS:
        algo = Algorithm(name)
        pairs = _long_pairs(npairs, q, r)  # seed 42, made once
        label = f"{name} {npairs} x ({q} x {r})"
        cells = npairs * q * r
        secs = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        res = th.hirschberg_align_batch(algo, params, pairs, device=DEVICE,
                                        phase_seconds=secs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts()
        peak = torch.cuda.max_memory_allocated()
        _check_hirschberg_counts(algo, counts, label, "auto")
        whole = rs.fill_bucket_async(algo, params, *_pair_tensors(pairs),
                                     with_traceback=False)[0].tolist()
        rescore = th._rescore_affine if algo.is_affine else th._rescore
        for k, (x, (ref, qry)) in enumerate(zip(res, pairs)):
            got = rescore(params, x.ref_aligned, x.query_aligned)
            if not got == x.score == whole[k]:
                raise AssertionError(
                    f"hirschberg {label}: pair {k}: rescore {got}, score "
                    f"{x.score}, the row-sweep kernel's score {whole[k]}")
            r_seq = x.ref_aligned.replace("_", "")
            q_seq = x.query_aligned.replace("_", "")
            if algo.is_local:
                ok = r_seq in ref and q_seq in qry
            else:
                ok = r_seq == ref and q_seq == qry
            if not ok:
                raise AssertionError(f"hirschberg {label}: pair {k}: the "
                                     "lines do not give back the sequences")
        runs[label] = counts
        host = wall - sum(secs.values())
        bits = 4 if algo.is_affine else 2
        _say("hirsch", f"{label}: rescores equal the row-sweep kernel's "
             f"scores (pair 0: {res[0].score}); " + _count_text(counts))
        if algo.is_local:
            _say("hirsch", f"{label}: endpoints {secs['endpoints']:.4f} s "
                 f"(two scores-only row-sweep fills, {counts['rowscan_fill']}"
                 " launches)")
        _say("hirsch", f"{label}: wall {wall:.4f} s, {cells} cells, "
             f"{cells / wall / 1e9:.3f} GCUPS-effective; "
             + ", ".join(f"{k} {v:.4f} s" for k, v in sorted(secs.items()))
             + f", host recursion {host:.4f} s; peak device memory "
             f"{peak / 2**20:.1f} MiB; direction tensor never built "
             f"{cells * bits // 8} bytes")
    return runs, _split_levels()


def _split_levels():
    """The split reduction's arguments at each level of LONG_RUNS' LNW 64
    x 16,384^2 run, captured from one more run of it on the card, each
    level's kernel output held against split_reduce_reference.  Returns
    [(label, args)] for the timing phase."""
    import torch

    from tpu_align_torch import Algorithm, AlignmentParams
    from tpu_align_torch.traceback import hirschberg as th

    name, npairs, q, r = LONG_RUNS[1]
    captured = []
    kernel = th.split_reduce

    def capture(*args):
        out = kernel(*args)
        captured.append(([None if a is None else a.clone() for a in args],
                         out.clone()))
        return out

    th.split_reduce = capture
    try:
        th.hirschberg_align_batch(Algorithm(name), AlignmentParams(),
                                  _long_pairs(npairs, q, r), device=DEVICE)
    finally:
        th.split_reduce = kernel
    levels = []
    for depth, (args, got) in enumerate(captured, 1):
        want = th.split_reduce_reference(*args)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"split_reduce, {name} {npairs} x ({q} x "
                                 f"{r}) level {depth}: differs from the "
                                 "plain version")
        n, k2 = args[0].shape
        label = f"{name} level {depth}: {args[2].numel()} subs x {n}"
        levels.append((label, args))
        _say("hirsch", f"split_reduce, {label} (last rows {n} x {k2}): "
             "exact")
    return levels


def _count_text(counts) -> str:
    return ", ".join(f"{k} {v}" for k, v in counts.items() if v)


def _check_hirschberg_counts(algo, counts, label, last_rows) -> None:
    """The split levels went through the chosen last-row kernel and the
    split reduction, the leaves through the stagger fill, LSW's end points
    through two row-sweep fills."""
    rows, other = (("stagger_last_rows", "rowscan_last_rows")
                   if last_rows == "stagger"
                   else ("rowscan_last_rows", "stagger_last_rows"))
    want_pos = [rows, "split_reduce", "stagger_fill"]
    for k in want_pos:
        if counts[k] <= 0:
            raise AssertionError(f"hirschberg {label}: no {k} launch")
    if counts[other] or counts[rows] != counts["split_reduce"]:
        raise AssertionError(f"hirschberg {label}: launches {counts}")
    if counts["rowscan_fill"] != (2 if algo.is_local else 0):
        raise AssertionError(f"hirschberg {label}: rowscan_fill launches "
                             f"{counts['rowscan_fill']}")


def _time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def _bound(nbytes: int, ops: int) -> tuple[float, str]:
    """The least time the card could take, ms: the larger of the bytes
    over HBM_BYTES_S and the integer lane-operations over INT_OPS_S."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / INT_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _in_turns(label: str, kernel, plain, cells: int | None = None,
              reps: int = TIMING_REPS, plain_reps: int = PLAIN_REPS,
              bound: tuple[float, str] | None = None, library=None) -> dict:
    """plain, kernel, kernel, plain; then the library call, if any.
    Returns the kernels-line fields: ms, plain_ms, bound_ms, bound_by,
    library_ms."""
    p1 = _time_ms(plain, plain_reps)
    k1 = _time_ms(kernel, reps)
    k2 = _time_ms(kernel, reps)
    p2 = _time_ms(plain, plain_reps)
    k, p = (k1 + k2) / 2, (p1 + p2) / 2
    lib = _time_ms(library, reps) if library is not None else None
    rate = f", {cells / k / 1e6:.3f} GCUPS" if cells else ""
    extra = ""
    if bound is not None:
        extra += (f"; bound {bound[0]:.6f} ms ({bound[1]}), "
                  f"{bound[0] / k:.4f} of it")
    if lib is not None:
        extra += f"; library call {lib:.4f} ms"
    _say("timing", f"{label}: kernel {k:.4f} ms ({k1:.4f}/{k2:.4f}){rate}; "
         f"plain {p:.4f} ms ({p1:.4f}/{p2:.4f}); plain/kernel {p / k:.2f}x"
         + extra)
    return {"ms": k, "plain_ms": p,
            "bound_ms": None if bound is None else bound[0],
            "bound_by": None if bound is None else bound[1],
            "library_ms": lib}


def _real_cells(b) -> int:
    n = b.num_real
    return int(np.sum(b.ref_len[:n].astype(np.int64) * b.qry_len[:n]))


def _band_cells(b, band: int) -> int:
    """Cells with |i - j| < band inside each real pair."""
    n = b.num_real
    i = np.arange(1, b.padded_qry + 1)[:, None]
    lo = np.maximum(1, i - band + 1)
    hi = np.minimum(b.ref_len[None, :n], i + band - 1)
    inside = (i <= b.qry_len[None, :n]) & (hi >= lo)
    return int(np.where(inside, hi - lo + 1, 0).sum())


def _fill_bound(algo, tensors, outs, cells: int, dirs: bool = True):
    """A fill reads its tokens and lengths once and writes its outputs
    once; CELL_OPS a cell (one fewer without direction codes)."""
    ops = cells * (CELL_OPS[algo.value] - (0 if dirs else 1))
    return _bound(_nbytes(*tensors, *outs), ops)


def _walk_bound(inputs, outs, packed):
    """A walk reads the scores and start cells and one 2-bit code a move,
    writes its outputs once, and does about 4 operations a move."""
    from tpu_align_torch.traceback.device import lane_moves

    moves = int(lane_moves(packed).sum())
    return _bound(_nbytes(*inputs, *outs) + moves // 4, 4 * moves)


def device_ms(fn, reps: int = TIMING_REPS) -> float:
    """The device time of one call of fn from torch.profiler's records of
    reps calls: for each device operation the call launches (a kernel,
    and a memset where the wrapper resets scratch), the mean duration of
    its records, summed -- the time the card ran, without the host's
    launch cost between calls (which CUDA events over back-to-back calls
    of a short kernel also count).  A mean a record, not a total over
    reps: after a profiled run of the engine the profiler drops some
    records of later sessions, and sometimes all of two sessions' in a
    row, so an empty session is run again; a fourth empty one raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(4):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ops = [e for e in prof.key_averages()
               if getattr(e, "self_device_time_total", 0) > 0]
        if ops:
            return sum(e.self_device_time_total / e.count for e in ops) / 1e3
        _say("timing", "the profiler recorded no device activity; "
             + ("profiling again" if attempt < 3 else "giving up"))
    raise RuntimeError("the profiler recorded no device activity")


def _per_move(t: dict, fn, longest: int, label: str) -> None:
    """Adds to a walk's kernels-line entry its device time, the longest
    lane's moves and the ns a move they imply (a walk is one chain of
    moves a lane)."""
    t["device_ms"] = device_ms(fn)
    t["longest_lane_moves"] = longest
    t["ns_per_move"] = t["device_ms"] * 1e6 / longest
    _say("timing", f"{label}: device {t['device_ms']:.4f} ms a call "
         f"(profiler); longest lane {longest} moves, "
         f"{t['ns_per_move']:.1f} ns a move")


def _per_event(t: dict, fn, events: int, label: str) -> None:
    """Adds to the compaction's kernels-line entry its device time, the
    events it copied and the ns an event they imply."""
    t["device_ms"] = device_ms(fn)
    t["events"] = events
    t["ns_per_event"] = t["device_ms"] * 1e6 / max(events, 1)
    _say("timing", f"{label}: device {t['device_ms']:.4f} ms a call "
         f"(profiler); {events} events, {t['ns_per_event']:.3f} ns an event")


def _wide_scores(params) -> dict:
    """LNW's and ANW's scores-only fills on WIDE_SCORES problems: queries
    of L, L + 48 and L + 96 rows (a partial bottom band, and whole bands
    at L + 96 = 4,096) against references 0-4 bases short of L, which
    band_rows puts in 256-row bands on the launch's shape alone.  The
    band size is asserted, the scores equal the plain version's bit for
    bit; then each fill's device time (torch.profiler) and its bound.
    Returns {aligner: kernels-line fields}."""
    import torch

    from tpu_align_torch import Algorithm
    from tpu_align_torch.kernels import fill as rs

    pairs, length = WIDE_SCORES
    lens = [(length + 48 * (k % 3), length - k % 5) for k in range(pairs)]
    t = _problems(lens, seed=11)
    cells = sum(q * r for q, r in lens)
    rec = {}
    for algo in (Algorithm.LNW, Algorithm.ANW):
        def fn():
            return rs.fill_bucket_async(algo, params, *t,
                                        with_traceback=False)

        label = (f"{algo.value} row-sweep fill, {pairs} x ~{length} bp, "
                 "scores only")
        got = fn()
        if rs.launch_band_rows != rs.WIDE_BAND_ROWS:
            raise AssertionError(f"{label}: {rs.launch_band_rows}-row "
                                 "bands, not 256")
        want = rs.fill_rowscan_reference(algo, params, *t,
                                         with_traceback=False)
        torch.cuda.synchronize()
        _compare(got, want, pairs, label, None)
        bound = _fill_bound(algo, t, got, cells, dirs=False)
        dev = device_ms(fn, reps=5)
        _say("timing", f"{label}: 256-row bands, scores exact; device "
             f"{dev:.4f} ms a call (profiler), {cells / dev / 1e6:.1f} "
             f"GCUPS; bound {bound[0]:.6f} ms ({bound[1]}), "
             f"{bound[0] / dev:.4f} of it")
        rec[algo.value] = {"band_rows": rs.launch_band_rows,
                           "device_ms": dev, "bound_ms": bound[0],
                           "bound_by": bound[1]}
    return rec


def phase_timing(main_buckets, split_inputs, split_levels):
    """Each kernel beside its plain version on one bucket (the last-row
    fills at the split-level shape, the split reduction at the 64-pair top
    level), with its bound and, where one PyTorch call computes the same
    function, that call's time; then device times by the profiler: the
    banded fill at WIDE_BAND, the split reduction at each level of the LNW
    64 x 16,384^2 run, each DPX function; returns {name: kernels-line
    fields}."""
    import torch

    from tpu_align_torch import Algorithm, AlignmentParams
    from tpu_align_torch.convert import bucket_to_tensors
    from tpu_align_torch.io import BucketSpec, bucketize
    from tpu_align_torch.kernels import banded as tb
    from tpu_align_torch.kernels import fill as rs
    from tpu_align_torch.kernels import stagger as ts
    from tpu_align_torch.traceback import device as td
    from tpu_align_torch.traceback import hirschberg as th
    from tpu_align_torch.traceback import walk_kernel as wk
    from tpu_align_torch.utils.synthetic import synthetic_dataset

    params = AlignmentParams()
    lnw = Algorithm.LNW
    small = bucketize(synthetic_dataset(256, uniform_len=250, seed=42),
                      BucketSpec(batch_pairs=256))
    small = max(small, key=lambda b: b.num_real)
    out = {}
    for label, b in (("256-pair", small), ("2048-pair", main_buckets[0])):
        t = bucket_to_tensors(b, DEVICE)
        cells = _real_cells(b)
        desc = f"{b.num_real} real pairs, {b.padded_qry}x{b.padded_ref}"
        out[f"lnw_stagger_fill {label}"] = _in_turns(
            f"lnw fill, {label} bucket ({desc}, dirs on)",
            lambda: ts.fill_stagger_bucket_async(lnw, params, *t),
            lambda: ts.fill_stagger_reference(lnw, params, *t), cells,
            bound=_fill_bound(lnw, t, ts.fill_stagger_bucket_async(
                lnw, params, *t), cells))
    b = main_buckets[0]
    t = bucket_to_tensors(b, DEVICE)
    cells = _real_cells(b)
    desc = f"2048-pair bucket ({b.num_real} real pairs)"
    for algo in (Algorithm.LSW, Algorithm.ANW):
        out[f"{algo.value}_stagger_fill"] = _in_turns(
            f"{algo.value} fill, {desc}, dirs on",
            lambda: ts.fill_stagger_bucket_async(algo, params, *t),
            lambda: ts.fill_stagger_reference(algo, params, *t), cells,
            bound=_fill_bound(algo, t, ts.fill_stagger_bucket_async(
                algo, params, *t), cells))
    # the same fills scores-only: what building and storing the dirs costs
    for algo in (lnw, Algorithm.LSW, Algorithm.ANW):
        out[f"{algo.value}_stagger_scores"] = _in_turns(
            f"{algo.value} fill, {desc}, scores only",
            lambda: ts.fill_stagger_bucket_async(algo, params, *t,
                                                 with_traceback=False),
            lambda: ts.fill_stagger_reference(algo, params, *t,
                                              with_traceback=False), cells,
            bound=_fill_bound(algo, t, ts.fill_stagger_bucket_async(
                algo, params, *t, with_traceback=False), cells, dirs=False))
    bsw = Algorithm.BSW
    band_cells = _band_cells(b, params.band)
    out["bsw_banded_fill"] = _in_turns(
        f"bsw banded fill, {desc}, band {params.band}, dirs on (rate over "
        f"the {band_cells} band cells)",
        lambda: tb.fill_banded_bucket_async(bsw, params, *t),
        lambda: tb.fill_banded_reference(bsw, params, *t), band_cells,
        bound=_fill_bound(bsw, t, tb.fill_banded_bucket_async(
            bsw, params, *t), band_cells))
    # a short kernel: its device time, not the wrapper's, from the profiler
    rec = out["bsw_banded_fill"]
    for key, dirs in (("device_ms", True), ("scores_device_ms", False)):
        rec[key] = device_ms(lambda: tb.fill_banded_bucket_async(
            bsw, params, *t, with_traceback=dirs))
        bound = _fill_bound(bsw, t, tb.fill_banded_bucket_async(
            bsw, params, *t, with_traceback=dirs), band_cells, dirs=dirs)
        rec[key.replace("device_ms", "bound_ms")] = bound[0]
        _say("timing", f"bsw banded fill, {desc}, band {params.band}, dirs "
             f"{'on' if dirs else 'off'}: device {rec[key]:.4f} ms a call "
             f"(profiler); bound {bound[0]:.6f} ms ({bound[1]}), "
             f"{bound[0] / rec[key]:.4f} of it")
    # the same bucket at WIDE_BAND: the slots in the global scratch
    wide = AlignmentParams(band=WIDE_BAND)
    wide_cells = _band_cells(b, WIDE_BAND)

    def wide_fill():
        return tb.fill_banded_bucket_async(bsw, wide, *t)

    rec["wide_device_ms"] = device_ms(wide_fill, reps=2)
    bound = _fill_bound(bsw, t, wide_fill(), wide_cells)
    rec["wide_bound_ms"] = bound[0]
    _say("timing", f"bsw banded fill, {desc}, band {WIDE_BAND} (K8 "
         f"{tb.frame_width(WIDE_BAND)}, slots in the global scratch), dirs "
         f"on: device {rec['wide_device_ms']:.4f} ms a call (profiler), "
         f"{wide_cells / rec['wide_device_ms'] / 1e6:.1f} GCUPS over its "
         f"{wide_cells} band cells; bound {bound[0]:.6f} ms ({bound[1]}), "
         f"{bound[0] / rec['wide_device_ms']:.4f} of it")
    for key, algo, fill in (
            ("stagger_walk", lnw, ts.fill_stagger_bucket_async),
            ("lsw_stagger_walk", Algorithm.LSW, ts.fill_stagger_bucket_async),
            ("anw_stagger_walk", Algorithm.ANW, ts.fill_stagger_bucket_async),
            ("banded_walk", bsw, tb.fill_banded_bucket_async)):
        sc, sr, sj, dirs = fill(algo, params, *t)
        walk_args = (algo, params, dirs, sr, sj, sc, ts.STRIPE_S)
        walked = wk.device_walk(*walk_args)
        out[key] = _in_turns(
            f"{algo.value} walk, {desc}",
            lambda: wk.device_walk(*walk_args),
            lambda: td.device_walk_reference(*walk_args),
            bound=_walk_bound((sc, sr, sj), walked, walked[0]))
        longest = int(td.lane_moves(walked[0]).max())
        _per_move(out[key], lambda: wk.device_walk(*walk_args), longest,
                  f"{algo.value} walk")
        if algo is bsw:  # band 20: two words a lane
            p20 = AlignmentParams(band=20)
            sc, sr, sj, dirs = tb.fill_banded_bucket_async(bsw, p20, *t)
            args20 = (bsw, p20, dirs, sr, sj, sc, ts.STRIPE_S)
            walked = wk.device_walk(*args20)
            rec = {}
            _per_move(rec, lambda: wk.device_walk(*args20),
                      int(td.lane_moves(walked[0]).max()),
                      "bsw walk, band 20")
            out[key]["band20_device_ms"] = rec["device_ms"]
            out[key]["band20_bound_ms"] = _walk_bound(
                (sc, sr, sj), walked, walked[0])[0]
        if algo is lnw:
            _, slots, nev = walked
            compacted = wk.compact_events(slots, nev)
            ev_max = slots.shape[0]

            def library():  # a cumsum and a masked copy
                offs = torch.cumsum(nev, 0)
                keep = (torch.arange(ev_max, device=nev.device)[:, None]
                        < nev[None, :])
                return offs, slots.view(torch.int16).t()[keep.t()]

            total = int(compacted[3])
            out["compact_events"] = _in_turns(
                f"event compaction, {desc}",
                lambda: wk.compact_events(slots, nev),
                lambda: td.compact_events_reference(slots, nev),
                bound=_bound(_nbytes(slots, nev) + 2 * total + 8,
                             total + nev.numel()),
                library=library)
            _per_event(out["compact_events"],
                       lambda: wk.compact_events(slots, nev), total,
                       "event compaction (of the lnw walk)")
    k = out["stagger_walk"]["ms"] + out["compact_events"]["ms"]
    p = out["stagger_walk"]["plain_ms"] + out["compact_events"]["plain_ms"]
    _say("timing", f"lnw walk + compaction, {desc}: kernels {k:.4f} ms, "
         f"plain {p:.4f} ms")
    # B2's bucket modes (the band wavefront): events in turns with the
    # plain version, then the profiler's device time (it counts the
    # launch's memset of the ready words, not the host's launch cost)
    rowscan_modes = [(algo, True) for algo in (lnw, Algorithm.LSW,
                                               Algorithm.ANW, bsw)]
    for algo, dirs in rowscan_modes + [(lnw, False), (Algorithm.LSW, False)]:
        key = (("rowscan_fill" if algo is lnw
                else f"{algo.value}_rowscan_fill") if dirs
               else f"{algo.value}_rowscan_scores")
        n_cells = band_cells if algo is bsw else cells

        def fn():
            return rs.fill_bucket_async(algo, params, *t,
                                        with_traceback=dirs)

        bound = _fill_bound(algo, t, fn(), n_cells, dirs=dirs)
        label = (f"{algo.value} row-sweep fill, {desc}, "
                 + ("dirs on" if dirs else "scores only"))
        out[key] = _in_turns(
            label, fn,
            lambda: rs.fill_rowscan_reference(algo, params, *t,
                                              with_traceback=dirs),
            n_cells, bound=bound)
        dev = out[key]["device_ms"] = device_ms(fn)
        _say("timing", f"{label}: device {dev:.4f} ms a call (profiler), "
             f"{n_cells / dev / 1e6:.1f} GCUPS; bound {bound[0]:.6f} ms "
             f"({bound[1]}), {bound[0] / dev:.4f} of it")
    out["rowscan_scores_wide"] = _wide_scores(params)
    # LSW Hirschberg's end points: a scores-only fill of its 64 pairs
    # (phase 8's inputs), 128 bands a pair
    name, npairs, q, r = LONG_RUNS[3]
    ends = _pair_tensors(_long_pairs(npairs, q, r))
    lsw = Algorithm.LSW
    e_cells = npairs * q * r

    def end_fill():
        return rs.fill_bucket_async(lsw, params, *ends, with_traceback=False)

    bound = _fill_bound(lsw, ends, end_fill(), e_cells, dirs=False)
    label = f"lsw row-sweep end points, {npairs} x {q} x {r}, scores only"
    rec = out["lsw_rowscan_endpoints"] = _in_turns(
        label, end_fill,
        lambda: rs.fill_rowscan_reference(lsw, params, *ends,
                                          with_traceback=False),
        e_cells, reps=3, plain_reps=1, bound=bound)
    dev = rec["device_ms"] = device_ms(end_fill, reps=3)
    _say("timing", f"{label}: device {dev:.4f} ms a call (profiler), "
         f"{e_cells / dev / 1e6:.1f} GCUPS; bound {bound[0]:.6f} ms "
         f"({bound[1]}), {bound[0] / dev:.4f} of it")
    del ends
    levels, rand = split_inputs
    split = levels["split level"]
    q, r = SPLIT_LEVEL
    level = (f"split level of a {q} x {r} pair (2 problems, {q // 2} rows "
             f"x {r} columns)")
    cells = q * r
    for algo in (lnw, Algorithm.ANW):
        ot = (torch.full((2,), params.gap_open, dtype=torch.int32,
                         device=DEVICE) if algo.is_affine else None)
        suffix = "" if algo is lnw else f" {algo.value}"
        rows = _fill_bound(algo, (*split, ot), rs.fill_last_rows_async(
            algo, params, *split, open_top=ot), cells, dirs=False)
        out["rowscan_last_rows" + suffix] = _in_turns(
            f"{algo.value} row-sweep last rows, {level}",
            lambda: rs.fill_last_rows_async(algo, params, *split,
                                            open_top=ot),
            lambda: rs.last_rows_reference(algo, params, *split,
                                           open_top=ot),
            cells, reps=5, plain_reps=1, bound=rows)
        # device time, bound and share at each level of the Hirschberg
        # path (LONG_RUNS' top levels)
        shapes = out["rowscan_last_rows" + suffix]["shapes"] = {}
        for where, lt in levels.items():
            lot = (torch.full((lt[0].shape[0],), params.gap_open,
                              dtype=torch.int32, device=DEVICE)
                   if algo.is_affine else None)
            lcells = int((lt[2].long() * lt[3].long()).sum())

            def fn():
                return rs.fill_last_rows_async(algo, params, *lt,
                                               open_top=lot)

            bound = _fill_bound(algo, (*lt, lot), fn(), lcells, dirs=False)
            dev = device_ms(fn, reps=3)
            shapes[where] = {"problems": lt[0].shape[0],
                             "rows": lt[1].shape[1],
                             "columns": lt[0].shape[1], "device_ms": dev,
                             "bound_ms": bound[0], "bound_by": bound[1],
                             "share": bound[0] / dev}
            _say("timing", f"{algo.value} row-sweep last rows, {where} "
                 f"({lt[0].shape[0]} x {lt[1].shape[1]} x {lt[0].shape[1]}):"
                 f" device {dev:.4f} ms a call (profiler), "
                 f"{lcells / dev / 1e6:.1f} GCUPS; bound {bound[0]:.6f} ms "
                 f"({bound[1]}), {bound[0] / dev:.4f} of it")
        out["stagger_last_rows" + suffix] = _in_turns(
            f"{algo.value} stagger last rows, {level}",
            lambda: ts.fill_stagger_last_rows_async(algo, params, *split,
                                                    open_top=ot),
            lambda: rs.last_rows_reference(algo, params, *split,
                                           open_top=ot),
            cells, reps=5, plain_reps=1, bound=rows)
    hlast, flast = rand[0], rand[1]
    n_rows, k2 = hlast.shape

    def argmax_rows():  # the summed-rows argmax of both passes
        return [torch.argmax(x[:, 0::2] + x[:, 1::2].flip(0), dim=0)
                for x in (hlast, flast)]

    top = f"affine top, {k2 // 2} subs x {n_rows}"
    out["split_reduce"] = _in_turns(
        f"split_reduce, {k2 // 2} subproblems x {n_rows} columns, affine",
        lambda: th.split_reduce(*rand),
        lambda: th.split_reduce_reference(*rand),
        bound=_split_bound(rand), library=argmax_rows)
    shapes = split_reduce_times(split_levels + [(top, rand)])
    out["split_reduce"]["device_ms"] = shapes[top]["device_ms"]
    out["split_reduce"]["shapes"] = shapes
    out["dpx_apply"] = dpx_device_times()
    return out


def _split_bound(args):
    """The split reduction reads, a pass, F's and B's entries of each
    subproblem's min(nn, n) rows (none past its width), the (K,) vectors
    once, and writes (4, K); 3 operations a (k, i) a pass."""
    hlast, flast, _, _, nn, _ = args
    passes = 1 if flast is None else 2
    k = nn.numel()
    rows = int(nn.long().clamp(max=hlast.shape[0]).sum())
    nbytes = passes * 8 * rows + _nbytes(*args[2:]) + 16 * k
    return _bound(nbytes, passes * 3 * (hlast.shape[0] + 1) * k)


def split_reduce_times(cases) -> dict:
    """The split reduction's device time (profiler) on each (label, args)
    of cases, beside its bound: {label: {subs, rows, device_ms, bound_ms,
    bound_by, share}}."""
    from tpu_align_torch.traceback import hirschberg as th

    shapes = {}
    for label, args in cases:
        dev = device_ms(lambda: th.split_reduce(*args))
        bound = _split_bound(args)
        shapes[label] = {"subs": args[2].numel(), "rows": args[0].shape[0],
                         "affine": args[1] is not None, "device_ms": dev,
                         "bound_ms": bound[0], "bound_by": bound[1],
                         "share": bound[0] / dev}
        _say("timing", f"split_reduce, {label}: device {dev:.4f} ms a call "
             f"(profiler); bound {bound[0]:.6f} ms ({bound[1]}), "
             f"{bound[0] / dev:.4f} of it")
    return shapes


def dpx_device_times() -> dict:
    """Each DPX function's device time (profiler) on 2**20 triples, its
    calls rotating through DPX_SETS argument sets that together pass the
    card's L2 in one rotation, beside its bytes bound; then the wrapper's
    host cost a call
    (its broadcast, contiguous, empty and ctypes call), over calls that
    do not wait for the card.  Returns {device_ms (the 36 summed), shapes
    {name: ...}, wrapper_host_ms}."""
    import itertools

    import torch

    from tpu_align_torch.ops import dpx

    rng = np.random.default_rng(1)
    words = [torch.from_numpy(rng.integers(0, 2**32, (3, DPX_N),
                                           dtype=np.uint64)
                              .astype(np.uint32).view(np.int32)).to(DEVICE)
             for _ in range(DPX_SETS)]
    shapes = {}
    sets = {}
    turn = itertools.cycle(range(DPX_SETS))
    for name in dpx.OPS:
        kind, nargs, _ = dpx._TABLE[name]
        sets[name] = [[x if kind == "s32" else x.view(torch.uint32)
                       for x in w[:nargs]] for w in words]
        fn, args = getattr(dpx, name), sets[name]
        dev = device_ms(lambda: fn(*args[next(turn)]), reps=2 * DPX_SETS)
        preds = (2 if "16x2" in name else 1) if name.startswith("vib") else 0
        bound = _bound(((nargs + 1) * 4 + preds) * DPX_N, 2 * DPX_N)
        shapes[name] = {"device_ms": dev, "bound_ms": bound[0],
                        "bound_by": bound[1], "share": bound[0] / dev}
        _say("timing", f"dpx {name}, {DPX_N} triples, {DPX_SETS} argument "
             f"sets in turn: device {dev:.4f} ms a call (profiler); bound "
             f"{bound[0]:.6f} ms ({bound[1]}), {bound[0] / dev:.4f} of it")
    rounds = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(rounds):
        for name in dpx.OPS:
            getattr(dpx, name)(*sets[name][0])
    host = (time.perf_counter() - t0) * 1e3 / (rounds * len(dpx.OPS))
    torch.cuda.synchronize()
    total = sum(v["device_ms"] for v in shapes.values())
    shares = [v["share"] for v in shapes.values()]
    _say("timing", f"dpx: the 36 functions' device times sum to {total:.4f}"
         f" ms; shares of the bound {min(shares):.4f}-{max(shares):.4f}; "
         f"the wrapper's host cost {host:.4f} ms a call")
    return {"device_ms": total, "shapes": shapes, "wrapper_host_ms": host}


def phase_times(e2e: bool = False) -> dict:
    r"""B2's bucket modes and B5 of the tpu_align_torch imported, by
    device_ms, for comparisons of two checkouts in turns on one card
    (parent, change, change, parent); not part of main().  For another
    checkout's package, unpack its tpu_align_torch/ and native/ (the
    package builds its host library from the native/ beside it) into a
    directory and put it first on the path, e.g. from this root:
        PYTHONPATH=build/parent:. python3 -P -c \
            "import chip_smoke as cs; cs.phase_card(); print(cs.phase_times())"
    The shapes: the 2048-pair bucket (`main_path_bucket`) with dirs, all
    four aligners, and scores only, LNW and LSW; LSW scores only at phase
    8's 64 x 16,384^2 (the end points); LNW with dirs on 256 problems of
    256 x 16,384 (short queries against long references); the banded walk
    at bands 16 and 20; the banded fill at band 16, dirs on and off; the
    split reduction at each level of the LNW 64 x 16,384^2 Hirschberg run
    and at the random affine 64 x 16,384 inputs; each DPX function over
    DPX_SETS argument sets.  With e2e, then the BSW run and the -kernel
    rowscan run on the E2E_PAIRS pairs, once to warm up and once profiled
    (device busy, wall).  Returns {label: ms}."""
    from tpu_align_torch import Algorithm, AlignmentParams
    from tpu_align_torch.convert import bucket_to_tensors
    from tpu_align_torch.kernels import banded as tb
    from tpu_align_torch.kernels import fill as rs
    from tpu_align_torch.traceback import walk_kernel as wk
    from tpu_align_torch.utils.synthetic import main_path_bucket

    params = AlignmentParams()
    t = bucket_to_tensors(main_path_bucket(), DEVICE)
    ms = {}

    def timed(label, fn, reps=TIMING_REPS):
        ms[label] = device_ms(fn, reps)
        _say("times", f"{label}: device {ms[label]:.4f} ms a call")

    for algo in (Algorithm.LNW, Algorithm.LSW, Algorithm.ANW,
                 Algorithm.BSW):
        timed(f"{algo.value} dirs",
              lambda: rs.fill_bucket_async(algo, params, *t))
    for algo in (Algorithm.LNW, Algorithm.LSW):
        timed(f"{algo.value} scores",
              lambda: rs.fill_bucket_async(algo, params, *t,
                                           with_traceback=False))
    _, npairs, q, r = LONG_RUNS[3]
    ends = _pair_tensors(_long_pairs(npairs, q, r))
    timed(f"lsw scores {npairs} x {q} x {r}",
          lambda: rs.fill_bucket_async(Algorithm.LSW, params, *ends,
                                       with_traceback=False), reps=3)
    wide = _problems([(256, 16384)] * 256, 7)
    timed("lnw dirs 256 x 256 x 16384",
          lambda: rs.fill_bucket_async(Algorithm.LNW, params, *wide), reps=3)
    del ends, wide
    for band in (16, 20):
        p = AlignmentParams(band=band)
        sc, sr, sj, dirs = tb.fill_banded_bucket_async(Algorithm.BSW, p, *t)
        timed(f"banded walk band {band}",
              lambda: wk.device_walk(Algorithm.BSW, p, dirs, sr, sj, sc, 32))
    for dirs in (True, False):
        timed(f"banded fill band 16 dirs {'on' if dirs else 'off'}",
              lambda: tb.fill_banded_bucket_async(Algorithm.BSW, params, *t,
                                                  with_traceback=dirs))
    cases = _split_levels() + [("affine top, 64 subs x 16384",
                                _split_inputs(64, 16384))]
    for label, v in split_reduce_times(cases).items():
        ms[f"split_reduce {label}"] = v["device_ms"]
    for name, v in dpx_device_times()["shapes"].items():
        ms[f"dpx {name}"] = v["device_ms"]
    if e2e:  # last: after a profiled engine run the profiler drops records
        from tpu_align_torch.runtime.engine import AlignmentEngine
        from tpu_align_torch.utils.synthetic import synthetic_dataset

        ds = synthetic_dataset(E2E_PAIRS, uniform_len=250, seed=42)
        for label, algo, tb_mode, kernel in (
                ("bsw-device", Algorithm.BSW, "device", "auto"),
                ("lnw-host-rowscan", Algorithm.LNW, "host", "rowscan")):
            engine = AlignmentEngine(algo, params, device=DEVICE,
                                     output="blocks", traceback=tb_mode,
                                     kernel=kernel)
            engine.run(ds)
            ms[f"{label} busy"], ms[f"{label} wall"] = _profile(engine, ds,
                                                                label)
    return ms


def phase_dpx():
    """The DPX op layer's main path: every one of its 36 functions called
    on 2**20 random triples on the card (counts set to 0 before, read
    after), then each result against the plain version on the same
    tensors, and the sweep timed against the plain sweep."""
    import torch

    from tpu_align_torch.ops import dpx

    rng = np.random.default_rng(0)
    words = rng.integers(0, 2**32, (3, DPX_N), dtype=np.uint64)
    words = torch.from_numpy(words.astype(np.uint32).view(np.int32)).to(
        DEVICE)
    args = {}
    for name in dpx.OPS:
        kind, nargs, _ = dpx._TABLE[name]
        a = list(words[:nargs])
        args[name] = a if kind == "s32" else [x.view(torch.uint32) for x in a]
    dpx.launches = 0
    got = {name: getattr(dpx, name)(*args[name]) for name in dpx.OPS}
    torch.cuda.synchronize()
    launches = dpx.launches
    if launches != len(dpx.OPS):
        raise AssertionError(f"dpx: {launches} launches for "
                             f"{len(dpx.OPS)} functions")
    def wide(t):  # a value or predicate tensor as int64, uint32 unsigned
        if t.dtype == torch.uint32:
            return t.view(torch.int32).long() & 0xFFFFFFFF
        return t.long()

    err = 0
    for name in dpx.OPS:
        g, w = got[name], dpx.reference(name, *args[name])
        if not isinstance(g, tuple):
            g, w = (g,), (w,)
        if g[0].dtype != w[0].dtype:
            raise AssertionError(f"dpx {name}: {g[0].dtype}, the plain "
                                 f"version {w[0].dtype}")
        for k, (gp, wp) in enumerate(zip(g, w)):
            d = (wide(gp) - wide(wp)).abs().max().item()
            err = max(err, d)
            if d:
                what = "values" if k == 0 else f"predicate {k - 1}"
                raise AssertionError(f"dpx {name}: {what} differ from the "
                                     f"plain version by up to {d}")
    _say("dpx", f"{len(dpx.OPS)} functions on {DPX_N} random triples: "
         f"{launches} launches, every value and predicate equals the plain "
         "version")
    nbytes = 0
    for name in dpx.OPS:
        nbytes += (len(args[name]) + 1) * 4 * DPX_N
        if name.startswith("vib"):
            nbytes += (2 if "16x2" in name else 1) * DPX_N
    timing = _in_turns(
        f"dpx: the 36 functions on {DPX_N} triples",
        lambda: [getattr(dpx, n)(*args[n]) for n in dpx.OPS],
        lambda: [dpx.reference(n, *args[n]) for n in dpx.OPS],
        reps=5, plain_reps=2,
        bound=_bound(nbytes, 2 * len(dpx.OPS) * DPX_N))
    return {"launches": launches, "err": err, **timing}


def phase_s16x2():
    """The s16x2 experiment's main path, exp_s16x2.main() (counts set to 0
    before, read after), then both variants against run_core_reference
    exactly at both widths and on whole-range int32 words, and timed
    beside it."""
    import torch

    from tpu_align_torch.scripts import exp_s16x2 as ex

    ex.int32_launches = ex.packed_launches = 0
    ex.main([])
    torch.cuda.synchronize()
    counts = {"int32": ex.int32_launches, "packed": ex.packed_launches}
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"s16x2 {name}: no launch in main()")
    _say("s16x2", f"main(): {counts['int32']} int32 and {counts['packed']} "
         "packed launches")
    rng = np.random.default_rng(5)
    full = rng.integers(-2**31, 2**31, (ex.S, ex.WIDTHS[0])).astype(np.int32)
    cases = [(f"{b} lanes, the script's inputs", ex.inputs(b))
             for b in ex.WIDTHS]
    cases.append((f"{ex.WIDTHS[0]} lanes, whole-range int32", full))
    errs = {"int32": 0, "packed": 0}
    for label, x in cases:
        x = torch.from_numpy(x).to(DEVICE)
        for packed in (False, True):
            got = ex.run_core(x, packed, ex.STEPS)
            want = ex.run_core_reference(x, packed, ex.STEPS)
            torch.cuda.synchronize()
            d = (got.long() - want.long()).abs().max().item()
            name = "packed" if packed else "int32"
            errs[name] = max(errs[name], d)
            if d:
                raise AssertionError(f"s16x2 {label}, packed={packed}: "
                                     f"differs by up to {d}")
            _say("s16x2", f"{label}, {name}, {ex.STEPS} steps: exact")
    out = {}
    for b in ex.WIDTHS:
        x = torch.from_numpy(ex.inputs(b)).to(DEVICE)
        for packed in (False, True):
            name = "packed" if packed else "int32"
            t = _in_turns(
                f"s16x2 core {name}, {ex.S} x {b} lanes, {ex.STEPS} steps",
                lambda: ex.run_core(x, packed, ex.STEPS),
                lambda: ex.run_core_reference(x, packed, ex.STEPS),
                ex.S * b * ex.STEPS * (2 if packed else 1), reps=8,
                plain_reps=1,
                bound=_bound(2 * _nbytes(x), 2 * x.numel() * ex.STEPS))
            out[(name, b)] = {"launches": counts[name], "err": errs[name],
                              **t}
    for b in ex.WIDTHS:
        ratio = (2 * out[("int32", b)]["ms"]) / out[("packed", b)]["ms"]
        _say("s16x2", f"{b} lanes: packed / int32 cells a second {ratio:.4f}")
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    profile = "--profile" in argv
    if not os.path.isfile(os.path.join(REPO, "tpu_align_torch",
                                       "__init__.py")):
        # alone, without the port, the script has nothing to drive
        raise SystemExit("chip_smoke: no tpu_align_torch package beside "
                         f"{__file__}; run it from the root of a checkout")
    name = phase_card()
    from tpu_align_torch import Algorithm
    from tpu_align_torch.io import BucketSpec, bucketize
    from tpu_align_torch.utils.synthetic import synthetic_dataset

    phase_build()
    dpx_rec = phase_dpx()
    s16 = phase_s16x2()
    t0 = time.perf_counter()
    ds = synthetic_dataset(E2E_PAIRS, uniform_len=250, seed=42)
    main_buckets = bucketize(ds, BucketSpec(batch_pairs=2048))
    _say("setup", f"{E2E_PAIRS} x 250 bp synthetic pairs (seed 42) in "
         f"{time.perf_counter() - t0:.1f} s; {len(main_buckets)} buckets")
    cases = _check_cases(main_buckets)
    fill_err = phase_kernel(cases)
    walk_err = phase_walk(cases)
    pywalk = phase_pywalk(main_buckets)
    phase_goldens()
    runs, profiled = phase_e2e(ds, main_buckets, profile)
    rowscan_err, split_inputs = phase_rowscan(cases, main_buckets)
    hirsch, split_levels = phase_hirschberg()
    times = phase_timing(main_buckets, split_inputs, split_levels)
    phase_profile(ds, profiled)
    phase_parity()
    phase_fuzz()
    phase_mesh(ds)
    if "jax" in sys.modules or "tpu_align" in sys.modules:
        raise AssertionError("jax or the JAX package was imported")
    import torch

    def record(kname, source, replaces, launches, err, t, extra=None):
        if launches <= 0:
            raise AssertionError(f"{kname}: no launch on its main path")
        return {"name": kname, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"],
                **(extra or {}),
                **{k: t[k] for k in ("device_ms", "longest_lane_moves",
                                     "ns_per_move", "events",
                                     "ns_per_event", "scores_device_ms",
                                     "scores_bound_ms", "shapes",
                                     "band20_device_ms", "band20_bound_ms",
                                     "wide_device_ms", "wide_bound_ms",
                                     "wrapper_host_ms")
                   if k in t}}

    def fill_errs(algo):
        return max(e for (a, _), e in fill_err.items() if a is algo)

    def pywalk_launches(kind, *algos):
        return {"pywalk_launches": sum(pywalk[a][kind] for a in algos)}

    csrc = "tpu_align_torch/csrc/"
    long_lnw = "lnw {} x ({} x {})".format(*LONG_RUNS[1][1:])
    long_anw = "anw {} x ({} x {})".format(*LONG_RUNS[2][1:])
    long_lsw = "lsw {} x ({} x {})".format(*LONG_RUNS[3][1:])
    stagger_tpu = "tpu_align/kernels/stagger.py:109"
    walk_tpu = "tpu_align/traceback/walk_kernel.py:87"
    b6 = "scripts/exp_s16x2.py:96"
    jax_width = min(w for _, w in s16)
    print(json.dumps({"kernels": [
        record("lnw_stagger_fill", csrc + "stagger_fill.cu", stagger_tpu,
               runs["lnw-device"]["stagger_fill"], fill_errs(Algorithm.LNW),
               times["lnw_stagger_fill 2048-pair"]),
        record("lsw_stagger_fill", csrc + "stagger_fill.cu", stagger_tpu,
               runs["lsw-device"]["stagger_fill"], fill_errs(Algorithm.LSW),
               times["lsw_stagger_fill"]),
        record("stagger_walk", csrc + "stagger_walk.cu", walk_tpu,
               runs["lnw-device"]["walk"],
               max(walk_err[Algorithm.LNW], walk_err[Algorithm.LSW]),
               times["stagger_walk"],
               pywalk_launches("walk", Algorithm.LNW, Algorithm.LSW)),
        record("compact_events", csrc + "stagger_walk.cu",
               "tpu_align/traceback/device.py:313",
               runs["lnw-device"]["compact"], max(walk_err.values()),
               times["compact_events"],
               pywalk_launches("compact", *Algorithm)),
        record("anw_stagger_fill", csrc + "stagger_fill.cu", stagger_tpu,
               runs["anw-device"]["stagger_fill"], fill_errs(Algorithm.ANW),
               times["anw_stagger_fill"]),
        record("bsw_banded_fill", csrc + "banded_fill.cu",
               "tpu_align/kernels/banded.py:81",
               runs["bsw-device"]["banded_fill"], fill_errs(Algorithm.BSW),
               times["bsw_banded_fill"]),
        record("anw_stagger_walk", csrc + "stagger_walk.cu", walk_tpu,
               runs["anw-device"]["walk"], walk_err[Algorithm.ANW],
               times["anw_stagger_walk"],
               pywalk_launches("walk", Algorithm.ANW)),
        record("banded_walk", csrc + "stagger_walk.cu",
               "tpu_align/traceback/walk_kernel.py:258",
               runs["bsw-device"]["walk"], walk_err[Algorithm.BSW],
               times["banded_walk"],
               pywalk_launches("walk", Algorithm.BSW)),
        record("rowscan_fill", csrc + "rowscan_fill.cu",
               "tpu_align/kernels/fill.py:237",
               runs["lnw-host-rowscan"]["rowscan_fill"],
               rowscan_err["rowscan_fill"], times["rowscan_fill"],
               {"scores_256_rows": times["rowscan_scores_wide"]}),
        record("lsw_rowscan_endpoints", csrc + "rowscan_fill.cu",
               "tpu_align/kernels/fill.py:237",
               hirsch[long_lsw]["rowscan_fill"],
               rowscan_err["lsw_rowscan_endpoints"],
               times["lsw_rowscan_endpoints"]),
        record("rowscan_last_rows", csrc + "rowscan_fill.cu",
               "tpu_align/kernels/fill.py:237",
               hirsch[long_lnw]["rowscan_last_rows"],
               rowscan_err["rowscan_last_rows"], times["rowscan_last_rows"]),
        record("anw_rowscan_last_rows", csrc + "rowscan_fill.cu",
               "tpu_align/kernels/fill.py:237",
               hirsch[long_anw]["rowscan_last_rows"],
               rowscan_err["rowscan_last_rows"],
               times["rowscan_last_rows anw"]),
        record("stagger_last_rows", csrc + "stagger_fill.cu", stagger_tpu,
               hirsch["lnw-stagger"]["stagger_last_rows"],
               rowscan_err["stagger_last_rows"], times["stagger_last_rows"]),
        record("split_reduce", csrc + "split_reduce.cu",
               "tpu_align/traceback/hirschberg.py:116",
               hirsch[long_lnw]["split_reduce"],
               rowscan_err["split_reduce"], times["split_reduce"]),
        record("s16x2_core_int32", csrc + "s16x2_core.cu", b6,
               s16[("int32", jax_width)]["launches"],
               s16[("int32", jax_width)]["err"], s16[("int32", jax_width)]),
        record("s16x2_core_packed", csrc + "s16x2_core.cu", b6,
               s16[("packed", jax_width)]["launches"],
               s16[("packed", jax_width)]["err"], s16[("packed", jax_width)]),
        record("dpx_apply", csrc + "dpx_apply.cu", "tpu_align/ops/dpx.py:90",
               dpx_rec["launches"], dpx_rec["err"],
               {**dpx_rec, **times["dpx_apply"]}),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
