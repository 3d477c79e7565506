"""Where the band wavefront (B2) overtakes the stagger fill (B1) on the
card, scores only: the grid that `distributed/sharding.py` `pick_fill`'s
rule was read from.

B1 (csrc/stagger_fill.cu) runs one warp a pair, its 128-row bands in
order, so a launch takes its longest pair's rows x columns at one warp's
speed however few pairs it holds; B2 (csrc/rowscan_fill.cu
`band_fill_kernel`) puts each band (128 rows, or 256 where
`kernels/fill.py` `band_rows` takes them) on its own warp, band k+1
trailing band k, so a few long pairs fill the card too.
For each aligner, pair length L (query and reference both L bp, the query
the reference with 1 % substitutions) and pairs per bucket, both wrappers
are timed as the engine calls them (`fill_stagger_bucket_async`,
`kernels/fill.py` `fill_bucket_async`, `with_traceback=False`) with CUDA
events around each call, after a warm-up call of each, in turns (B1, B2,
B2, B1); a kernel's time is the median of its calls.  Each line also
gives what `pick_fill` picks there on this card.

Prints one JSON line a grid cell, then a table; `--json PATH` also writes
the lines there.  It needs a CUDA card.

Run: python -m tpu_align_torch.scripts.fill_crossover [--json PATH]
        [--quick]
(--quick: one aligner, two lengths, three pair counts -- a first check.)
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

from tpu_align_torch.core.params import Algorithm, AlignmentParams
from tpu_align_torch.distributed.sharding import pick_fill
from tpu_align_torch.kernels import fill as rowscan
from tpu_align_torch.kernels.stagger import fill_stagger_bucket_async

PAIRS = (1, 8, 64, 256, 549, 1024, 2048)
LENGTHS = (250, 1000, 4000, 16384)
# (aligner, lengths): LNW throughout, LSW and ANW at both ends
GRID = ((Algorithm.LNW, LENGTHS), (Algorithm.LSW, (250, 16384)),
        (Algorithm.ANW, (250, 16384)))
QUICK = ((Algorithm.LNW, (250, 16384)),)
QUICK_PAIRS = (1, 549, 2048)
# calls a turn: enough that a turn takes about TURN_S, at least MIN_REPS
TURN_S = 0.25
MIN_REPS, MAX_REPS = 2, 32


def card() -> dict:
    """The card's name, power limit and SM count."""
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name, limit = (s.strip() for s in line.rsplit(",", 1))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return {"card": name, "power_limit": limit, "sms": sms}


def bucket(pairs: int, length: int, seed: int = 0):
    """(ref, qry, rlen, qlen) tensors on the card: random references of
    `length` bp, queries with 1 % of their bases substituted."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    ref = bases[rng.integers(0, 4, (pairs, length))]
    qry = ref.copy()
    hit = rng.random(qry.shape) < 0.01
    qry[hit] = bases[(rng.integers(1, 4, int(hit.sum()))
                      + np.searchsorted(bases, qry[hit])) % 4]
    lens = torch.full((pairs,), length, dtype=torch.int32, device="cuda")
    return (torch.from_numpy(ref).cuda(), torch.from_numpy(qry).cuda(),
            lens, lens.clone())


def _time(call, reps: int) -> list[float]:
    """ms of each of `reps` calls, by CUDA events around each."""
    out = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        call()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


def measure(algo: Algorithm, length: int, pairs: int, sms: int) -> dict:
    params = AlignmentParams()
    tensors = bucket(pairs, length)
    calls = {
        "stagger": lambda: fill_stagger_bucket_async(
            algo, params, *tensors, with_traceback=False),
        "rowscan": lambda: rowscan.fill_bucket_async(
            algo, params, *tensors, with_traceback=False),
    }
    first = {k: _time(c, 1)[0] for k, c in calls.items()}  # warm-up
    reps = {k: int(min(MAX_REPS, max(MIN_REPS, TURN_S * 1e3 / max(ms, 1e-3))))
            for k, ms in first.items()}
    # both kernels must agree before their times mean anything
    outs = {k: [t.cpu() for t in c()[:3]] for k, c in calls.items()}
    if not all(torch.equal(a, b) for a, b in zip(outs["stagger"],
                                                  outs["rowscan"])):
        raise SystemExit(f"{algo.value} L={length} pairs={pairs}: the two "
                         "fills disagree")
    ms = {k: [] for k in calls}
    for k in ("stagger", "rowscan", "rowscan", "stagger"):
        ms[k] += _time(calls[k], reps[k])
    b1, b2 = (statistics.median(ms[k]) for k in ("stagger", "rowscan"))
    cells = pairs * length * length
    calls["rowscan"]()
    rows = rowscan.launch_band_rows  # the band size B2's launches took
    return {"aligner": algo.value, "length": length, "pairs": pairs,
            "bands": -(-length // 128), "b2_band_rows": rows,
            "pairs_per_sm": pairs / sms,
            "b1_ms": b1, "b2_ms": b2, "b1_over_b2": b1 / b2,
            "b1_gcups": cells / b1 / 1e6, "b2_gcups": cells / b2 / 1e6,
            "reps": [reps["stagger"] * 2, reps["rowscan"] * 2],
            "picks": pick_fill(algo, False, length, pairs, sms)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write the JSON lines here")
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fill_crossover needs a CUDA card", file=sys.stderr)
        return 1
    info = card()
    print(json.dumps(info), flush=True)
    grid, pair_counts = (QUICK, QUICK_PAIRS) if args.quick else (GRID, PAIRS)
    lines = []
    for algo, lengths in grid:
        for length in lengths:
            for pairs in pair_counts:
                rec = {**measure(algo, length, pairs, info["sms"]), **info}
                lines.append(rec)
                print(json.dumps(rec), flush=True)
                torch.cuda.empty_cache()
    if args.json:
        with open(args.json, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in lines)
    print("| aligner | L | pairs | B1 ms | B2 ms | B1/B2 | B2 rows | picks |")
    print("|---|---|---|---|---|---|---|---|")
    for r in lines:
        print(f"| {r['aligner']} | {r['length']} | {r['pairs']} | "
              f"{r['b1_ms']:.4f} | {r['b2_ms']:.4f} | "
              f"{r['b1_over_b2']:.2f} | {r['b2_band_rows']} | "
              f"{r['picks']} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
