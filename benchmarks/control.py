"""The control: the reference in the program's place, computed in a
narrower score type than the program's int32, through a whole run of a
cell (warm-up, window, check).  Its run has to come out not correct.

    python3 -m benchmarks.control --workload <cell> --seeds 1,2,3 \\
        --dtype int16 --seconds 4

The next type down from int32 is int16.  Where every score of a cell fits
in int16 (roofline.fits_int16: the 250 bp reads), int16 computes the same
numbers exactly, so it is no control there and the next one down, int8,
is; this script reads both where asked.  It prints each seed's compared
numbers as one JSON line.  The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import types
from pathlib import Path

import numpy as np

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmarks import checks, harness, reference  # noqa: E402
from benchmarks import traffic as traffic_gen  # noqa: E402


class Control:
    """The reference at `dtype` with the program's interface: a traceback
    cell's blocks from its walk, any other cell's blocks carrying its
    scores (header and three empty lines), which is all the check of a
    score needs."""

    def __init__(self, cell, pool, device: str, dtype):
        import torch

        self.cell, self.pool, self.device, self.dtype = cell, pool, device, \
            dtype
        self.devices = ([torch.device(device)]
                        if torch.device(device).type == "cuda" else [])

    def sync(self) -> None:
        import torch

        for d in self.devices:
            torch.cuda.synchronize(d)

    def run(self, slot: int):
        aligner = self.cell.config["aligner"]
        scoring = self.cell.config["scoring"]
        pairs = traffic_gen.pairs_of(self.pool[slot])
        if checks.mode(self.cell.traffic) == "blocks":
            out, _ = reference.blocks(aligner, scoring, pairs, self.device,
                                      self.dtype)
        else:
            best = reference.scores(aligner, scoring, pairs, self.device,
                                    self.dtype)
            out = [b"%d | %d\n\n\n\n" % (k, s) for k, s in enumerate(best)]
        self.sync()
        return types.SimpleNamespace(
            blocks=np.frombuffer(b"".join(out), np.uint8),
            timer=types.SimpleNamespace(seconds={}))

    def peak_bytes(self) -> int:
        import torch

        return max((torch.cuda.max_memory_allocated(d) for d in self.devices),
                   default=0)


def control_run(cell, seed: int, seconds: float, dtype, device: str,
                bench: dict, log=print) -> dict:
    """One run of `cell` with the control in the program's place."""
    return harness.run(cell, seed, seconds, False, device, bench,
                       time.perf_counter(), log,
                       make_program=lambda c, p, d: Control(c, p, d, dtype))


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--dtype", default="int16",
                    help="comma-separated torch integer types")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    bench = harness._json(harness.HERE.parent / "BENCHMARK.json")
    cell = harness.load_cell(args.workload)
    for name in args.dtype.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            res = control_run(cell, seed, args.seconds,
                              getattr(torch, name), "cuda", bench,
                              lambda m: print(m, file=sys.stderr))
            print(json.dumps({"workload": cell.name, "dtype": name,
                              "seed": seed, "correct": res["correct"],
                              "checks": res["checks"],
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
