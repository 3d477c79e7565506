"""Command-line entry point of the PyTorch port (`tpu-align-torch`).

Same flags and defaults as tpu_align/cli.py (the c++/main.cpp
equivalent), plus -device (default cuda).  Runs the four aligners
(-algorithm lnw, lsw, anw, bsw) with -traceback host, device or
hirschberg, and -kernel auto, stagger or rowscan; -all-paths prints
every co-optimal path (lnw, lsw, bsw; computed on the host, as in the JAX
package).  -mesh N runs each bucket data-parallel over N devices of
-device's type (N CPU shards with -device cpu).  -trace FILE writes the
run's phase spans and fill counters as Chrome trace JSON.

Usage:
    python -m tpu_align_torch -pairs input.txt -match 3 -mismatch -1 -gap -2
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from tpu_align_torch.core.params import Algorithm, AlignmentParams
from tpu_align_torch.distributed import make_pairs_mesh
from tpu_align_torch.io.bucketing import BucketSpec
from tpu_align_torch.io.dataset import parse_pair_file
from tpu_align_torch.runtime import profiler
from tpu_align_torch.runtime.engine import AlignmentEngine


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu_align_torch",
        description="Pairwise sequence alignment on PyTorch + CUDA",
    )
    p.add_argument("-pairs", required=True, help="3-line-per-pair input file")
    p.add_argument("-algorithm", default="lnw",
                   choices=[a.value for a in Algorithm],
                   help="lnw, lsw, anw (affine gaps, -open/-extend) or "
                        "bsw (banded, -band)")
    p.add_argument("-match", type=int, default=3)
    p.add_argument("-mismatch", type=int, default=-1)
    p.add_argument("-gap", type=int, default=-2)
    p.add_argument("-open", dest="gap_open", type=int, default=-4)
    p.add_argument("-extend", dest="gap_extend", type=int, default=-1)
    p.add_argument("-band", type=int, default=16, help="BSW band half-width")
    p.add_argument("-batch-pairs", type=int, default=2048,
                   help="pairs per kernel batch (V19 BATCH_SIZE analogue)")
    p.add_argument("-scores-only", action="store_true",
                   help="skip traceback (V6-style fast path)")
    p.add_argument("-all-paths", action="store_true",
                   help="emit every co-optimal path (lnw, lsw, bsw; "
                        "filled and walked on the host)")
    p.add_argument("-traceback", default="host",
                   choices=["host", "device", "hirschberg"],
                   help="walk packed directions on the host (threaded "
                        "native walker) or on the card (the walk and event "
                        "compaction kernels; only events cross to the "
                        "host), or hirschberg: no direction storage, "
                        "O(M+N) memory for long pairs (lnw, lsw, anw)")
    p.add_argument("-walker", default="xla", choices=["xla", "pallas"],
                   help="the JAX package's device-walk engine; both values "
                        "run the one CUDA walk kernel here, and give the "
                        "same output (ignored with -traceback host)")
    p.add_argument("-kernel", default="auto",
                   choices=["auto", "stagger", "rowscan"],
                   help="fill formulation for lnw, lsw and anw: stagger "
                        "(anti-diagonal, one warp a pair) or rowscan (the "
                        "band wavefront, one warp a 128-row band; host "
                        "traceback); auto = rowscan for a scores-only "
                        "bucket of long pairs (8+ bands, under 16 pairs a "
                        "SM), else stagger; bsw always takes the banded "
                        "fill")
    p.add_argument("-stripe", type=int, default=0, metavar="S",
                   help="stagger stripe width: query rows per stripe of "
                        "the direction layout; 0 = 32")
    p.add_argument("-max-inflight", type=int, default=4,
                   help="bucket fills outstanding at once (V13 "
                        "STREAM_BATCH_SIZE analogue; 0 = unbounded)")
    p.add_argument("-no-output", action="store_true",
                   help="suppress per-pair blocks; print stats only")
    p.add_argument("-output", default="auto",
                   choices=["auto", "records", "blocks"],
                   help="result assembly: per-pair records or the native "
                        "block formatter (byte-identical output); "
                        "auto = blocks")
    p.add_argument("-out", default=None, help="write output blocks to file")
    p.add_argument("-checkpoint-dir", default=None,
                   help="persist per-batch results; re-runs resume from here")
    p.add_argument("-mesh", type=int, default=0, metavar="N",
                   help="run data-parallel over N local devices (0 = single "
                        "device; -1 = all).  Fills -- and device walks -- "
                        "run a shard of each bucket on each device; output "
                        "is byte-identical to the single-device run.  With "
                        "-device cpu, N CPU shards")
    p.add_argument("-device", default="cuda",
                   help="torch device: cuda, cuda:N, or cpu (every "
                        "kernel's plain PyTorch version)")
    p.add_argument("-trace", default=None, metavar="FILE",
                   help="record the run's phase spans (each with its "
                        "parent, batch and bucket) and the fill launches' "
                        "counters, and write them to FILE as Chrome trace "
                        "JSON (chrome://tracing, Perfetto); times on the "
                        "monotonic clock, with the realtime and monotonic "
                        "clocks read as the run began, which put the spans "
                        "beside a torch.profiler trace")
    return p


def _mesh(n: int, device: str):
    """The -mesh N mesh on -device's type: None for 0; N (-1: every
    visible) CUDA devices, or N CPU shards (-1: the one CPU device)."""
    if not n:
        return None
    if torch.device(device).type == "cpu":
        return make_pairs_mesh(["cpu"] * (1 if n < 0 else n))
    if n < 0:
        return make_pairs_mesh()
    try:
        return make_pairs_mesh([torch.device("cuda", i) for i in range(n)])
    except ValueError as e:
        raise ValueError(f"-mesh {n}: {e}") from None


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    algorithm = Algorithm(args.algorithm)
    params = AlignmentParams(
        match=args.match, mismatch=args.mismatch, gap=args.gap,
        gap_open=args.gap_open, gap_extend=args.gap_extend, band=args.band,
    )
    output = "blocks" if args.output == "auto" else args.output
    if args.all_paths and algorithm is Algorithm.ANW:
        print("-all-paths supports lnw (all co-optimal global paths, "
              "python/LinearNeedlemanWunsch.py:98-191) and lsw/bsw "
              "(BACKTRACK_ALL), not anw", file=sys.stderr)
        return 2
    if args.mesh and (args.all_paths or args.traceback == "hirschberg"):
        print("-mesh covers the bucketed kernel path; -all-paths and "
              "-traceback hirschberg run unsharded -- drop -mesh for "
              "those modes", file=sys.stderr)
        return 2
    try:
        mesh = _mesh(args.mesh, args.device)
        engine = AlignmentEngine(
            algorithm, params,
            bucket_spec=BucketSpec(batch_pairs=args.batch_pairs),
            with_traceback=not args.scores_only,
            local_mode="all" if args.all_paths else "single",
            max_inflight=args.max_inflight,
            kernel=args.kernel,
            traceback=args.traceback,
            walker=args.walker,
            output=output,
            mesh=mesh,
            stripe_s=args.stripe or None,
            device=args.device,
        )
    except (ValueError, RuntimeError) as e:
        print(f"tpu_align_torch: {e}", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    ds = parse_pair_file(args.pairs)
    parse_s = time.perf_counter() - t0
    st = ds.stats()
    timer = None
    if args.trace:
        profiler.reset_launch_counts()
        timer = profiler.PhaseTimer(record=True)
    out = engine.run(ds, checkpoint_dir=args.checkpoint_dir, timer=timer)
    if args.trace:
        with open(args.trace, "w") as f:
            json.dump(profiler.chrome_trace(timer,
                                            profiler.launch_counts()), f)
    if not args.no_output:
        data = out.output_bytes()
        if args.out:
            with open(args.out, "wb") as f:
                f.write(data)
        else:
            sys.stdout.buffer.write(data)
            sys.stdout.flush()
    # dataset banner + phase timers, after the blocks like the reference
    # (cuda/LNW/LinearNeedlemanWunschV19.cu:662-680)
    err = sys.stderr
    print(f"Number of pairs: {st.num_pairs}", file=err)
    print(f"Total number of cells: {st.num_cells}", file=err)
    print(f"Reference length min/max/avg: {st.min_reference_length}/"
          f"{st.max_reference_length}/{st.avg_reference_length:.1f}", file=err)
    print(f"Query length min/max/avg: {st.min_query_length}/"
          f"{st.max_query_length}/{st.avg_query_length:.1f}", file=err)
    print(f"{'parse':>12}: {parse_s * 1e6:14.1f} us", file=err)
    print(out.timer.report(sub_spans=False), file=err)
    if out.timer.seconds.get("kernel"):
        print(f"GCUPS (kernel): {out.gcups:.3f}", file=err)
    else:
        # device-traceback runs never wait in a host-visible kernel phase
        # (the fill and walk overlap dispatch and backtrack)
        print("GCUPS (kernel): n/a (device-overlapped; see total)",
              file=err)
    return 0


if __name__ == "__main__":
    sys.exit(main())
