"""One run of one cell: set-up, the timed window, the traced window's
reading, the check against the reference, and the result line.

A cell is found by name: benchmarks/workloads/<cell>.json names its
configuration (benchmarks/configs/<config>.json) and holds its traffic.
BENCHMARK.json, beside this folder, says which of its metrics a cell
reports.  The per-layer metrics are read by benchmarks/metrics/<name>.py,
each a `read(ctx)` that returns a number or None.  A metric's name is
its quantity, or its quantity and a group after a dot (`pairs_per_s.scores`
is pairs_per_s in the cells it lists, under a bound of its own): the
reader is metrics/<name>.py, or else metrics/<quantity>.py.

The window is a closed loop with one client: the pool's batches go back
to back through AlignmentEngine.run, each ending when its blocks are back
and the card is synchronised.  It runs from the first batch handed over
after warm-up to the end of the last batch started within --seconds.  A
traced run (--trace 1) runs that window, whose program spans give the
span metrics, and then a second one under torch.profiler recording CUDA
activity alone, which gives the device metrics.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import os
import sys
import time
import types
from collections import Counter, defaultdict
from pathlib import Path

import numpy as np

from benchmarks import checks, reference, roofline, traffic as traffic_gen

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_align")
CONFIG_KEYS = {"aligner", "scoring", "precision", "reference_length",
               "mutation", "source", "assumed", "reduced", "guarantee"}
SCORING = {"match": 3, "mismatch": -1, "gap": -2, "gap_open": -4,
           "gap_extend": -1, "band": 16}
TRAFFIC = {"batch_pairs": None, "pool_batches": None, "traceback": "device",
           "kernel": "auto", "with_traceback": True, "mesh": 1,
           "check_pairs": None}
CELL_KEYS = {"config", "traffic", "chips", "why"}
# the window's outputs the check compares: each batch of the pool's first
# pass, then each later batch with this chance, up to KEEP_MAX passes' worth
KEEP_SHARE = 1 / 16
KEEP_MAX = 2


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _exact_keys(what: str, got: dict, allowed: set) -> None:
    extra = set(got) - allowed
    if extra:
        raise ValueError(f"{what}: unknown keys {sorted(extra)}")


def load_cell(name: str, root: Path = HERE) -> types.SimpleNamespace:
    """The cell `name`: its workload file, its configuration and its
    traffic with defaults filled in."""
    cell = _json(root / "workloads" / f"{name}.json")
    _exact_keys(f"workload {name}", cell, CELL_KEYS)
    config = _json(root / "configs" / f"{cell['config']}.json")
    _exact_keys(f"config {cell['config']}", config, CONFIG_KEYS)
    _exact_keys(f"scoring of {cell['config']}", config["scoring"],
                set(SCORING))
    config["scoring"] = {**SCORING, **config["scoring"]}
    _exact_keys(f"traffic of {name}", cell["traffic"], set(TRAFFIC))
    traffic = {**TRAFFIC, **cell["traffic"]}
    missing = [k for k, v in traffic.items() if v is None and k in
               ("batch_pairs", "pool_batches")]
    if missing:
        raise ValueError(f"traffic of {name}: missing {missing}")
    if traffic["mesh"] != cell["chips"]:
        raise ValueError(f"{name}: a mesh of {traffic['mesh']} on "
                         f"{cell['chips']} chips (each chip a shard)")
    return types.SimpleNamespace(name=name, config=config, traffic=traffic,
                                 chips=cell["chips"], why=cell["why"])


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics BENCHMARK.json has this cell report: the end-to-end
    ones untraced, the per-layer ones traced."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def quantity(name: str) -> str:
    """The quantity a metric's name measures: the name up to its first
    dot."""
    return name.split(".")[0]


def read_metric(name: str, ctx, root: Path = HERE):
    """Run the metric's reader on ctx: benchmarks/metrics/<name>.py, or
    else benchmarks/metrics/<quantity>.py."""
    path = root / "metrics" / f"{name}.py"
    if not path.exists():
        path = root / "metrics" / f"{quantity(name)}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmarks.metrics.{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(ctx)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, JAX's libraries' or
    the JAX package's, compared whole (tpu_align_torch is not tpu_align)."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def _keep_plan(seed: int, pool: int):
    rng = traffic_gen.rng_for(seed, 1)
    kept = 0

    def keep(k: int) -> bool:
        nonlocal kept
        if kept >= KEEP_MAX * pool or (k >= pool
                                       and rng.random() >= KEEP_SHARE):
            return False
        kept += 1
        return True

    return keep


class _Program:
    """The system under test: the engine for the cell's traffic, and the
    pool as the program's datasets."""

    def __init__(self, cell, pool, device: str):
        import torch

        from tpu_align_torch import Algorithm, AlignmentParams
        from tpu_align_torch.distributed import make_pairs_mesh
        from tpu_align_torch.io import PairDataset
        from tpu_align_torch.runtime.engine import AlignmentEngine

        t = cell.traffic
        kind = torch.device(device).type
        mesh = None
        if t["mesh"] > 1:
            names = ([f"cuda:{i}" for i in range(t["mesh"])] if kind == "cuda"
                     else ["cpu"] * t["mesh"])
            mesh = make_pairs_mesh(names)
        self.devices = ([torch.device("cuda", i) for i in range(t["mesh"])]
                        if kind == "cuda" else [])
        self.engine = AlignmentEngine(
            Algorithm(cell.config["aligner"]),
            AlignmentParams(**cell.config["scoring"]),
            with_traceback=t["with_traceback"], kernel=t["kernel"],
            traceback=t["traceback"], output="blocks", mesh=mesh,
            device=device)
        self.datasets = [PairDataset(*b) for b in pool]

    def sync(self) -> None:
        import torch

        for d in self.devices:
            torch.cuda.synchronize(d)

    def run(self, slot: int):
        out = self.engine.run(self.datasets[slot])
        self.sync()
        return out

    def peak_bytes(self) -> int:
        import torch

        return max((torch.cuda.max_memory_allocated(d) for d in self.devices),
                   default=0)


def _window(program, pool: int, seconds: float, keep, spans=None) -> dict:
    """Batches back to back, cycling through the pool, until the first
    one that would start after `seconds`."""
    lat, kept, runs = [], [], Counter()
    phase_s: dict[str, float] = defaultdict(float)
    span = spans or (lambda name: contextlib.nullcontext())
    start = time.perf_counter()
    end = start
    k = 0
    with span("bench.window"):
        while k == 0 or time.perf_counter() - start < seconds:
            slot = k % pool
            t0 = time.perf_counter()
            with span("bench.batch"):
                out = program.run(slot)
            end = time.perf_counter()
            lat.append(end - t0)
            runs[slot] += 1
            for name, s in out.timer.seconds.items():
                phase_s[name] += s
            if keep(k):
                kept.append((slot, out.blocks))
            k += 1
    return {"latency_s": lat, "window_s": end - start, "runs": runs,
            "kept": kept, "phase_s": dict(phase_s)}


def _traced_window(program, pool, seconds, keep) -> dict:
    """A second window under torch.profiler, CUDA activity alone: the
    host pays only the launches' records.  The benchmark's window and
    batches and the program's PhaseTimer phases are taken on the host's
    clock beside it, to label the device's idle gaps."""
    from torch.profiler import ProfilerActivity, profile

    from benchmarks import trace
    from tpu_align_torch.runtime import profiler as program_profiler

    timer = program_profiler.PhaseTimer
    plain_phase = timer.phase
    spans = []

    @contextlib.contextmanager
    def span(name):
        t0 = time.time_ns()
        try:
            yield
        finally:
            spans.append((t0, time.time_ns(), name))

    @contextlib.contextmanager
    def phase(self, name):
        with span(f"phase.{name}"), plain_phase(self, name):
            yield

    program_profiler.reset_launch_counts()
    timer.phase = phase
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            clocks = {"realtime": time.time_ns(),
                      "monotonic": time.monotonic_ns()}
            program.sync()
            win = _window(program, pool, seconds, keep, span)
    finally:
        timer.phase = plain_phase
    win["launches"] = program_profiler.launch_counts()
    t0 = time.perf_counter()
    win["trace"] = trace.read(prof, spans, clocks)
    win["trace_read_s"] = time.perf_counter() - t0
    return win


def check(cell, pool, kept, seed: int, device: str) -> dict:
    """The compared numbers of the kept outputs against the reference,
    and the walk's counts a pool batch for the walk roofline."""
    aligner = cell.config["aligner"]
    scoring = cell.config["scoring"]
    mode = checks.mode(cell.traffic)
    by_slot = defaultdict(list)
    for slot, blocks in kept:
        by_slot[slot].append(blocks)
    numbers = {"blocks_wrong": 0} if mode == "blocks" else (
        {"score_gap": 0, "bad_alignments": 0} if mode == "alignment"
        else {"scores_wrong": 0})
    walks = {}
    failed = 0
    if mode == "blocks":
        for slot in sorted(by_slot):
            expected, walks[slot] = reference.blocks(
                aligner, scoring, traffic_gen.pairs_of(pool[slot]), device)
            for got in by_slot[slot]:
                wrong = checks.blocks_wrong(got, expected)
                numbers["blocks_wrong"] += wrong
                failed += wrong
        return {"numbers": numbers, "walks": walks, "failed": failed}
    slots = sorted(by_slot)
    pairs = {s: traffic_gen.pairs_of(pool[s]) for s in slots}
    sample = {}
    rng = traffic_gen.rng_for(seed, 2)
    for s in slots:
        n = len(pairs[s])
        want = cell.traffic["check_pairs"]
        sample[s] = (list(range(n)) if mode == "alignment" or not want
                     or want >= n else
                     sorted(rng.choice(n, want, replace=False).tolist()))
    flat = [pairs[s][k] for s in slots for k in sample[s]]
    best = reference.scores(aligner, scoring, flat, device)
    at = 0
    for s in slots:
        want = best[at:at + len(sample[s])]
        at += len(sample[s])
        for got in by_slot[s]:
            if mode == "alignment":
                got_numbers = checks.alignment_numbers(aligner, scoring, got,
                                                       pairs[s], want)
                numbers["score_gap"] = max(numbers["score_gap"],
                                           got_numbers["score_gap"])
                numbers["bad_alignments"] += got_numbers["bad_alignments"]
                failed += got_numbers["bad_alignments"]
            else:
                wrong = checks.scores_wrong(got, sample[s], want,
                                            len(pairs[s]))
                numbers["scores_wrong"] += wrong
                failed += wrong
    return {"numbers": numbers, "walks": walks, "failed": failed}


def _work(cell, pool, runs, walks) -> dict:
    """The fills' and walks' work over the window's batches, and the peak
    rate their bound takes."""
    aligner = cell.config["aligner"]
    scoring = cell.config["scoring"]
    t = cell.traffic
    fill_ops = fill_bytes = walk_ops = walk_bytes = 0
    fits = True
    for slot, n in runs.items():
        rlen, qlen = pool[slot][2], pool[slot][4]
        fits &= roofline.fits_int16(aligner, scoring, rlen, qlen)
        ops, nbytes = roofline.fill_work(aligner, scoring, rlen, qlen,
                                         t["with_traceback"])
        fill_ops += n * ops
        fill_bytes += n * nbytes
        if slot in walks and t["traceback"] == "device":
            ops, nbytes = roofline.walk_work(walks[slot]["moves"],
                                             walks[slot]["gaps"], len(rlen))
            walk_ops += n * ops
            walk_bytes += n * nbytes
    return {"fill_ops": fill_ops, "fill_bytes": fill_bytes,
            "walk_ops": walk_ops, "walk_bytes": walk_bytes,
            "ops_s": roofline.INT16X2_OPS_S if fits else roofline.INT32_OPS_S,
            "peak": "int16x2" if fits else "int32"}


def run(cell, seed: int, seconds: float, trace: bool, device: str,
        bench: dict, t_start: float, log=print, make_program=None) -> dict:
    """One run of `cell`; returns the result line's object (its "checks"
    key last).  make_program(cell, pool, device) puts something else in
    the program's place (the control, control.py)."""
    log(f"{cell.name}: host cpus {os.cpu_count()}, load average "
        f"{os.getloadavg()}")
    stages = [("start", time.perf_counter() - t_start)]
    pool = traffic_gen.make_pool(cell.config, cell.traffic, seed, device)
    stages.append(("pool", time.perf_counter() - t_start))
    program = (make_program or _Program)(cell, pool, device)
    stages.append(("program", time.perf_counter() - t_start))
    for slot in range(len(pool)):  # warm-up: every shape the window takes
        program.run(slot)
        stages.append((f"warm {slot}", time.perf_counter() - t_start))
    setup_s = time.perf_counter() - t_start
    log(f"{cell.name}: set-up s since start: "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages))
    keep = _keep_plan(seed, len(pool))
    win = _window(program, len(pool), seconds, keep)
    # the device metrics' window; on a host without a card there is no
    # device activity to trace
    traced = (_traced_window(program, len(pool), seconds, keep)
              if trace and device.startswith("cuda") else None)
    peak = program.peak_bytes()
    batch_pairs = [len(pool[s][2]) for s in range(len(pool))]
    attempted = sum(batch_pairs[s] * n for w in (win, traced) if w
                    for s, n in w["runs"].items())
    kept = win["kept"] + (traced["kept"] if traced else [])
    del program
    gc.collect()
    if device.startswith("cuda"):
        import torch

        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    got = check(cell, pool, kept, seed, device)
    check_s = time.perf_counter() - t0
    lat = np.asarray(win["latency_s"])
    batches = len(lat)
    log(f"{cell.name}: setup {setup_s:.3f} s, {batches} batches in "
        f"{win['window_s']:.3f} s, batch ms median "
        f"{np.median(lat) * 1e3:.3f} p90 {np.percentile(lat, 90) * 1e3:.3f}"
        f" max {lat.max() * 1e3:.3f}; phases ms a batch "
        + ", ".join(f"{k} {v / batches * 1e3:.3f}"
                    for k, v in sorted(win["phase_s"].items()))
        + f"; {len(kept)} outputs checked in {check_s:.3f} s; load "
        f"average {os.getloadavg()}")
    metrics = {}
    if not trace:
        values = {"pairs_per_s": attempted / win["window_s"],
                  "batch_ms_p90": float(np.percentile(lat, 90)) * 1e3,
                  "setup_s": setup_s}
        for m in cell_metrics(bench, cell.name, False):
            metrics[m["name"]] = {"value": values[quantity(m["name"])],
                                  "unit": m["unit"]}
    else:
        tr = traced["trace"] if traced else None
        ctx = types.SimpleNamespace(
            config=cell.config, traffic=cell.traffic, batches=batches,
            phase_s=win["phase_s"], trace=tr,
            launches=traced["launches"] if traced else None,
            work=(_work(cell, pool, traced["runs"], got["walks"])
                  if traced else None))
        if tr:
            lt = np.asarray(traced["latency_s"])
            log(f"{cell.name}: traced window {len(lt)} batches in "
                f"{traced['window_s']:.3f} s, batch ms median "
                f"{np.median(lt) * 1e3:.3f}; trace read in "
                f"{traced['trace_read_s']:.3f} s ({tr['clock']} clock); busy "
                f"{tr['busy_s']:.6f} of {tr['window_s']:.6f} s; fill launches "
                f"{tr['fill_launches']} seen / launched {ctx.launches}; walk "
                f"and compaction {tr['walk_launches']}; work {ctx.work}")
        for m in cell_metrics(bench, cell.name, True):
            value = read_metric(m["name"], ctx)
            if value is None:
                log(f"{cell.name}: per-layer metric {m['name']} found "
                    f"nothing to read")
                continue
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": all(got["numbers"][k] <= checks.LIMITS[k]
                       for k in got["numbers"]),
        "attempted": attempted,
        "failed": got["failed"],
        "metrics": metrics,
        "device": {"memory_peak_bytes": peak},
    }
    if traced:
        tr = traced["trace"]
        result["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": tr["device_ops"],
                               "idle_gaps": tr["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": checks.LIMITS[k]}
                        for k, v in got["numbers"].items()}
    return result


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = _json(HERE.parent / "BENCHMARK.json")
    cell = load_cell(args.workload)

    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA card(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
            f"{torch.cuda.device_count()} visible")
        return 2
    result = run(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                 bench, t_start, log)
    result["device"] = {"platform": "gpu",
                        "kind": torch.cuda.get_device_name(0),
                        "count": cell.chips, **result["device"]}
    result["checks"] = result.pop("checks")
    found = forbidden_modules()
    if found:
        log(f"modules of JAX or the JAX package were loaded: {found}")
        return 3
    for k, v in result["checks"].items():
        log(f"check {k}: {v['value']} (limit {v['limit']})")
    print(json.dumps(result), flush=True)
    return 0
