"""Phase-breakdown analysis across runs (the timing_analysis/ equivalent;
the port's copy of tpu_align/utils/timing_analysis.py).

The reference collects per-version phase buckets (Memory Management /
Kernel Execution / Backtracking / Printing / Misc) in Timing_Analysis.xlsx
and renders stacked-bar charts with pandas/matplotlib
(timing_analysis/time-analysis.py:52-58).  Here runs are JSONL records
    {"label": ..., "phases": {"kernel": seconds, ...}, ...}
(bench.py --engine emits them); `analyze` renders a text table and `plot`
an optional stacked-bar PNG when matplotlib is present.
"""

from __future__ import annotations

import json
import sys

PHASE_ORDER = ["memmgmt", "dispatch", "kernel", "backtrack", "printing"]


def load_runs(path: str) -> list[dict]:
    runs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                runs.append(json.loads(line))
    return runs


def analyze(runs: list[dict]) -> str:
    """Text table: one row per run, one column per phase (ms), plus total.
    Rows without phase buckets (fill-only bench records) are skipped."""
    runs = [r for r in runs if r.get("phases")]
    phases = [p for p in PHASE_ORDER
              if any(p in r.get("phases", {}) for r in runs)]
    for r in runs:
        for p in r.get("phases", {}):
            if p not in phases:
                phases.append(p)
    width = max([len(str(r.get("label", i))) for i, r in enumerate(runs)] + [7])
    head = f"{'run':>{width}} " + "".join(f"{p:>12}" for p in phases)
    head += f"{'total':>12}"
    lines = [head, "-" * len(head)]
    for i, r in enumerate(runs):
        label = str(r.get("label", i))
        ph = r.get("phases", {})
        total = sum(ph.values())
        row = f"{label:>{width}} " + "".join(
            f"{ph.get(p, 0.0) * 1e3:12.2f}" for p in phases
        )
        row += f"{total * 1e3:12.2f}"
        lines.append(row)
    return "\n".join(lines)


def plot(runs: list[dict], outfile: str) -> bool:
    """Stacked-bar phase chart (ms).  Returns False if matplotlib is
    unavailable."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return False
    runs = [r for r in runs if r.get("phases")]
    if not runs:
        return False
    phases = [p for p in PHASE_ORDER
              if any(p in r.get("phases", {}) for r in runs)]
    labels = [str(r.get("label", i)) for i, r in enumerate(runs)]
    # numeric x positions: duplicate labels (the same config re-run and
    # appended) must not collapse onto one category, hiding runs and
    # misplacing the total annotations
    xs = list(range(len(runs)))
    plt.figure(figsize=(max(6, 1.2 * len(runs)), 5))
    bottom = [0.0] * len(runs)
    for p in phases:
        vals = [r.get("phases", {}).get(p, 0.0) * 1e3 for r in runs]
        plt.bar(xs, vals, bottom=bottom, label=p, width=0.6)
        bottom = [b + v for b, v in zip(bottom, vals)]
    plt.xticks(xs, labels, rotation=20, ha="right")
    for x, total in enumerate(bottom):
        plt.text(x, total, f"{total:.0f} ms", ha="center", va="bottom")
    plt.ylabel("Time (ms)")
    plt.title("Execution time breakdown per run")
    plt.legend(title="Phase")
    plt.tight_layout()
    plt.savefig(outfile, dpi=150)
    plt.close()
    return True


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print("usage: python -m tpu_align_torch.utils.timing_analysis "
              "runs.jsonl [out.png]", file=sys.stderr)
        return 2
    runs = load_runs(argv[0])
    print(analyze(runs))
    if len(argv) > 1:
        if plot(runs, argv[1]):
            print(f"wrote {argv[1]}", file=sys.stderr)
        elif not any(r.get("phases") for r in runs):
            print("no phase-bucket rows; skipped plot", file=sys.stderr)
        else:
            print("matplotlib unavailable; skipped plot", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
