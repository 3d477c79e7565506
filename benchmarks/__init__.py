"""The benchmark of tpu_align_torch on one or more NVIDIA cards.

Run one cell once from the repository root:

    python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that decides a measurement lives here, apart from the program:
the traffic generator (traffic.py), the plain reference and the
comparison that decides `correct` (reference.py, checks.py), the peaks and
the operation and byte counts of the rooflines (roofline.py), the reading
of the device trace (trace.py) and one reader per per-layer metric
(metrics/).  A cell is two data files, found by name: its configuration
(configs/<config>.json) and its traffic (workloads/<cell>.json).
"""
