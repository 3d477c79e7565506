"""The trace reading: host spans put on the trace's clock, the device's
busy time and idle gaps inside the window, kernels by name; and a traced
run on a host without a card, which reads its spans and no device."""

import json
import types

from benchmarks import trace
from benchmarks.tests.conftest import cpu_run, tiny_cell

R0, M0 = 1_800_000_000_000_000_000, 5_000_000_000


def _prof(events, start):
    def event(name, cuda, s, e):
        kind = types.SimpleNamespace(name="CUDA" if cuda else "CPU")
        return types.SimpleNamespace(name=lambda: name,
                                     device_type=lambda: kind,
                                     start_ns=lambda: s, end_ns=lambda: e)

    results = types.SimpleNamespace(
        events=lambda: [event(*e) for e in events],
        trace_start_ns=lambda: start)
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=results))


def _read(base, start):
    events = [("stagger_fill_kernel", True, base + 2000, base + 4000),
              ("window_walk_kernel", True, base + 5000, base + 6000),
              ("Memcpy DtoH", True, base + 5500, base + 7000),
              ("cudaLaunchKernel", False, base + 1900, base + 1950),
              ("late_fill_kernel", True, base + 12000, base + 13000)]
    spans = [(R0 + 1000, R0 + 11000, "bench.window"),
             (R0 + 1000, R0 + 11000, "bench.batch"),
             (R0 + 1000, R0 + 2000, "phase.memmgmt"),
             (R0 + 7000, R0 + 11000, "phase.printing")]
    clocks = {"realtime": R0, "monotonic": M0}
    return trace.read(_prof(events, start), spans, clocks)


def test_spans_go_onto_the_traces_clock():
    for base, start, clock in ((M0, M0 + 300, "monotonic"),
                               (R0, R0 + 300, "realtime")):
        got = _read(base, start)
        assert got["clock"] == clock
        assert got["window_s"] == 10_000 / 1e9
        # 2000-4000 and the union of 5000-6000 and 5500-7000
        assert got["busy_s"] == 4000 / 1e9
        assert (got["fill_launches"], got["walk_launches"]) == (1, 1)
        assert got["fill_s"] == 2000 / 1e9
        idle = dict(got["idle_gaps"])
        assert idle == {"phase.memmgmt": 1000 / 1e9,
                        "bench.batch": 1000 / 1e9,
                        "phase.printing": 4000 / 1e9}
        assert got["device_ops"][0] == ["stagger_fill_kernel", 2000 / 1e9]


def _with_span_metrics(bench, cell):
    """BENCHMARK.json with a rate and the three span metrics scoped to
    `cell`, as a cell that reports them brings its entries."""
    bench = json.loads(json.dumps(bench))
    bench["end_to_end"].append({
        "name": "pairs_per_s", "unit": "pairs/s", "better": "higher",
        "bound": 0.25, "source": "host_clock", "workloads": [cell]})
    for name, layer in (("bucketize_ms", "bucketize"),
                        ("dispatch_ms", "dispatch"),
                        ("replay_format_ms", "replay and format")):
        bench["per_layer"].append({
            "name": name, "unit": "ms", "better": "lower",
            "source": "program_span", "layer": layer,
            "moves": "pairs_per_s", "workloads": [cell]})
    return bench


def test_a_traced_run_without_a_card_reads_its_spans_alone(bench):
    name = "lnw-reads250-device"
    res = cpu_run(tiny_cell(name), _with_span_metrics(bench, name),
                  trace=True)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"bucketize_ms", "dispatch_ms",
                                   "replay_format_ms"}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert "breakdown" not in res and "busy_s" not in res["device"]
