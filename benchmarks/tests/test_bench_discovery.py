"""Every cell and metric is found by name, and a new cell is files
alone."""

import json
import shutil

import pytest

from benchmarks import harness
from benchmarks.tests.conftest import REPO, cpu_run


def test_every_cell_loads_by_name_and_matches_benchmark_json(bench):
    assert bench["paths"] == ["benchmarks"]
    names = {c["name"] for c in bench["configs"]}
    for w in bench["workloads"]:
        cell = harness.load_cell(w["name"])
        assert w["config"] in names and cell.config is not None
        assert w["traffic"] == w["name"]
        raw = json.loads((harness.HERE / "workloads"
                          / f"{w['name']}.json").read_text())
        assert raw["config"] == w["config"]
        assert raw["chips"] == w["chips"] == cell.traffic["mesh"]
        assert raw["why"] == w["why"]
    for c in bench["configs"]:
        assert (REPO / c["file"]).is_file()
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]


def test_every_metric_has_its_reader(bench):
    for m in bench["per_layer"]:
        assert any((harness.HERE / "metrics" / f"{n}.py").is_file()
                   for n in (m["name"], harness.quantity(m["name"])))
        for w in m.get("workloads", []):
            assert (harness.HERE / "workloads" / f"{w}.json").is_file()
            # each cell a per-layer metric lists reports what it moves
            assert m["moves"] in [e["name"] for e in harness.cell_metrics(
                bench, w, False)]
    names = {harness.quantity(m["name"]) for m in bench["end_to_end"]}
    assert names <= {"pairs_per_s", "batch_ms_p90", "setup_s"}
    for w in bench["workloads"]:
        got = [harness.quantity(m["name"])
               for m in harness.cell_metrics(bench, w["name"], False)]
        assert "setup_s" in got and "pairs_per_s" in got
        assert harness.cell_metrics(bench, w["name"], True)


def test_a_dotted_name_reads_its_quantity(tmp_path):
    root = tmp_path / "benchmarks"
    (root / "metrics").mkdir(parents=True)
    (root / "metrics" / "x_ms.py").write_text(
        "def read(ctx):\n    return ctx * 2\n")
    (root / "metrics" / "x_ms.own.py").write_text(
        "def read(ctx):\n    return ctx * 3\n")
    assert harness.read_metric("x_ms.scores", 5, root) == 10
    assert harness.read_metric("x_ms.own", 5, root) == 15
    assert harness.quantity("pairs_per_s.scores") == "pairs_per_s"


def test_unknown_keys_are_refused(tmp_path):
    root = tmp_path / "benchmarks"
    shutil.copytree(harness.HERE / "configs", root / "configs")
    (root / "workloads").mkdir()
    (root / "workloads" / "typo.json").write_text(json.dumps({
        "config": "lnw-reads250", "chips": 1, "why": "x",
        "traffic": {"batch_pairs": 8, "pool_batches": 1, "tracback": "host"}}))
    with pytest.raises(ValueError, match="tracback"):
        harness.load_cell("typo", root)


@pytest.mark.parametrize("config,traffic", [
    # a new traffic on an existing configuration: one file
    (None, {"batch_pairs": 16, "pool_batches": 2, "traceback": "host",
            "kernel": "rowscan"}),
    # Open questions' rows: a new configuration and its cell, two files
    ({"aligner": "anw", "scoring": {"gap_open": -4, "gap_extend": -1}},
     {"batch_pairs": 16, "pool_batches": 2, "traceback": "device"}),
    ({"aligner": "bsw", "scoring": {"band": 16}},
     {"batch_pairs": 16, "pool_batches": 2, "traceback": "device"}),
    ({"aligner": "lsw", "reference_length": [20, 60]},
     {"batch_pairs": 16, "pool_batches": 2, "traceback": "device"}),
    ({"aligner": "anw", "reference_length": 300},
     {"batch_pairs": 2, "pool_batches": 1, "traceback": "hirschberg"}),
    (None, {"batch_pairs": 16, "pool_batches": 2, "mesh": 2}),
])
def test_a_new_cell_is_files_alone(tmp_path, bench, config, traffic):
    root = tmp_path / "benchmarks"
    shutil.copytree(harness.HERE, root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    base = json.loads((root / "configs" / "lnw-reads250.json").read_text())
    base["reference_length"] = 40
    cfg_name = "lnw-reads250"
    if config is not None:
        base.update({k: v for k, v in config.items() if k != "scoring"})
        base["scoring"] = {**base["scoring"], **config.get("scoring", {})}
        cfg_name = f"{base['aligner']}-new"
    (root / "configs" / f"{cfg_name}.json").write_text(json.dumps(base))
    chips = traffic.get("mesh", 1)
    (root / "workloads" / "new-cell.json").write_text(json.dumps({
        "config": cfg_name, "traffic": traffic, "chips": chips,
        "why": "a cell added as data"}))
    cell = harness.load_cell("new-cell", root)
    if config is None:  # the copied configuration is used as it is
        cell.config["reference_length"] = 40
    # BENCHMARK.json gains entries, scoped to the new cell; none changes
    bench = json.loads(json.dumps(bench))
    bench["end_to_end"].append({
        "name": "pairs_per_s.new", "unit": "pairs/s", "better": "higher",
        "bound": 0.25, "source": "host_clock", "workloads": ["new-cell"]})
    res = cpu_run(cell, bench)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"pairs_per_s.new", "setup_s"}
    assert res["metrics"]["pairs_per_s.new"]["value"] > 0
