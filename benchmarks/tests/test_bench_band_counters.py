"""The band wavefront's (B2's) counters in the program
(runtime/profiler.py count_band, through count_fill) and their readers,
fill_band_warps_per_sm and fill_band_cell_ns, on hand-made launches and
contexts; and the affine cell, cut to a CPU's size, through the harness."""

import types

import pytest
import torch

from benchmarks import harness
from benchmarks.tests.conftest import cpu_run

# the readers' card: 132 SMs
SMS = 132
# a full launch: 549 pairs of 16,384 x 16,384 (128 bands each), on as
# many persistent warps as 4 blocks of 4 warps a SM hold
FULL = {"warps": 4 * 4 * SMS, "rlen": [16_384] * 549 + [0] * 3,
        "qlen": [16_384] * 549 + [0] * 3}
# a 1-pair bucket: 128 band items, 32 blocks of 4 warps, one warp an item
ONE = {"warps": 128, "rlen": [16_384], "qlen": [16_300]}


@pytest.fixture
def counters():
    from tpu_align_torch.runtime import profiler

    profiler.reset_launch_counts()
    yield profiler
    profiler.reset_launch_counts()


def test_count_band_by_hand(counters):
    counters.count_band(FULL["warps"], FULL["rlen"], FULL["qlen"])
    got = counters.launch_counts()
    assert got["fill_band_counted"] == 1
    assert got["fill_band_warps_max"] == 2112
    assert got["fill_band_warp_cells"] == pytest.approx(
        549 * 16_384 * 16_384 / 2112)
    counters.count_band(ONE["warps"], ONE["rlen"], ONE["qlen"])
    got = counters.launch_counts()
    assert got["fill_band_counted"] == 2
    assert got["fill_band_warps_max"] == 2112  # the most, not the last
    assert got["fill_band_warp_cells"] == pytest.approx(
        549 * 16_384 * 16_384 / 2112 + 16_384 * 16_300 / 128)
    # a launch of no warps (an empty bucket) adds no cells
    counters.count_band(0, [], [])
    assert counters.launch_counts()["fill_band_warp_cells"] == \
        got["fill_band_warp_cells"]


def test_count_fill_counts_b2_launches_with_their_warps(counters,
                                                        monkeypatch):
    """count_fill adds a "rowscan" launch to the B2 counters with the
    persistent warps its wrapper read back from the launch; the other
    fills leave them alone, and the existing counters keep their
    meaning."""
    from tpu_align_torch.kernels import fill

    monkeypatch.setattr(fill, "band_warps", ONE["warps"])
    counters.count_fill("rowscan", ONE["rlen"], ONE["qlen"])
    counters.count_fill("stagger", FULL["rlen"], FULL["qlen"])
    got = counters.launch_counts()
    assert got["fill_band_counted"] == 1
    assert got["fill_band_warps_max"] == 128
    assert got["fill_band_warp_cells"] == pytest.approx(
        16_384 * 16_300 / 128)
    assert got["fill_counted"] == 2
    assert got["fill_warps"] == 128 + 549  # a warp a band item, a pair


def test_reset_zeroes_them(counters):
    counters.count_band(FULL["warps"], FULL["rlen"], FULL["qlen"])
    counters.reset_launch_counts()
    got = counters.launch_counts()
    assert all(got[k] == 0 for k in counters.BAND_KEYS)


@pytest.fixture
def card(monkeypatch):
    """torch.cuda as on a card of SMS SMs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(
        torch.cuda, "get_device_properties",
        lambda device: types.SimpleNamespace(multi_processor_count=SMS))


# a traced window of 6 B2 launches, every fill launch of it
LAUNCHES = {"stagger_fill": 0, "banded_fill": 0, "rowscan_fill": 6,
            "rowscan_last_rows": 0, "stagger_last_rows": 0,
            "fill_counted": 6, "fill_band_counted": 6,
            "fill_band_warps_max": 2112, "fill_band_warp_cells": 6 * 2.0e6}
TRACE = {"fill_launches": 6, "fill_s": 6 * 0.33}


def _ctx(launches=LAUNCHES, trace=TRACE):
    return types.SimpleNamespace(launches=launches, trace=trace)


def test_readings(card):
    assert harness.read_metric("fill_band_warps_per_sm.affine", _ctx()) == \
        pytest.approx(2112 / SMS)
    assert harness.read_metric("fill_band_cell_ns.affine", _ctx()) == \
        pytest.approx(0.33e9 / 2.0e6)


def _without(*keys):
    return {k: v for k, v in LAUNCHES.items() if k not in keys}


@pytest.mark.parametrize("name", ["fill_band_warps_per_sm.affine",
                                  "fill_band_cell_ns.affine"])
@pytest.mark.parametrize("ctx", [
    _ctx(launches=None),  # a run without a card
    # a program without the B2 counters (one older than them)
    _ctx(launches=_without("fill_band_counted", "fill_band_warps_max",
                           "fill_band_warp_cells")),
    _ctx(launches={**LAUNCHES, "fill_band_counted": 0}),
    # a B2 launch the program did not count
    _ctx(launches={**LAUNCHES, "rowscan_fill": 7}),
    _ctx(launches={**LAUNCHES, "rowscan_last_rows": 1}),
], ids=["no-launches", "no-counters", "none-counted", "uncounted-fill",
        "uncounted-last-rows"])
def test_no_reading_without_agreeing_counters(card, name, ctx):
    assert harness.read_metric(name, ctx) is None


@pytest.mark.parametrize("ctx", [
    _ctx(trace=None), _ctx(trace={"fill_launches": 0, "fill_s": 0.0}),
    _ctx(trace={"fill_launches": 5, "fill_s": 5 * 0.33}),  # a record missed
    # a stagger launch in the window: not every fill launch is B2's
    _ctx(launches={**LAUNCHES, "stagger_fill": 1, "fill_counted": 7},
         trace={"fill_launches": 7, "fill_s": 7 * 0.33}),
    _ctx(launches={**LAUNCHES, "fill_counted": 5}),
    _ctx(launches=_without("fill_band_warp_cells")),
], ids=["no-trace", "no-fill", "missed-record", "a-stagger-launch",
        "fill-counted-disagrees", "no-cells"])
def test_cell_ns_reads_only_all_b2_windows(card, ctx):
    assert harness.read_metric("fill_band_cell_ns.affine", ctx) is None


def test_warps_per_sm_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert harness.read_metric("fill_band_warps_per_sm.affine",
                               _ctx()) is None


def test_the_affine_cell_on_the_cpu_engine_is_correct(bench):
    """anw-long16k-scores at 1,000 bp and 6 pairs a batch, its traffic
    otherwise as is: the check against the reference passes."""
    cell = harness.load_cell("anw-long16k-scores")
    cell.traffic.update(batch_pairs=6, check_pairs=4)
    cell.config["reference_length"] = 1000
    res = cpu_run(cell, bench)
    assert res["correct"], res["checks"]
    assert res["checks"] == {"scores_wrong": {"value": 0, "limit": 0}}
    assert set(res["metrics"]) == {"pairs_per_s.scores", "setup_s"}
