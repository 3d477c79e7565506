"""The local cell, lsw-long16k-scores: its readers on hand-made contexts
(fill_band_scores_share, the share of the cells B2's scores step took by
the program's own count, and the B2 readers it shares with the affine
cell), its roofline's work, and the cell itself, cut to a CPU's size,
through the harness."""

import types

import pytest
import torch

from benchmarks import harness, roofline
from benchmarks.tests.conftest import cpu_run

SMS = 132
# a traced window of 6 B2 launches over 2,048 pairs of 16,384 x ~16,384,
# every fill launch of it; the scores step took all but the partial
# bottom bands (0.4 % of the cells)
CELLS = 2048 * 16_384 * 16_384
LAUNCHES = {"stagger_fill": 0, "banded_fill": 0, "rowscan_fill": 6,
            "rowscan_last_rows": 0, "stagger_last_rows": 0,
            "fill_counted": 6, "fill_cells": CELLS,
            "fill_band_counted": 6, "fill_band_warps_max": 3168,
            "fill_band_warp_cells": 6 * 2.0e6,
            "fill_band_scores_cells": CELLS - CELLS // 250}
TRACE = {"fill_launches": 6, "fill_s": 6 * 0.068}


def _ctx(launches=LAUNCHES, trace=TRACE):
    return types.SimpleNamespace(launches=launches, trace=trace)


@pytest.fixture
def card(monkeypatch):
    """torch.cuda as on a card of SMS SMs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(
        torch.cuda, "get_device_properties",
        lambda device: types.SimpleNamespace(multi_processor_count=SMS))


def test_share_is_the_counted_cells_over_the_fills_cells():
    got = harness.read_metric("fill_band_scores_share.lsw", _ctx())
    assert got == pytest.approx(100 * (1 - 1 / 250))
    # every cell in the scores step reads 100, none 0
    full = {**LAUNCHES, "fill_band_scores_cells": CELLS}
    assert harness.read_metric("fill_band_scores_share.lsw",
                               _ctx(full)) == 100
    none = {**LAUNCHES, "fill_band_scores_cells": 0}
    assert harness.read_metric("fill_band_scores_share.lsw",
                               _ctx(none)) == 0


def _without(*keys):
    return {k: v for k, v in LAUNCHES.items() if k not in keys}


@pytest.mark.parametrize("ctx", [
    _ctx(launches=None), _ctx(trace=None),  # a run without a card
    # a program without the kernel's count (one older than it)
    _ctx(launches=_without("fill_band_scores_cells")),
    _ctx(launches=_without("fill_band_counted", "fill_band_warps_max",
                           "fill_band_warp_cells")),
    _ctx(launches={**LAUNCHES, "fill_band_counted": 0}),
    _ctx(launches={**LAUNCHES, "fill_cells": 0}),
    # a B2 launch the program did not count
    _ctx(launches={**LAUNCHES, "rowscan_fill": 7}),
    _ctx(launches={**LAUNCHES, "rowscan_last_rows": 1}),
    # a stagger launch in the window: not every fill launch is B2's
    _ctx(launches={**LAUNCHES, "stagger_fill": 1, "fill_counted": 7},
         trace={"fill_launches": 7, "fill_s": 7 * 0.068}),
    _ctx(launches={**LAUNCHES, "banded_fill": 1, "fill_counted": 7},
         trace={"fill_launches": 7, "fill_s": 7 * 0.068}),
    _ctx(launches={**LAUNCHES, "fill_counted": 5}),
    _ctx(trace={"fill_launches": 5, "fill_s": 5 * 0.068}),  # a record missed
], ids=["no-launches", "no-trace", "no-counter", "no-b2-counters",
        "none-counted", "no-cells", "uncounted-fill", "uncounted-last-rows",
        "a-stagger-launch", "a-banded-launch", "fill-counted-disagrees",
        "missed-record"])
def test_share_reads_only_all_b2_windows(ctx):
    assert harness.read_metric("fill_band_scores_share.lsw", ctx) is None


def test_the_cell_reads_b2s_shared_readers(card):
    """fill_band_warps_per_sm.lsw and fill_band_cell_ns.lsw are the
    affine cell's readers (their quantity's), on the local cell's window."""
    assert harness.read_metric("fill_band_warps_per_sm.lsw", _ctx()) == \
        pytest.approx(3168 / SMS)
    assert harness.read_metric("fill_band_cell_ns.lsw", _ctx()) == \
        pytest.approx(0.068e9 / 2.0e6)


def test_roofline_work_of_the_local_cell():
    """LSW scores only: 4 operations a cell (CELL_OPS less the direction
    code), at the int32 peak, since 16 kbp local scores pass int16."""
    cell = harness.load_cell("lsw-long16k-scores")
    scoring = cell.config["scoring"]
    rlen, qlen = [16_384, 16_384], [16_300, 16_421]
    assert not roofline.fits_int16("lsw", scoring, rlen, qlen)
    ops, nbytes = roofline.fill_work("lsw", scoring, rlen, qlen, False)
    assert ops == 4 * 16_384 * (16_300 + 16_421)
    assert nbytes == 2 * 16_384 + 16_300 + 16_421 + 2 * 4


def test_the_local_cell_on_the_cpu_engine_is_correct(bench):
    """lsw-long16k-scores at 1,000 bp and 6 pairs a batch, its traffic
    otherwise as is: the check against the reference passes, and the cell
    reports the scores cells' end-to-end metrics."""
    cell = harness.load_cell("lsw-long16k-scores")
    assert cell.config["aligner"] == "lsw" and cell.chips == 1
    cell.traffic.update(batch_pairs=6, check_pairs=4)
    cell.config["reference_length"] = 1000
    res = cpu_run(cell, bench)
    assert res["correct"], res["checks"]
    assert res["checks"] == {"scores_wrong": {"value": 0, "limit": 0}}
    assert set(res["metrics"]) == {"pairs_per_s.scores", "setup_s"}
    assert set(m["name"] for m in harness.cell_metrics(
        bench, cell.name, True)) == {
        "fill_roofline.lsw", "fill_band_warps_per_sm.lsw",
        "fill_band_cell_ns.lsw", "fill_band_scores_share.lsw"}
