"""The readers of the program's fill counters, fill_warps_per_sm and
fill_warp_cell_ns, on hand-made contexts: their readings, and no reading
where the counters are missing (a program without them), disagree with
the fill kernels' launch counts or with the trace's fill records, or
where there is no card."""

import types

import pytest
import torch

from benchmarks import harness

# six launches over buckets of 1, 549, 472, 2, 527 and 497 pairs of
# 16,384 x ~16,384 bp, one warp a pair
LAUNCHES = {"stagger_fill": 6, "banded_fill": 0, "rowscan_fill": 0,
            "walk": 0, "compact": 0, "rowscan_last_rows": 0,
            "stagger_last_rows": 0, "split_reduce": 0, "stream": 0,
            "fill_counted": 6, "fill_pairs": 2048, "fill_warps": 2048,
            "fill_cells": 2048 * 16384 * 16384,
            "fill_chain_cells": 6 * 16384 * 16500}
TRACE = {"fill_launches": 6, "fill_s": 6 * 0.306}


def _ctx(launches=LAUNCHES, trace=TRACE):
    return types.SimpleNamespace(launches=launches, trace=trace)


@pytest.fixture
def card(monkeypatch):
    """torch.cuda as on a card of 132 SMs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(
        torch.cuda, "get_device_properties",
        lambda device: types.SimpleNamespace(multi_processor_count=132))


def test_warps_per_sm(card):
    got = harness.read_metric("fill_warps_per_sm.scores", _ctx())
    assert got == pytest.approx(2048 / 6 / 132)


def test_warp_cell_ns(card):
    got = harness.read_metric("fill_warp_cell_ns.scores", _ctx())
    assert got == pytest.approx(0.306e9 / (16384 * 16500))


def _without(key):
    return {k: v for k, v in LAUNCHES.items() if k != key}


@pytest.mark.parametrize("name", ["fill_warps_per_sm.scores",
                                  "fill_warp_cell_ns.scores"])
@pytest.mark.parametrize("ctx", [
    _ctx(launches=None),  # a run without a card
    _ctx(launches=_without("fill_counted")),  # a program without counters
    _ctx(launches={**LAUNCHES, "fill_counted": 0, "fill_warps": 0,
                   "fill_chain_cells": 0}),
    # a fill launch the program did not count (the harness, a test)
    _ctx(launches={**LAUNCHES, "stagger_fill": 7}),
    _ctx(launches={**LAUNCHES, "rowscan_last_rows": 1}),
], ids=["no-launches", "no-counters", "none-counted",
        "uncounted-fill", "uncounted-last-rows"])
def test_no_reading_without_agreeing_counters(card, name, ctx):
    assert harness.read_metric(name, ctx) is None


@pytest.mark.parametrize("ctx", [
    _ctx(trace=None), _ctx(trace={"fill_launches": 0, "fill_s": 0.0}),
    _ctx(trace={"fill_launches": 5, "fill_s": 5 * 0.306}),  # a record missed
    _ctx(launches=_without("fill_chain_cells")),
], ids=["no-trace", "no-fill", "missed-record", "no-chain"])
def test_cell_ns_needs_every_fill_record_and_the_chains(card, ctx):
    assert harness.read_metric("fill_warp_cell_ns.scores", ctx) is None
    # the warp counters alone still give the warps
    assert harness.read_metric("fill_warps_per_sm.scores", ctx) is not None


def test_warps_per_sm_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert harness.read_metric("fill_warps_per_sm.scores", _ctx()) is None


def test_the_two_multiply_back_to_the_roofline(card):
    """warps a SM x the int32 peak a lane a SM over the cell rate of one
    warp is the fill roofline of a launch whose pairs all fill as fast
    as its longest (the int32 peak, scores-only LNW's 3 operations a
    cell)."""
    from benchmarks import roofline

    warps = harness.read_metric("fill_warps_per_sm.scores", _ctx())
    ns = harness.read_metric("fill_warp_cell_ns.scores", _ctx())
    share = 100 * warps / (ns * 1e-9 * roofline.INT32_OPS_S / 3 / 132)
    cells = LAUNCHES["fill_warps"] * 16384 * 16500
    bound = cells * 3 / roofline.INT32_OPS_S
    assert share == pytest.approx(100 * bound / TRACE["fill_s"])
