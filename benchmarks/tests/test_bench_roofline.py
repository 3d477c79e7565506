"""The roofline arithmetic on hand-worked shapes, for both peaks."""

import pytest

from benchmarks import roofline

LNW = dict(match=3, mismatch=-1, gap=-2, gap_open=-4, gap_extend=-1,
           band=16)


def test_peaks():
    assert roofline.INT32_OPS_S == pytest.approx(16.72704e12)
    assert roofline.INT16X2_OPS_S == pytest.approx(33.45408e12)
    assert roofline.HBM_BYTES_S == 3.35e12


def test_int16_fits_reads_not_long_pairs():
    # 250 + 265 columns at most 3 a column: 1,545 <= 32,767
    assert roofline.fits_int16("lnw", LNW, [250, 250], [240, 265])
    # 16,384 + 16,400 columns at 3: 98,352 > 32,767
    assert not roofline.fits_int16("lnw", LNW, [16384], [16400])
    # ANW's widest step is open + extend = 5: 6,553 columns fit, 6,554 not
    assert roofline.fits_int16("anw", LNW, [3276], [3277])
    assert not roofline.fits_int16("anw", LNW, [3277], [3277])


def test_fill_work_two_reads_pairs():
    ops, nbytes = roofline.fill_work("lnw", LNW, [250, 250], [250, 240],
                                     with_dirs=True)
    assert ops == (250 * 250 + 250 * 240) * 4 == 490_000
    assert nbytes == 250 + 250 + 250 + 240 + 2 * 4 == 998
    t, by = roofline.bound_seconds(ops, nbytes, roofline.INT16X2_OPS_S)
    assert by == "operations"
    assert t == pytest.approx(490_000 / (2 * 132 * 64 * 1.98e9))
    ops, _ = roofline.fill_work("lnw", LNW, [250, 250], [250, 240],
                                with_dirs=False)
    assert ops == 122_500 * 3


def test_fill_work_long_pair_at_the_int32_peak():
    ops, nbytes = roofline.fill_work("lnw", LNW, [16384], [16384], False)
    assert ops == 16384 * 16384 * 3
    t, by = roofline.bound_seconds(ops, nbytes, roofline.INT32_OPS_S)
    assert by == "operations"
    assert t == pytest.approx(805_306_368 / 16.72704e12)


def test_bytes_bound_when_few_operations():
    t, by = roofline.bound_seconds(10, 3_350_000, roofline.INT32_OPS_S)
    assert by == "bytes" and t == pytest.approx(1e-6)


def test_banded_cells_by_hand():
    # 3 x 3 at band 2: rows 1..3 keep columns 1-2, 1-3, 2-3: 7 cells
    assert roofline.cells("bsw", {**LNW, "band": 2}, [3], [3]) == 7
    # band 1 keeps the diagonal alone
    assert roofline.cells("bsw", {**LNW, "band": 1}, [5], [4]) == 4
    assert roofline.cells("lsw", LNW, [5], [4]) == 20
    ops, _ = roofline.fill_work("bsw", {**LNW, "band": 2}, [3], [3], True)
    assert ops == 7 * 5


def test_walk_work():
    ops, nbytes = roofline.walk_work(moves=260, gaps=12, pairs=1)
    assert ops == 4 * 260
    assert nbytes == 65 + 24 + 4
