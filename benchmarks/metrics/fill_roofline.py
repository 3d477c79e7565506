"""fill_roofline: the fill kernels' share of their roofline, %.

The least time the card could take for the fills the window's batches
need (benchmarks/roofline.py: fill_work at the 16-bit-pair or the int32
peak, or the bytes at HBM bandwidth, whichever is longer), over the
device time of the kernels whose names hold "fill_kernel" in the traced
window.  A trace that missed fill launches gives no reading."""

from benchmarks import roofline


def read(ctx):
    tr = ctx.trace
    if not tr or tr["fill_s"] <= 0:
        return None
    want = sum(ctx.launches[k] for k in ("stagger_fill", "banded_fill",
                                         "rowscan_fill", "rowscan_last_rows",
                                         "stagger_last_rows"))
    if tr["fill_launches"] != want:
        return None
    w = ctx.work
    bound, _ = roofline.bound_seconds(w["fill_ops"], w["fill_bytes"],
                                      w["ops_s"])
    return 100 * bound / tr["fill_s"]
