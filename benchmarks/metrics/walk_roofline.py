"""walk_roofline: the device walk and event compaction's share of their
roofline, %.

The least time for the walks the window's batches need (moves: the
lengths of the reference's alignments; benchmarks/roofline.py
walk_work), over the device time of the kernels whose names hold
"walk_kernel" or "compact_events_kernel" in the traced window.  A trace
that missed launches gives no reading."""

from benchmarks import roofline


def read(ctx):
    tr = ctx.trace
    if not tr or tr["walk_s"] <= 0 or not ctx.work["walk_ops"]:
        return None
    if tr["walk_launches"] != ctx.launches["walk"] + ctx.launches["compact"]:
        return None
    w = ctx.work
    bound, _ = roofline.bound_seconds(w["walk_ops"], w["walk_bytes"],
                                      w["ops_s"])
    return 100 * bound / tr["walk_s"]
