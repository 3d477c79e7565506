"""fill_warp_cell_ns: the ns one warp of a fill kernel takes a cell of
its pair: how fast the longest chain of each launch runs.

The device time of the kernels whose names hold "fill_kernel" in the
traced window over the program's fill_chain_cells (runtime/profiler.py
launch_counts: each launch's largest pair's cells, the work of its
longest warp).  No reading where the program's counted launches, the
fill kernels' launch counts and the trace's fill records disagree."""

FILLS = ("stagger_fill", "banded_fill", "rowscan_fill", "rowscan_last_rows",
         "stagger_last_rows")


def read(ctx):
    tr, c = ctx.trace, ctx.launches
    if not tr or tr["fill_s"] <= 0 or not c or not c.get("fill_counted") \
            or not c.get("fill_chain_cells"):
        return None
    want = sum(c.get(k, 0) for k in FILLS)
    if c["fill_counted"] != want or tr["fill_launches"] != want:
        return None
    return tr["fill_s"] * 1e9 / c["fill_chain_cells"]
