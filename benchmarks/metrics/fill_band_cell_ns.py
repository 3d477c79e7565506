"""fill_band_cell_ns: the ns one persistent warp of the band wavefront
(B2) spends on a cell, its waits on the band above included.

The device time of the kernels whose names hold "fill_kernel" in the
traced window over the program's fill_band_warp_cells
(runtime/profiler.py launch_counts: the sum over B2 launches of their
real cells over their persistent warps, the cells each warp took).  It
reads only a window whose every fill launch is a B2 launch: no reading
where the program's counted B2 launches, its counted fill launches, the
fill kernels' launch counts, the B2 kernel's and the trace's fill records
are not one number (or the program has no such counters)."""

FILLS = ("stagger_fill", "banded_fill", "rowscan_fill", "rowscan_last_rows",
         "stagger_last_rows")
B2 = ("rowscan_fill", "rowscan_last_rows")


def read(ctx):
    tr, c = ctx.trace, ctx.launches
    if not tr or tr["fill_s"] <= 0 or not c \
            or not c.get("fill_band_counted") \
            or not c.get("fill_band_warp_cells"):
        return None
    counts = {c["fill_band_counted"], c.get("fill_counted"),
              sum(c.get(k, 0) for k in FILLS), sum(c.get(k, 0) for k in B2),
              tr["fill_launches"]}
    if len(counts) != 1:
        return None
    return tr["fill_s"] * 1e9 / c["fill_band_warp_cells"]
