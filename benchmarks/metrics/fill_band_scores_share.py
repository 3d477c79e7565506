"""fill_band_scores_share: the share of the fills' real cells that the band
wavefront (B2) computed in its scores step, %.

100 x the program's fill_band_scores_cells (runtime/profiler.py
launch_counts: the real cells of the band items that took
fill_band_scores, counted by the kernel on the card) over its fill_cells
(the real cells of every fill launch of the traced window).  It reads
only a window whose every fill launch is a B2 launch: no reading where
the program's counted B2 launches, its counted fill launches, the fill
kernels' launch counts, the B2 kernel's and the trace's fill records are
not one number, or where the program has no such counter."""

FILLS = ("stagger_fill", "banded_fill", "rowscan_fill", "rowscan_last_rows",
         "stagger_last_rows")
B2 = ("rowscan_fill", "rowscan_last_rows")


def read(ctx):
    tr, c = ctx.trace, ctx.launches
    if not tr or not c or not c.get("fill_band_counted") \
            or not c.get("fill_cells") \
            or c.get("fill_band_scores_cells") is None:
        return None
    counts = {c["fill_band_counted"], c.get("fill_counted"),
              sum(c.get(k, 0) for k in FILLS), sum(c.get(k, 0) for k in B2),
              tr["fill_launches"]}
    if len(counts) != 1:
        return None
    return 100 * c["fill_band_scores_cells"] / c["fill_cells"]
