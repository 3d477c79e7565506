"""fill_warps_per_sm: the warps a fill launch gives real pairs, a SM of
the card: how full the fill kernels' launches keep the card.

The program's fill counters of the traced window (runtime/profiler.py
launch_counts: fill_warps over fill_counted launches, each counted where
the launch is made from the lengths the host holds) over the card's SM
count.  No reading where the program's counted launches are not the fill
kernels' launch counts (or it counts none)."""

FILLS = ("stagger_fill", "banded_fill", "rowscan_fill", "rowscan_last_rows",
         "stagger_last_rows")


def read(ctx):
    c = ctx.launches
    if not c or not c.get("fill_counted"):
        return None
    if c["fill_counted"] != sum(c.get(k, 0) for k in FILLS):
        return None
    import torch

    if not torch.cuda.is_available():
        return None
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return c["fill_warps"] / (c["fill_counted"] * sms)
