"""fill_band_warps_per_sm: the persistent warps the band wavefront (B2)
runs at once, a SM of the card: the occupancy its instantiation's
registers allow.

The program's B2 counters of the traced window (runtime/profiler.py
launch_counts: fill_band_warps_max, the most persistent warps any B2
launch ran, each launch's grid x warps a block, sized by the launch from
the card's occupancy for the kernel) over the card's SM count.  No
reading where the program counts no B2 launch (a program without these
counters) or where its count is not the B2 kernel's launch counts."""

B2 = ("rowscan_fill", "rowscan_last_rows")


def read(ctx):
    c = ctx.launches
    if not c or not c.get("fill_band_counted"):
        return None
    if c["fill_band_counted"] != sum(c.get(k, 0) for k in B2):
        return None
    import torch

    if not torch.cuda.is_available():
        return None
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return c["fill_band_warps_max"] / sms
