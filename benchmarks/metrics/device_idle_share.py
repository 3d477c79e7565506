"""device_idle_share: the share of the traced window in which no
operation ran on the card, %: 1 - (union of CUDA intervals) / window."""


def read(ctx):
    tr = ctx.trace
    if not tr or tr["busy_s"] <= 0:
        return None
    return 100 * (1 - tr["busy_s"] / tr["window_s"])
