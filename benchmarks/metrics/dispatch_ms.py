"""dispatch_ms: upload and enqueue of each bucket's fill (and walk)
(distributed/sharding.py, convert.py), the program's PhaseTimer
"dispatch" span, in ms a batch over the window's batches."""


def read(ctx):
    s = ctx.phase_s.get("dispatch")
    return None if s is None else s / ctx.batches * 1e3
