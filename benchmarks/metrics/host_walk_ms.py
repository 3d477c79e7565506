"""host_walk_ms: the native host walk of the fills' direction words
(traceback/host.py native_traceback_bucket), the program's PhaseTimer
"backtrack" span under host traceback, in ms a batch over the window's
batches.  Under device traceback that span is the wait for the walk's
copies, another layer: nothing to read there."""


def read(ctx):
    t = ctx.traffic
    s = ctx.phase_s.get("backtrack")
    if s is None or t["traceback"] != "host" or not t["with_traceback"]:
        return None
    return s / ctx.batches * 1e3
