"""replay_format_ms: the host's replay of the walks' events and the
block formatting (traceback/device.py replay, runtime/engine.py
_BlockCollector), the program's PhaseTimer "printing" span, in ms a batch
over the window's batches."""


def read(ctx):
    s = ctx.phase_s.get("printing")
    return None if s is None else s / ctx.batches * 1e3
