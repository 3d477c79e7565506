"""bucketize_ms: the host's bucketize (io/bucketing.py through
AlignmentEngine._buckets_of), the program's PhaseTimer "memmgmt" span,
in ms a batch over the window's batches."""


def read(ctx):
    s = ctx.phase_s.get("memmgmt")
    return None if s is None else s / ctx.batches * 1e3
