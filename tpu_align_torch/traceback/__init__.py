"""Traceback over the fills' packed directions (stagger, banded and
row-sweep layouts): the host walk (native, or NumPy with
use_native=False), the device walk with event compaction or in moves
mode, and their replays, and Hirschberg."""

from tpu_align_torch.traceback.host import traceback_bucket, unpack_pair_dirs

__all__ = ["traceback_bucket", "unpack_pair_dirs"]
