"""The port's ctypes binding to the native host runtime (native/tpualign.cpp),
built by the port itself (native/binding.py)."""

from tpu_align_torch.native.binding import (
    available,
    native_events_block_lens,
    native_format_blocks,
    native_gather_padded,
    native_gather_parts,
    native_gather_spans,
    native_parse_pair_bytes,
    native_replay_events,
    native_replay_events_blocks,
    native_replay_moves,
    native_traceback_bucket,
    require,
)

__all__ = ["available", "native_events_block_lens",
           "native_format_blocks", "native_gather_padded",
           "native_gather_parts", "native_gather_spans",
           "native_parse_pair_bytes",
           "native_replay_events", "native_replay_events_blocks",
           "native_replay_moves", "native_traceback_bucket", "require"]
