"""Multi-device data parallelism over pair batches, and multi-process runs
(the port of tpu_align/distributed)."""

from tpu_align_torch.distributed.sharding import (
    fill_sharded,
    global_stats,
    make_pairs_mesh,
    shard_bucket_spec,
    walk_sharded,
    walk_sharded_dispatch,
)
from tpu_align_torch.distributed.multihost import (
    host_shard,
    iter_output_blocks,
    initialize,
    merge_output_files,
    renumber,
)

__all__ = [
    "fill_sharded",
    "global_stats",
    "make_pairs_mesh",
    "shard_bucket_spec",
    "walk_sharded",
    "walk_sharded_dispatch",
    "host_shard",
    "iter_output_blocks",
    "initialize",
    "merge_output_files",
    "renumber",
]
