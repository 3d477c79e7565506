"""Multi-process orchestration helpers (the port of
tpu_align/distributed/multihost.py onto torch.distributed).

One Python process per host (or per card group); torch.distributed joins
them.  Pair alignment is embarrassingly parallel over pairs, so the
multi-process recipe is:

  1. initialize() in every process (torchrun's environment, or an explicit
     rendezvous address, world size and rank),
  2. split the input by pair id across processes (`host_shard` -- a
     deterministic stride split, so no process-to-process data exchange is
     needed),
  3. run the normal AlignmentEngine on the local shard (each process drives
     its own cards through the `pairs` mesh over local devices),
  4. write per-process output files and merge by pair id
     (`merge_output_files`, the scripts/reorderOutput.py job done
     properly -- SURVEY.md section 2.4).

The process group is gloo whatever the device: pairs never cross
processes, and the only collective (distributed.global_stats) carries two
integers of run stats, on CPU tensors.
"""

from __future__ import annotations

import datetime
import heapq
import os

import numpy as np
import torch.distributed as dist

from tpu_align_torch.io.dataset import PairDataset

# a rendezvous whose peers never arrive fails after this long
RENDEZVOUS_TIMEOUT = datetime.timedelta(minutes=5)
# torchrun's environment: any of these set means the env:// rendezvous
_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def _group() -> tuple[int, int]:
    """(rank, world size) of the default process group, (0, 1) with none."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               timeout: datetime.timedelta = RENDEZVOUS_TIMEOUT,
               ) -> tuple[int, int]:
    """Join the gloo process group (no-op for a single process).

    Returns (process_index, process_count).  With num_processes > 1 the
    rendezvous is coordinator_address (a torch init_method URL such as
    "tcp://host:port" or "file:///shared/path"; None means env://) with
    that world size and process_id as the rank.  With no num_processes,
    torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR) means the
    env:// rendezvous (or coordinator_address) with the environment's
    world size and rank; with none of it set, this is one process.  A
    rendezvous that fails raises (after `timeout` where peers never
    arrive)."""
    if dist.is_initialized():
        return _group()
    if num_processes is None:
        if not any(k in os.environ for k in _LAUNCHER_ENV):
            return 0, 1
        try:
            num_processes = int(os.environ["WORLD_SIZE"])
            process_id = int(os.environ["RANK"])
        except (KeyError, ValueError) as e:
            raise ValueError(
                "a launcher environment needs integer RANK and WORLD_SIZE "
                f"({e!r})") from e
    if num_processes > 1:
        if process_id is None or not 0 <= process_id < num_processes:
            raise ValueError(f"process_id {process_id!r} is not a rank of "
                             f"{num_processes} processes")
        dist.init_process_group(
            "gloo", init_method=coordinator_address or "env://",
            world_size=num_processes, rank=process_id, timeout=timeout)
    return _group()


def host_shard(ds: PairDataset, process_index: int | None = None,
               process_count: int | None = None) -> tuple[PairDataset, np.ndarray]:
    """This host's strided slice of the dataset.

    Returns (shard, global_pair_ids); strided (rather than contiguous)
    assignment balances length skew across hosts.  The defaults are the
    process group's rank and world size (0 and 1 with no group).
    """
    rank, world = _group()
    pi = rank if process_index is None else process_index
    pc = world if process_count is None else process_count
    ids = np.arange(pi, len(ds), pc, dtype=np.int64)
    return ds.select(ids), ids


def renumber(results, global_ids: np.ndarray):
    """Rewrite shard-local pair numbers back to global ids (in place)."""
    for r in results:
        r.pair_num = int(global_ids[r.pair_num])
    return results


def iter_output_blocks(path):
    """Stream (pair_id, block_text) from an output-block file.

    A block is a "<pairNum> | <score>" header line plus every following
    line up to the next header (header detection is shared with
    utils.reorder -- one definition of the block format).  Memory is one
    block, not the file."""
    from tpu_align_torch.utils.reorder import block_header_pair_num

    key = None
    current: list[str] = []
    with open(path) as f:
        for line in f:
            pn = block_header_pair_num(line)
            if pn is not None:
                if key is not None:
                    yield key, "".join(current)
                key = pn
                current = [line]
            elif key is not None:
                current.append(line)
        if key is not None:
            yield key, "".join(current)


def _checked_stream(path):
    last = None
    for k, block in iter_output_blocks(path):
        if last is not None and k < last:
            raise ValueError(
                f"{path} is not sorted by pair id ({k} after {last}); "
                "per-host shard outputs are pair-id-ordered by construction "
                "(engine sorts results) -- for arbitrary interleavings use "
                "tpu_align_torch.utils.reorder_output on the concatenation")
        last = k
        yield k, block


def merge_output_files(paths, out_path) -> None:
    """Merge per-host output-block files into one file ordered by pair id.

    Streaming k-way merge (the scripts/reorderOutput.py job done at
    scale): each input is read one block at a time and blocks are emitted
    through a k-entry heap, so peak memory is one block per input stream
    regardless of file sizes -- multi-GB per-host outputs merge in O(1)
    memory.  Inputs must each be pair-id-sorted (host_shard + the
    engine's result ordering guarantee this); violations raise instead
    of silently mis-merging."""
    streams = [_checked_stream(p) for p in paths]
    with open(out_path, "w") as f:
        for _, block in heapq.merge(*streams, key=lambda kb: kb[0]):
            f.write(block)
