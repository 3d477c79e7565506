"""Data parallelism over a 1-D `pairs` mesh of devices (the port of
tpu_align/distributed/sharding.py).

The natural mapping for pairwise alignment is pure data parallelism over
pair batches: no DP-cell dependency ever crosses a pair boundary, so each
device runs the fill (and the device walk) on its shard of the batch, and
the only collective is the run-level stats reduction (`global_stats`:
score maximum, cell count) -- the role the reference's host-side
aggregation plays (V19.cu:662-673).

Where the JAX package runs one shard_map program over the mesh, the port
enqueues each shard's kernels on its own device's current stream: shard k
takes batch rows [kB/n, (k+1)B/n) to mesh.devices[k] through the same
kernel wrappers the engine calls on one device, so concatenating the
shards' outputs in shard order along the batch axis gives the one-device
results exactly.  A mesh may repeat a device (each entry is one shard),
which is how one card -- or the CPU, where every wrapper runs its plain
version -- runs a mesh of any size.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import numpy as np
import torch
import torch.distributed as dist

from tpu_align_torch.convert import arrays_to_tensors
from tpu_align_torch.core.params import Algorithm, AlignmentParams
from tpu_align_torch.io.bucketing import BucketSpec
from tpu_align_torch.kernels import fill as rowscan
from tpu_align_torch.kernels.banded import fill_banded_bucket_async
from tpu_align_torch.kernels.stagger import STRIPE_S, fill_stagger_bucket_async
from tpu_align_torch.runtime import profiler
from tpu_align_torch.traceback import device as td

KERNELS = ("auto", "stagger", "rowscan", "banded")
# the H100's SMs: a CPU shard, which runs the plain versions, picks its
# fill as that card would, so CPU runs take the card's code paths
CPU_SMS = 132
# pick_fill's crossover, measured on the H100 (PERF.md section 7): bands
# of RULE_BAND_ROWS query rows, the band wavefront's when it was read
RULE_MIN_BANDS = 8
RULE_BAND_ROWS = 128
RULE_MAX_PAIRS_PER_SM = 16


@dataclasses.dataclass(frozen=True)
class PairsMesh:
    """The `pairs` axis: one shard per entry of `devices` (torch.devices
    of one type, an entry possibly repeated)."""

    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device_type(self) -> str:
        return self.devices[0].type


def make_pairs_mesh(devices=None) -> PairsMesh:
    """1-D mesh over every visible CUDA device, or over the given ones.

    devices=None with no CUDA device visible raises: there is no CPU
    fallback.  A given list may name "cpu" (each entry a CPU shard running
    the plain versions) or CUDA devices, not both, and may repeat one."""
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
            raise RuntimeError(
                "make_pairs_mesh: no CUDA device visible "
                "(torch.cuda.is_available() is false); pass devices= to "
                "name the shards")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("a pairs mesh needs at least one device")
    kinds = sorted({d.type for d in devs})
    if len(kinds) > 1:
        raise ValueError(f"a pairs mesh's devices must be of one type, got "
                         f"{kinds}")
    if kinds[0] == "cuda":
        visible = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        devs = [torch.device("cuda", d.index if d.index is not None else
                             torch.cuda.current_device() if visible else 0)
                for d in devs]
        bad = sorted({str(d) for d in devs if d.index >= visible})
        if bad:
            raise ValueError(f"only {visible} devices visible, the mesh "
                             f"names {', '.join(bad)}")
    elif kinds[0] != "cpu":
        raise ValueError(f"unsupported mesh device type {kinds[0]!r}")
    return PairsMesh(tuple(devs))


def shard_bucket_spec(mesh: PairsMesh,
                      spec: BucketSpec | None = None) -> BucketSpec:
    """Adjust a BucketSpec so every bucket batch divides evenly across the
    mesh with a kernel-legal (multiple-of-8) per-device remainder."""
    spec = spec or BucketSpec()
    n = mesh.size
    return BucketSpec(
        query_multiple=spec.query_multiple,
        ref_multiple=spec.ref_multiple,
        batch_pairs=max(spec.batch_pairs, 8 * n),
        pair_multiple=8 * n,
    )


def shard_rows(batch: int, n: int) -> list[slice]:
    """The batch rows of each of n shards, in shard order."""
    per = batch // n
    return [slice(k * per, (k + 1) * per) for k in range(n)]


def pick_fill(algorithm: Algorithm, with_traceback: bool, qry_width: int,
              pairs: int, sms: int) -> str:
    """The fill kernel="auto" gives one shard's bucket: "banded" for BSW;
    the band wavefront, "rowscan", for a scores-only fill of pairs of at
    least RULE_MIN_BANDS 128-row bands (qry_width padded query rows),
    fewer than RULE_MAX_PAIRS_PER_SM a SM, where it led the stagger fill
    at every pair count measured on the H100 (PERF.md section 7); else
    "stagger", which leads on short pairs that fill the card one warp a
    pair, and which takes every fill with direction words (the layout the
    walks, the host decoders and the engine's joins expect).  pairs
    counts the shard's real pairs, sms its device's SMs."""
    if algorithm.is_banded:
        return "banded"
    if with_traceback:
        return "stagger"
    bands = -(-qry_width // RULE_BAND_ROWS)
    if bands >= RULE_MIN_BANDS and pairs < RULE_MAX_PAIRS_PER_SM * sms:
        return "rowscan"
    return "stagger"


@functools.cache
def sm_count(device: torch.device) -> int:
    """The SMs of a shard's device (CPU_SMS for a CPU shard)."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).multi_processor_count
    return CPU_SMS


def shard_kernels(mesh: PairsMesh, algorithm: Algorithm,
                  with_traceback: bool, kernel: str, qry_width: int,
                  ref_len, qry_len) -> list[str]:
    """The fill each shard of a bucket takes: `kernel`, "banded" for BSW,
    and under "auto" pick_fill's choice from the shard's real pairs (both
    sides non-empty), the bucket's padded query rows and its device's
    SMs.  ref_len and qry_len are the bucket's host lengths."""
    if algorithm.is_banded:
        kernel = "banded"
    if kernel not in KERNELS:
        raise ValueError(f"unknown kernel {kernel!r}")
    rows = shard_rows(len(ref_len), mesh.size)
    if kernel != "auto":
        return [kernel] * len(rows)
    real = (np.asarray(ref_len) > 0) & (np.asarray(qry_len) > 0)
    return [pick_fill(algorithm, with_traceback, qry_width,
                      int(np.count_nonzero(real[r])), sm_count(dev))
            for dev, r in zip(mesh.devices, rows)]


def dirs_batch_axis(kernel: str) -> int:
    """The batch axis of a fill's direction words: 3 for the stagger
    layout (stripes, W, S, B), which kernel="auto" writes, 1 for the row
    sweep's word-major (MW, B, N) and the banded (MW, B, K8) layouts."""
    return 1 if kernel in ("rowscan", "banded") else 3


def on_device(device: torch.device):
    """Context making `device` current for the kernels enqueued in it (a
    no-op for the CPU)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def gather(parts, axis: int = 0) -> torch.Tensor:
    """Per-shard tensors joined on the host along `axis` (shard order)."""
    return torch.cat([p.cpu() for p in parts], axis)


def fill_sharded(
    mesh: PairsMesh,
    algorithm: Algorithm,
    params: AlignmentParams,
    ref_tokens,
    qry_tokens,
    ref_len,
    qry_len,
    with_traceback: bool = True,
    kernel: str = "stagger",
    stripe_s: int | None = None,
    timer: profiler.PhaseTimer | None = None,
):
    """Run the fill data-parallel over the mesh's `pairs` axis.

    Inputs are host-global (B, ...) arrays, or host torch tensors (a
    pinned bucket's tokens, which upload without a staging copy), with B
    divisible by 8 * mesh size (a mesh of one shard takes any B whole).
    Returns (scores, srow, scol, dirs-or-None), each a tuple of per-shard
    tensors on the shards' devices, enqueued on each device's current
    stream (nothing waits; a CPU shard runs the plain version).
    kernel selects the fill ("stagger" default, "rowscan", or "banded" --
    forced for the banded aligner); "auto" picks one a shard by its shape
    (pick_fill: the shard's real pairs, its padded query rows and its
    device's SMs), the stagger fill wherever dirs are written.  stripe_s
    is the stagger stripe width (dirs layout (stripes, W, stripe_s, B) --
    the walk must be told the same value, which the engine guarantees).

    Each shard's upload is a "dispatch.upload" span of `timer` (a
    runtime.profiler.PhaseTimer), its fill's launch a "dispatch.enqueue";
    a launch on a card is counted (profiler.count_fill) from the shard's
    host lengths."""
    if timer is None:
        timer = profiler.PhaseTimer()
    if stripe_s is None:
        stripe_s = STRIPE_S
    b = ref_tokens.shape[0]
    n = mesh.size
    if n > 1 and b % (8 * n):
        raise ValueError(f"batch {b} not divisible by 8*{n} devices")
    args = (ref_tokens, qry_tokens, ref_len, qry_len)
    host = tuple(np.asarray(a) for a in args)
    picks = shard_kernels(mesh, algorithm, with_traceback, kernel,
                          host[1].shape[1], host[2], host[3])
    # host torch tensors (a pinned bucket's tokens) upload as themselves,
    # a shard's rows a view of them
    src = tuple(a if isinstance(a, torch.Tensor) else h
                for a, h in zip(args, host))
    outs = []
    for dev, rows, pick in zip(mesh.devices, shard_rows(b, n), picks):
        with on_device(dev):
            with timer.phase("dispatch.upload"):
                tensors = arrays_to_tensors(*(a[rows] for a in src), dev)
            with timer.phase("dispatch.enqueue"):
                if pick == "banded":
                    out = fill_banded_bucket_async(
                        algorithm, params, *tensors,
                        with_traceback=with_traceback)
                elif pick == "stagger":
                    out = fill_stagger_bucket_async(
                        algorithm, params, *tensors,
                        with_traceback=with_traceback, stripe_s=stripe_s)
                else:
                    out = rowscan.fill_bucket_async(
                        algorithm, params, *tensors,
                        with_traceback=with_traceback)
        if dev.type == "cuda":
            profiler.count_fill(pick, host[2][rows], host[3][rows],
                                params.band)
        outs.append(out)
    scores, srow, scol, dirs = (tuple(o[k] for o in outs) for k in range(4))
    return scores, srow, scol, dirs if with_traceback else None


@dataclasses.dataclass
class ShardedWalk:
    """The dispatched walks of a mesh's shards, in shard order."""

    handles: list[td.WalkHandle]

    def finalize(self) -> tuple:
        """Wait for every shard's walk and join them along the batch: the
        flat events of each shard (its first `total` slots) in shard order
        when every shard stayed in events mode, else every shard's packed
        stream, padded with no-move words to the longest.  Returns what
        device_walk_finalize_events returns for one bucket."""
        fins = [h.finalize() for h in self.handles]
        if len(fins) == 1:
            return fins[0]
        if all(f[0] == "events" for f in fins):
            flat = np.concatenate([f[1][:int(f[2].sum(dtype=np.int64))]
                                   for f in fins])
            return ("events", flat, *_join([f[2:] for f in fins]))
        fins = [f if f[0] == "stream" else td.stream_form(h, f[3:])
                for f, h in zip(fins, self.handles)]
        packed = _join_streams([f[1] for f in fins])
        return ("stream", packed, packed.shape[0] * td.MOVES_PER_WORD,
                *_join([f[3:] for f in fins]))


def _join(fields_by_shard) -> list[np.ndarray]:
    """Per-shard host arrays of each field, joined along axis 0."""
    return [np.concatenate(parts) for parts in zip(*fields_by_shard)]


def _join_streams(streams) -> np.ndarray:
    """Per-shard packed (T16_k, B_k) streams as one (max T16, sum B_k)
    stream; the shorter ones padded with no-move words."""
    t16 = max(p.shape[0] for p in streams)
    out = np.zeros((t16, sum(p.shape[1] for p in streams)), np.int32)
    at = 0
    for p in streams:
        out[:p.shape[0], at:at + p.shape[1]] = p
        at += p.shape[1]
    return out


def walk_sharded_dispatch(
    mesh: PairsMesh,
    algorithm: Algorithm,
    params: AlignmentParams,
    dirs, start_row, start_col, scores,
    stripe_s: int,
    extras: tuple = (),
    walker: str = "xla",
) -> ShardedWalk:
    """Device traceback walk, data-parallel over the `pairs` axis: each
    device walks its own shard of the direction words (the walk is
    per-pair independent) with the walk kernel and the event compaction
    behind its fill, so the full V8 pipeline -- fill + on-device walk --
    runs sharded and only events (or packed move streams) leave the
    devices.  dirs, start_row, start_col and scores are per-shard
    sequences, as fill_sharded returns them; each entry of `extras` is
    one too, and rides its shard's readback.  Stagger dirs (stripes, W,
    S, B) for LNW, LSW and ANW, banded (MW, B, K8) for BSW (stripe_s
    unread).  Returns a ShardedWalk for traceback.device.finalize_any.

    The port's walk needs no phase budget (a path bound sizes every
    stream) and no VMEM cap, so each shard takes the one-device dispatch
    whole; per-lane move sequences are the contract."""
    handles = []
    for k, dev in enumerate(mesh.devices):
        with on_device(dev):
            handles.append(td.device_walk_dispatch_events(
                algorithm, params, dirs[k], start_row[k], start_col[k],
                scores[k], stripe_s, walker=walker,
                extras=tuple(e[k] for e in extras)))
    return ShardedWalk(handles)


def walk_sharded(
    mesh: PairsMesh,
    algorithm: Algorithm,
    params: AlignmentParams,
    dirs, start_row, start_col, scores,
    stripe_s: int,
    walker: str = "xla",
):
    """Blocking sharded device walk.  Returns (packed (T16, B) np.int32,
    steps): the shards' packed move streams joined along B, padded with
    no-move words to the longest, and the stream's length in moves."""
    walk = walk_sharded_dispatch(mesh, algorithm, params, dirs, start_row,
                                 start_col, scores, stripe_s, walker=walker)
    packed = _join_streams([h.packed.cpu().numpy() for h in walk.handles])
    return packed, packed.shape[0] * td.MOVES_PER_WORD


def _shards_of(mesh: PairsMesh, x) -> list[torch.Tensor]:
    """Per-shard tensors: a per-shard sequence as given, or one host array
    split along axis 0 as fill_sharded splits a batch."""
    if isinstance(x, (list, tuple)):
        if len(x) != mesh.size:
            raise ValueError(f"{len(x)} shards for a mesh of {mesh.size}")
        return [torch.as_tensor(p) for p in x]
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
    return [p.to(dev) for p, dev in zip(torch.tensor_split(t, mesh.size),
                                        mesh.devices)]


def global_stats(mesh: PairsMesh, scores, cells) -> tuple[int, int]:
    """All-reduce run-level stats over the mesh: (max score, total cells).

    A max and a sum per shard on its device, a fold over the shards on the
    host, then -- when a process group of more than one process is up
    (multihost.initialize) -- an all_reduce (MAX, SUM) of the two over
    the group, on CPU tensors.  scores and cells are per-shard sequences
    (as fill_sharded returns them) or host arrays split across the mesh.
    The only collectives in the framework (SURVEY.md section 2.5 note 7).
    """
    lowest = torch.iinfo(torch.int64).min
    mx, total = lowest, 0
    for s, c in zip(_shards_of(mesh, scores), _shards_of(mesh, cells)):
        if s.numel():
            mx = max(mx, int(s.max()))
        total += int(c.sum(dtype=torch.int64))
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        mx_t = torch.tensor([mx], dtype=torch.int64)
        total_t = torch.tensor([total], dtype=torch.int64)
        dist.all_reduce(mx_t, op=dist.ReduceOp.MAX)
        dist.all_reduce(total_t, op=dist.ReduceOp.SUM)
        mx, total = int(mx_t), int(total_t)
    return mx, total
