"""The batch alignment engine on PyTorch: parse -> bucketize -> fill ->
traceback (host or device) -> format.

Port of tpu_align/runtime/engine.py for its four aligners: LNW, LSW and
ANW on the stagger fill (or the row-sweep fill: kernel="rowscan", and
where kernel="auto" picks it for a scores-only bucket), BSW on the banded
fill; host, device or Hirschberg traceback; records or
blocks output.  The pipeline keeps the reference's end-state V19 flow (SURVEY.md section 3.3):
a sliding window of at most max_inflight buckets is enqueued on the current
CUDA stream, each gathered into pinned host memory just before its
dispatch (while the buckets ahead of it fill), uploaded in one DMA and
followed by async D2H copies into pinned host buffers and a CUDA event;
the host waits only on the oldest bucket's event and finishes it while
later buckets still run -- the V19 "print batch N-1 while kernel N runs"
overlap (V19.cu:536-585).

traceback="host" copies the fill's direction words to the host and walks
them with the threaded native walker.  traceback="device" (the V8 move)
queues the walk and the event compaction behind the fill: the dirs never
leave the device, and only scores, per-lane event counts and the flat
events cross the bus (the packed move stream only when the events
overflow); the host replays and formats them natively.  On a CPU device
every kernel runs its plain PyTorch version synchronously.

traceback="hirschberg" stores no direction words at all: the pairs go
through traceback/hirschberg.py's divide and conquer (last-row fills, the
split reduction, leaves through this engine), for long pairs whose
direction tensor cannot be built.

local_mode="all" (LNW, LSW, BSW) enumerates every co-optimal path, which
needs each pair's score matrix: as in the JAX engine, it runs on the host
through the oracle's cross-pair batched numpy fill, and no kernel.

Phase accounting follows the reference's timer buckets (memory management /
kernel / backtracking / printing, V19.cu:675-680); GCUPS uses the parsed
numCells (c++/parseInput.cpp:100).
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import json
import os

import numpy as np
import torch

from tpu_align_torch.core.params import Algorithm, AlignmentParams
from tpu_align_torch.core.result import AlignmentResult, results_from_arrays
from tpu_align_torch.io.bucketing import (
    Bucket,
    BucketPlan,
    BucketSpec,
    gather_bucket,
    plan_buckets,
)
from tpu_align_torch.io.dataset import PairDataset
from tpu_align_torch.oracle.api import align_pair
from tpu_align_torch.oracle.traceback import traceback_pair
from tpu_align_torch.oracle.vectorized import fill_vectorized_batch
from tpu_align_torch.utils.hostmem import tune_malloc_for_large_buffers
from tpu_align_torch.convert import fill_to_numpy
from tpu_align_torch.distributed import sharding
from tpu_align_torch.kernels.stagger import STRIPE_S
from tpu_align_torch.runtime.profiler import PhaseTimer
from tpu_align_torch.traceback.device import (
    bucket_arrays_from_finalized,
    bucket_blocks_from_finalized,
    copy_to_host,
    finalize_any,
)
from tpu_align_torch.traceback.host import (
    traceback_bucket,
    traceback_bucket_arrays,
)


@dataclasses.dataclass
class EngineResult:
    results: list[AlignmentResult]  # sorted by pair_num (output="records")
    timer: PhaseTimer
    num_cells: int
    # output="blocks": the fully formatted reference-format byte stream
    # (pair order) and the matching per-pair scores; `results` is empty
    blocks: np.ndarray | None = None       # (total_bytes,) uint8
    pair_scores: np.ndarray | None = None  # (num_pairs,) int64, pair order

    @property
    def gcups(self) -> float:
        return self.timer.gcups(self.num_cells, "kernel")

    def output_bytes(self) -> bytes:
        """Reference-format output blocks as raw bytes (pair order)."""
        if self.blocks is not None:
            return self.blocks.tobytes()
        return self.output_text().encode("ascii")

    def output_text(self) -> str:
        """Reference-format output: 4-line blocks in pair order."""
        if self.blocks is not None:
            return self.blocks.tobytes().decode("ascii")
        return "".join(r.block() for r in self.results)

    def scores(self) -> np.ndarray:
        if self.pair_scores is not None:
            return self.pair_scores
        return np.array([r.score for r in self.results], np.int64)


class _BlockCollector:
    """Accumulates formatted output blocks bucket by bucket and assembles
    the final pair-ordered byte stream with the threaded native formatter
    (ta_format_blocks, the reference's printf loop,
    c++/backtrack.cpp:205-210) and one native multi-source gather
    (ta_gather_parts).  Oracle-path pairs (empty sides) enter as
    AlignmentResults and are formatted in Python; both entry points give
    byte-identical blocks."""

    def __init__(self):
        # (ids int64 (B,), scores int64 (B,), chunk uint8, spans int64 (B,2))
        self.parts: list[tuple] = []

    def add_arrays(self, ids, scores, out_buf, out_lens) -> None:
        from tpu_align_torch import native

        native.require("the block formatter")
        ids = np.asarray(ids)
        scores = np.asarray(scores)
        chunk, spans = native.native_format_blocks(ids, scores, out_buf,
                                                   out_lens)
        self.parts.append((ids.astype(np.int64), scores.astype(np.int64),
                           chunk, spans))

    def add_chunk(self, ids, scores, chunk, spans) -> None:
        """Add pre-formatted blocks (a restored checkpoint part): chunk
        holds each pair's 4-line block at spans[b] = (offset, length)."""
        self.parts.append((np.asarray(ids, np.int64).reshape(-1),
                           np.asarray(scores, np.int64).reshape(-1),
                           chunk, spans))

    def add_scores(self, ids, scores) -> None:
        """Scores-only blocks: header line + three empty lines (the
        reference's V6 output shape)."""
        n = np.asarray(ids).shape[0]
        self.add_arrays(ids, scores, np.zeros((n, 3, 1), np.uint8),
                        np.zeros(n, np.int32))

    def add_results(self, results: list[AlignmentResult]) -> None:
        if not results:
            return
        blobs = [r.block().encode("ascii") for r in results]
        spans = np.zeros((len(blobs), 2), np.int64)
        at = 0
        for k, blob in enumerate(blobs):
            spans[k] = (at, len(blob))
            at += len(blob)
        self.parts.append((
            np.array([r.pair_num for r in results], np.int64),
            np.array([r.score for r in results], np.int64),
            np.frombuffer(b"".join(blobs), np.uint8), spans,
        ))

    def finalize(self):
        """-> (blocks uint8 byte stream, scores int64), both pair-ordered."""
        from tpu_align_torch import native

        if not self.parts:
            return np.zeros(0, np.uint8), np.zeros(0, np.int64)
        ids = np.concatenate([p[0] for p in self.parts])
        scores = np.concatenate([p[1] for p in self.parts])
        spans = np.vstack([p[3] for p in self.parts])
        part_of = np.concatenate([
            np.full(p[3].shape[0], k, np.int32)
            for k, p in enumerate(self.parts)
        ])
        order = np.argsort(ids, kind="stable")
        native.require("the ordered block gather")
        blocks = native.native_gather_parts([p[2] for p in self.parts],
                                            spans, part_of, order)
        return blocks, scores[order]


class AlignmentEngine:
    """Aligns PairDatasets with the port's kernels: the stagger fill (LNW,
    LSW, ANW; kernel="stagger"), the row-sweep fill's band wavefront
    (kernel="rowscan", host traceback over its word-major dirs) or the
    banded fill (BSW, whatever `kernel` says, as in the JAX engine), then
    the native host walk or the device walk -- or, with
    traceback="hirschberg" (LNW, LSW, ANW), the O(M+N)-memory
    divide-and-conquer traceback of traceback/hirschberg.py.

    Takes the JAX engine's arguments plus an explicit `device` ("cuda",
    "cuda:N" or "cpu"; a CPU device runs every kernel's plain PyTorch
    version, so there is no interpret mode).  traceback="device" needs
    the stagger fill (or BSW), as in the JAX engine.

    mesh (distributed.make_pairs_mesh) runs each bucket data-parallel over
    the mesh's devices, which must be of `device`'s type: bucket batches
    divide evenly across the shards (shard_bucket_spec), each shard's
    fill -- and device walk and compaction -- runs on its own device, and
    the host joins the shards (their dirs for the host walk, their events
    or move streams for the replay), so the output is byte-identical to
    the one-device run.  Without a mesh the engine runs the same path on
    a mesh of one shard, `device`, which takes each bucket whole.
    Hirschberg and all-paths refuse a mesh.

    local_mode (local aligners and LNW): "single" follows the CUDA host
    semantics (one path a pair); "all" enumerates every co-optimal path
    (the CPU BACKTRACK_ALL switch, c++/LinearSmithWaterman.h:9; every
    co-optimal global path for LNW), on the host for every pair -- the
    oracle's batched numpy fill, no kernel.  ANW refuses it.

    walker ("xla" or "pallas") names the JAX package's device-walk
    engine.  The two give the same moves by contract, and both run the one
    CUDA walk kernel here (its plain version on CPU); the value is checked
    and otherwise has no effect.

    with_traceback=False gives the scores-only fast path (no direction
    words, no alignment strings -- the V6 mode, V6.cu:28-35).

    kernel="auto" (the default) picks a fill a bucket -- a shard's rows on
    a mesh -- in distributed/sharding.py `pick_fill`: the band wavefront
    for a scores-only bucket of long pairs (at least 8 bands of 128 query
    rows; fewer than 16 pairs a SM), the stagger fill for every other
    bucket and every fill with direction words, so every traceback mode
    sees the stagger layout.

    max_inflight bounds the buckets (fills, and with device traceback
    walks) enqueued ahead of the consumer
    (the reference's STREAM_BATCH_SIZE, cuda/LNW/LinearNeedlemanWunschV13.cu
    :10): device and pinned host memory hold at most that many buckets'
    tokens and direction tensors.  0 / None = unbounded.

    output="blocks" skips per-pair AlignmentResult objects: walker arrays
    feed the native block formatter and EngineResult carries one
    pair-ordered byte stream, byte-identical to the "records" text.
    """

    def __init__(
        self,
        algorithm: Algorithm,
        params: AlignmentParams | None = None,
        bucket_spec: BucketSpec | None = None,
        with_traceback: bool = True,
        local_mode: str = "single",
        max_inflight: int = 4,
        kernel: str = "auto",
        traceback: str = "host",
        output: str = "records",
        mesh=None,
        stripe_s: int | None = None,
        device: str | torch.device = "cuda",
        walker: str = "xla",
    ):
        if local_mode not in ("single", "all"):
            raise ValueError(f"unknown local_mode {local_mode!r}")
        if local_mode == "all" and algorithm is Algorithm.ANW:
            raise ValueError(
                "local_mode='all' supports lsw/bsw (BACKTRACK_ALL) and lnw "
                "(co-optimal global paths), not the affine aligner")
        self.local_mode = local_mode
        if kernel not in ("auto", "stagger", "rowscan"):
            raise ValueError(f"unknown kernel {kernel!r}")
        self.kernel = kernel
        if traceback not in ("host", "device", "hirschberg"):
            raise ValueError(f"unknown traceback mode {traceback!r}")
        if (traceback == "device" and kernel == "rowscan"
                and not algorithm.is_banded):
            raise ValueError(
                "traceback='device' requires the stagger kernel "
                "(LNW/LSW/ANW) or the banded BSW kernel")
        if traceback == "hirschberg" and algorithm.is_banded:
            raise ValueError(
                "traceback='hirschberg' supports LNW/LSW/ANW (BSW "
                "direction storage is already O(M*band))")
        self.traceback_mode = traceback
        if walker not in ("xla", "pallas"):
            raise ValueError(f"unknown walker {walker!r}")
        if output not in ("records", "blocks"):
            raise ValueError(f"unknown output mode {output!r}")
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"device {self.device} requested but "
                    "torch.cuda.is_available() is false")
        elif self.device.type != "cpu":
            raise ValueError(f"unsupported device {self.device}")
        self.algorithm = algorithm
        self.params = params or AlignmentParams()
        self.bucket_spec = bucket_spec or BucketSpec()
        if mesh is not None:
            if traceback == "hirschberg" or local_mode == "all":
                raise ValueError(
                    "mesh covers the bucketed kernel path; hirschberg and "
                    "all-paths modes run their own fills -- use host_shard "
                    "to split those workloads across processes instead")
            if mesh.device_type != self.device.type:
                raise ValueError(
                    f"mesh devices {list(map(str, mesh.devices))} are not "
                    f"of the engine's device type ({self.device})")
            self.bucket_spec = sharding.shard_bucket_spec(
                mesh, self.bucket_spec)
        else:
            mesh = sharding.PairsMesh((self.device,))
        self.mesh = mesh
        self.with_traceback = with_traceback
        self.walker = walker
        # the device walk needs dirs; scores-only runs take the host path
        self.device_tb = traceback == "device" and with_traceback
        self.max_inflight = max_inflight or 0
        self.output = output
        self.stripe_s = int(stripe_s) if stripe_s else STRIPE_S
        # the fill each bucket takes, and the dirs layout it writes as
        # fill_to_numpy tags it
        if algorithm.is_banded:
            self._layout = {"band": self.params.band}
        elif self.kernel == "rowscan":
            self._layout = {"rowscan": True}
        else:
            self._layout = {"stripe_s": self.stripe_s}
        # the host pipeline reallocates ~100 MB of block buffers per run;
        # keep them heap-resident (utils/hostmem.py)
        tune_malloc_for_large_buffers()

    def _oracle_fallback(self, ds: PairDataset, i: int) -> AlignmentResult:
        ref, qry = ds.pair(i)
        return align_pair(self.algorithm, self.params, ref, qry, pair_num=i,
                          engine="scalar", local_mode=self.local_mode)

    def _dispatch(self, b: Bucket, timer: PhaseTimer):
        """Upload one bucket's raw tokens shard by shard and enqueue each
        shard's fill -- and, with device traceback, its walk and
        compaction -- on its own device (distributed/sharding.py).  Returns
        a ShardedWalk for device traceback, else a list of (outs, done),
        one a shard: on CUDA, outs are pinned host tensors that an async
        D2H fills and `done` the event that marks the copies complete; on
        CPU, the fill's own tensors and None.  The uploads are
        "dispatch.upload" spans of `timer`; the launches, and the copies
        queued behind them, "dispatch.enqueue"."""
        outs = sharding.fill_sharded(
            self.mesh, self.algorithm, self.params,
            *b.upload_tokens, b.ref_len, b.qry_len,
            with_traceback=self.with_traceback, kernel=self.kernel,
            stripe_s=self.stripe_s, timer=timer)
        with timer.phase("dispatch.enqueue"):
            if self.device_tb:
                scores, srow, scol, dirs = outs
                # global start cells are the lengths, which the host knows
                extras = ((scores, srow, scol) if self.algorithm.is_local
                          else (scores,))
                # the dirs die here, after the walk and compaction were
                # queued behind them on the same stream
                return sharding.walk_sharded_dispatch(
                    self.mesh, self.algorithm, self.params, dirs, srow, scol,
                    scores, self.stripe_s, extras=extras, walker=self.walker)
            jobs = []
            for k, dev in enumerate(self.mesh.devices):
                shard = tuple(None if o is None else o[k] for o in outs)
                with sharding.on_device(dev):
                    jobs.append(self._to_host(shard, dev))
            return jobs

    @staticmethod
    def _to_host(outs, device) -> tuple:
        """(host tensors, done) of a fill's outputs (dirs may be None)."""
        host, done = copy_to_host([t for t in outs if t is not None],
                                   device)
        return host + (None,) * (len(outs) - len(host)), done

    def _wait_fill(self, jobs, timer: PhaseTimer) -> tuple:
        """Wait for a bucket's fill copies (a "kernel.wait" span of
        `timer`) and join its shards along the batch axis (one shard: its
        tensors as they are)."""
        with timer.phase("kernel.wait"):
            for _, done in jobs:
                if done is not None:
                    done.synchronize()
        if len(jobs) == 1:
            return jobs[0][0]
        axis = sharding.dirs_batch_axis(
            "banded" if self.algorithm.is_banded else self.kernel)
        parts = list(zip(*(outs for outs, _ in jobs)))
        return tuple(
            None if p[0] is None else sharding.gather(p, axis if k == 3 else 0)
            for k, p in enumerate(parts))

    def _finalize_args(self, b: Bucket) -> tuple:
        """finalize_any's arguments beyond the handle: a global walk starts
        at (qlen, rlen), which the host has, so only the scores rode the
        copies; a local walk's start cells rode them too."""
        if self.algorithm.is_local:
            return ()
        return (None, np.ascontiguousarray(b.qry_len, np.int32),
                np.ascontiguousarray(b.ref_len, np.int32))

    def warmup(self, ds: PairDataset) -> None:
        """Take one bucket of each distinct bucket shape (and fill kernel,
        which kernel="auto" picks a bucket) this dataset's run will take
        through its fill -- and, under device traceback, its
        walk and compaction, finalized -- then wait for the engine's
        devices (every shard's on a mesh).  On the card this moves the
        kernels' first-use build and the allocators' first allocations out
        of `run`.  Hirschberg and all-paths take no bucket fill, so there
        is nothing to warm for them."""
        if self.local_mode == "all" or (self.traceback_mode == "hirschberg"
                                        and self.with_traceback):
            return
        seen: set[tuple] = set()
        timer = PhaseTimer()
        for plan in self._plans_of(ds):
            b = self._gather(ds, plan)
            shape = (b.ref_tokens.shape, b.qry_tokens.shape,
                     *sharding.shard_kernels(
                         self.mesh, self.algorithm, self.with_traceback,
                         self.kernel, b.qry_tokens.shape[1], b.ref_len,
                         b.qry_len))
            if shape in seen:
                continue
            seen.add(shape)
            job = self._dispatch(b, timer)
            if self.device_tb:
                finalize_any(job, *self._finalize_args(b))
            else:
                self._wait_fill(job, timer)
        for dev in self.mesh.devices:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def _plans_of(self, ds: PairDataset,
                  timer: PhaseTimer | None = None) -> list[BucketPlan]:
        """The buckets of the kernel-eligible pairs as planned, their
        indices dataset ids (io/bucketing.py plan_buckets, its
        "memmgmt.group" span in `timer`)."""
        main_idx = np.flatnonzero((ds.ref_len > 0) & (ds.qry_len > 0))
        return [p._replace(idx=main_idx[p.idx]) for p in
                plan_buckets(ds.select(main_idx), self.bucket_spec, timer)]

    def _gather(self, ds: PairDataset, plan: BucketPlan) -> Bucket:
        """A plan's bucket; a CUDA engine's tokens in pinned host memory,
        so their upload is one DMA with no staging copy."""
        return gather_bucket(ds, plan, self.bucket_spec,
                             pinned=self.device.type == "cuda")

    def _buckets_of(self, ds: PairDataset) -> list[Bucket]:
        """Every bucket of the kernel-eligible pairs, gathered, with
        dataset-level pair ids."""
        return [self._gather(ds, plan) for plan in self._plans_of(ds)]

    def _bucket_key(self, b: Bucket) -> str:
        """Content hash identifying one bucket's work for checkpointing."""
        h = hashlib.sha1()
        h.update(repr((self.algorithm.value, self.params,
                       self.with_traceback)).encode())
        for arr in (b.pair_ids, b.ref_len, b.qry_len):
            h.update(np.ascontiguousarray(arr).tobytes())
        h.update(b.ref_tokens.tobytes())
        h.update(b.qry_tokens.tobytes())
        return h.hexdigest()[:24]

    @staticmethod
    def _load_checkpoint(path: str) -> list[AlignmentResult] | None:
        try:
            with open(path) as f:
                payload = json.load(f)
        except (OSError, ValueError):
            return None
        return [
            AlignmentResult(*rec[:5], extra_paths=[tuple(p) for p in rec[5]])
            if len(rec) > 5 else AlignmentResult(*rec)
            for rec in payload
        ]

    @staticmethod
    def _save_checkpoint(path: str, results: list[AlignmentResult]) -> None:
        payload = [
            [r.pair_num, r.score, r.ref_aligned, r.relation, r.query_aligned]
            + ([[list(p) for p in r.extra_paths]] if r.extra_paths else [])
            for r in results
        ]
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)  # atomic: a checkpoint is whole or absent

    @staticmethod
    def _load_blocks_checkpoint(path: str):
        """Blocks-path bucket checkpoint: one _BlockCollector part
        (ids, scores, chunk, spans) persisted as .npz."""
        try:
            with np.load(path) as z:
                return (z["ids"], z["scores"], z["chunk"], z["spans"])
        except (OSError, ValueError, KeyError):
            return None

    @staticmethod
    def _save_blocks_checkpoint(path: str, part) -> None:
        ids, scores, chunk, spans = part
        tmp = path + ".tmp.npz"
        with open(tmp, "wb") as f:
            np.savez(f, ids=ids, scores=scores, chunk=chunk, spans=spans)
        os.replace(tmp, path)  # atomic: a checkpoint is whole or absent

    def _all_paths(self, ds: PairDataset) -> list[AlignmentResult]:
        """Every co-optimal path of every pair (tpu_align/runtime/engine.py
        :576-613): the pairs with both sides non-empty, sorted by length,
        filled by the oracle's cross-pair batched numpy fill in chunks of
        1024 (so resident memory stays O(chunk): a FillResult holds a
        pair's whole score matrix, ~315 KB at 250 bp), each enumerated;
        the pairs with an empty side through the scalar oracle."""
        full = [i for i in range(len(ds))
                if ds.ref_len[i] > 0 and ds.qry_len[i] > 0]
        full.sort(key=lambda k: (int(ds.qry_len[k]), int(ds.ref_len[k])))
        results = []
        step = 1024
        for at in range(0, len(full), step):
            part = full[at: at + step]
            fills = fill_vectorized_batch(self.algorithm, self.params,
                                          [ds.pair(i) for i in part])
            for i, fill in zip(part, fills):
                ref, qry = ds.pair(i)
                results.append(traceback_pair(
                    fill, ref, qry, pair_num=i, local_mode=self.local_mode,
                    params=self.params))
        for i in range(len(ds)):
            if ds.ref_len[i] == 0 or ds.qry_len[i] == 0:
                results.append(self._oracle_fallback(ds, i))
        return results

    @staticmethod
    def _finish_host(results, timer, ds, collector) -> EngineResult:
        """Results of a host-side mode (all-paths, Hirschberg) in pair
        order, as records or through the block collector."""
        with timer.phase("printing"):
            results.sort(key=lambda r: r.pair_num)
            if collector is not None:
                collector.add_results(results)
                blocks, pair_scores = collector.finalize()
                return EngineResult([], timer, ds.num_cells, blocks=blocks,
                                    pair_scores=pair_scores)
        return EngineResult(results, timer, ds.num_cells)

    def run(self, ds: PairDataset, checkpoint_dir: str | None = None,
            timer: PhaseTimer | None = None) -> EngineResult:
        """Align a dataset.  With checkpoint_dir set, each bucket's results
        are persisted after its traceback and already-checkpointed buckets
        are skipped on re-run (batch-level resume).

        timer: the PhaseTimer the run's phases go to, as a batch of its
        own (a new one by default); PhaseTimer(record=True) keeps the
        spans.  Phases: memmgmt (.group, .gather), dispatch (.upload,
        .enqueue), kernel (.wait, .convert), backtrack (.wait under device
        traceback; .fill, .reduce, .endpoints, .leaves under Hirschberg)
        and printing (.blocks, .finalize); a bucket's spans carry its id,
        its index among the run's buckets."""
        timer = timer or PhaseTimer()
        timer.start_batch()
        collector = _BlockCollector() if self.output == "blocks" else None
        hirschberg = self.traceback_mode == "hirschberg" and self.with_traceback
        if checkpoint_dir:
            if self.local_mode == "all" or hirschberg:
                raise ValueError(
                    "checkpoint_dir is not supported with local_mode='all' "
                    "or traceback='hirschberg' (those modes bypass the "
                    "bucketed kernel path that checkpoints persist)")
            os.makedirs(checkpoint_dir, exist_ok=True)
        if self.local_mode == "all":
            with timer.phase("backtrack"):
                results = self._all_paths(ds)
            return self._finish_host(results, timer, ds, collector)
        if hirschberg:
            # no direction tensor exists in any memory; for long pairs
            from tpu_align_torch.traceback.hirschberg import (
                hirschberg_align_batch,
            )

            with timer.phase("backtrack"):
                results = hirschberg_align_batch(
                    self.algorithm, self.params,
                    [ds.pair(i) for i in range(len(ds))],
                    device=self.device, timer=timer)
            return self._finish_host(results, timer, ds, collector)
        # pairs with an empty side cannot enter the kernel (no DP interior);
        # they fall back to the oracle
        empty_idx = np.flatnonzero((ds.ref_len == 0) | (ds.qry_len == 0))
        with timer.phase("memmgmt"):
            plans = self._plans_of(ds, timer)

        results: list[AlignmentResult] = []
        # Sliding-window dispatch (the V13 STREAM_BATCH_SIZE bound): at
        # most max_inflight buckets outstanding; the consumer waits on the
        # oldest while the rest still run (the V19 overlap).  A bucket is
        # gathered just before its dispatch, while the buckets ahead of it
        # fill, and its host arrays live until it is finished.
        limit = self.max_inflight or len(plans)
        inflight: collections.deque = collections.deque()
        next_up = 0

        def _top_up():
            nonlocal next_up
            while next_up < len(plans) and len(inflight) < limit:
                k = next_up
                next_up += 1
                with timer.on_bucket(k):
                    with timer.phase("memmgmt"), \
                            timer.phase("memmgmt.gather"):
                        b = self._gather(ds, plans[k])
                    base = None
                    if checkpoint_dir:
                        base = os.path.join(checkpoint_dir,
                                            self._bucket_key(b))
                        if self._restore(base, results, collector):
                            continue
                    with timer.phase("dispatch"):
                        inflight.append((k, b, base,
                                         self._dispatch(b, timer)))

        _top_up()
        while inflight:
            # no name here holds the finished bucket, so its pinned
            # tokens are free again before the next gather
            self._retire(*inflight.popleft(), timer, collector, results)
            _top_up()  # refill the dispatch window
        with timer.phase("backtrack"):
            oracle = [self._oracle_fallback(ds, int(i)) for i in empty_idx]
        with timer.phase("printing"):
            if collector is not None:
                collector.add_results(oracle)
                with timer.phase("printing.finalize"):
                    blocks, pair_scores = collector.finalize()
                return EngineResult([], timer, ds.num_cells, blocks=blocks,
                                    pair_scores=pair_scores)
            results.extend(oracle)
            results.sort(key=lambda r: r.pair_num)
        return EngineResult(results, timer, ds.num_cells)

    def _restore(self, base: str, results: list, collector) -> bool:
        """Take a bucket's output from its checkpoint at `base` (no
        suffix), into `collector` or `results`; False where there is
        none."""
        if collector is not None:
            part = self._load_blocks_checkpoint(base + ".npz")
            if part is not None:
                collector.add_chunk(*part)
            return part is not None
        restored = self._load_checkpoint(base + ".json")
        if restored is not None:
            results.extend(restored)
        return restored is not None

    def _retire(self, k: int, b: Bucket, base: str | None, job,
                timer: PhaseTimer, collector, results: list) -> None:
        """Finish dispatched bucket k, into `collector` or `results`, and
        checkpoint its output at `base` (no suffix) where one is given."""
        with timer.on_bucket(k):
            bucket_results = self._finish_bucket(b, job, timer, collector)
            if collector is None:
                results.extend(bucket_results)
            if base is None:
                return
            with timer.phase("printing"):
                if collector is not None:
                    self._save_blocks_checkpoint(base + ".npz",
                                                 collector.parts[-1])
                else:
                    self._save_checkpoint(base + ".json", bucket_results)

    def _finish_bucket(self, b: Bucket, job, timer: PhaseTimer, collector):
        """Wait for one dispatched bucket and take it through its
        traceback into the collector; returns its AlignmentResults without
        one (output="records"), else None."""
        nb = b.num_real
        if self.device_tb:
            # the V8 move: the walk ran on the device behind the fill;
            # wait for this bucket's events (later buckets keep running)
            with timer.phase("backtrack"), timer.phase("backtrack.wait"):
                fin = finalize_any(job, *self._finalize_args(b))
            if collector is None:
                with timer.phase("backtrack"):
                    sc, out_buf, out_lens = bucket_arrays_from_finalized(
                        self.algorithm, b, self.params, fin)
                    return results_from_arrays(b.pair_ids, sc, out_buf,
                                               out_lens, nb)
            with timer.phase("printing"), timer.phase("printing.blocks"):
                # fused native replay + format of the events; the
                # stream form goes through the arrays
                part = bucket_blocks_from_finalized(
                    self.algorithm, b, self.params, fin)
                if part is not None:
                    collector.add_chunk(*part)
                else:
                    sc, out_buf, out_lens = bucket_arrays_from_finalized(
                        self.algorithm, b, self.params, fin)
                    collector.add_arrays(b.pair_ids[:nb], sc, out_buf,
                                         out_lens)
            return None
        with timer.phase("kernel"):
            # blocks only on this bucket; later fills keep running
            host = self._wait_fill(job, timer)
            with timer.phase("kernel.convert"):
                fill = fill_to_numpy(*host, **self._layout)
        if collector is not None and self.with_traceback:
            with timer.phase("backtrack"):
                arrays = traceback_bucket_arrays(self.algorithm, b, fill,
                                                 self.params)
            with timer.phase("printing"), timer.phase("printing.blocks"):
                collector.add_arrays(b.pair_ids[:nb], fill.scores[:nb],
                                     *arrays)
            return None
        if collector is not None:
            with timer.phase("printing"), timer.phase("printing.blocks"):
                collector.add_scores(b.pair_ids[:nb], fill.scores[:nb])
            return None
        with timer.phase("backtrack"):
            if self.with_traceback:
                return traceback_bucket(self.algorithm, b, fill, self.params)
            return [AlignmentResult(int(b.pair_ids[row]),
                                    int(fill.scores[row]))
                    for row in range(nb)]


def align_file(
    path,
    algorithm: Algorithm,
    params: AlignmentParams | None = None,
    **engine_kwargs,
) -> EngineResult:
    """Parse a 3-line pair file and align it (the c++/main.cpp entry path)."""
    from tpu_align_torch.io.dataset import parse_pair_file

    ds = parse_pair_file(path)
    return AlignmentEngine(algorithm, params, **engine_kwargs).run(ds)
