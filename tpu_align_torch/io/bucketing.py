"""Length bucketing: the replacement for per-pair matrix mallocs.

The port's copy of tpu_align/io/bucketing.py; buckets are byte-identical.

The reference allocates a matrix per pair exactly sized to that pair
(cuda/LNW/LinearNeedlemanWunschV3.cu per-pair cudaMallocs, flattened into
one prefix-summed allocation in V9).  A batched kernel wants fixed shapes, so
we group pairs into (query_pad, ref_pad) buckets -- lengths rounded up to
hardware-friendly multiples -- and batch each bucket.  Within a batch the
pair axis is the fills' parallel axis (SURVEY.md section 7:
batch-across-lanes is the recommended default).

Padding bytes for reference and query differ (0 vs 1) so a padded cell can
never look like a match; kernels additionally mask by true lengths.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

from tpu_align_torch.io.dataset import PairDataset

PAD_REF = 0
PAD_QRY = 1


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """Bucketing policy.

    query_multiple: query padding granularity (DP row loop length).
    ref_multiple:   reference padding granularity (lane axis; 128 = VPU width).
    batch_pairs:    max pairs per batch (the V19 BATCH_SIZE analogue,
                    cuda/LNW/LinearNeedlemanWunschV19.cu:9).
    pair_multiple:  batch row padding granularity (sublane axis).
    """

    query_multiple: int = 32  # coarse default: every distinct kernel shape
    #                           costs a compile (minutes on remote backends)
    ref_multiple: int = 128
    batch_pairs: int = 2048
    pair_multiple: int = 8

    def padded_shape(self, qry_len: int, ref_len: int) -> tuple[int, int]:
        return (
            _round_up(max(qry_len, 1), self.query_multiple),
            _round_up(max(ref_len, 1), self.ref_multiple),
        )


@dataclasses.dataclass
class Bucket:
    """One fixed-shape batch of pairs ready for the fill kernel.

    ref_tokens: (B, N) uint8, PAD_REF beyond ref_len
    qry_tokens: (B, M) uint8, PAD_QRY beyond qry_len
    pair_ids:   (B,) int64 original dataset indices, -1 for padding rows
    """

    ref_tokens: np.ndarray
    qry_tokens: np.ndarray
    ref_len: np.ndarray  # (B,) int32
    qry_len: np.ndarray  # (B,) int32
    pair_ids: np.ndarray  # (B,) int64
    num_real: int
    # gather_bucket(pinned=True): the page-locked (ref, qry) torch tensors
    # that own ref_tokens' and qry_tokens' memory
    pinned: tuple | None = None

    @property
    def batch(self) -> int:
        return self.ref_tokens.shape[0]

    @property
    def padded_qry(self) -> int:
        return self.qry_tokens.shape[1]

    @property
    def padded_ref(self) -> int:
        return self.ref_tokens.shape[1]

    @property
    def real_cells(self) -> int:
        n = self.num_real
        return int(np.sum(self.ref_len[:n].astype(np.int64) * self.qry_len[:n]))

    @property
    def padded_cells(self) -> int:
        return self.batch * self.padded_qry * self.padded_ref

    @property
    def upload_tokens(self) -> tuple:
        """(ref, qry) tokens as an upload takes them: the pinned tensors
        where the gather made them, else the numpy arrays."""
        return self.pinned or (self.ref_tokens, self.qry_tokens)


class BucketPlan(NamedTuple):
    """One bucket as planned, before its gather: its pairs' dataset
    indices (input order) and its padded query and reference widths."""

    idx: np.ndarray
    padded_qry: int
    padded_ref: int


def _gather_padded(buf: np.ndarray, off: np.ndarray, lens: np.ndarray,
                   pad: int, out: np.ndarray) -> None:
    """Flat-buffer -> padded token rows, written into `out` (rows, width)
    uint8: threaded native memcpy pass when available, vectorized numpy
    otherwise."""
    n = len(off)
    if n:
        from tpu_align_torch.native import native_gather_padded

        if native_gather_padded(buf, off, lens, *out.shape, pad,
                                out=out) is not None:
            return
    out.fill(pad)
    if n == 0 or buf.size == 0:  # all-empty dataset: nothing to gather
        return
    col = np.arange(out.shape[1], dtype=np.int64)
    pos = np.minimum(off[:, None] + col, buf.size - 1)
    np.copyto(out[:n], buf[pos], where=col < lens[:, None])


def _token_rows(rows: int, width: int, pinned: bool):
    """-> (owning torch tensor or None, (rows, width) uint8 numpy array)."""
    if not pinned:
        return None, np.empty((rows, width), np.uint8)
    import torch

    t = torch.empty((rows, width), dtype=torch.uint8, pin_memory=True)
    return t, t.numpy()


def gather_bucket(ds: PairDataset, plan: BucketPlan,
                  spec: BucketSpec | None = None,
                  pinned: bool = False) -> Bucket:
    """A plan's bucket: its pairs' tokens gathered into padded rows, its
    lengths and pair ids (the plan's indices) beside them.

    pinned=True gathers the tokens straight into page-locked torch tensors
    from torch's caching host allocator, kept in Bucket.pinned, whose
    numpy views are ref_tokens and qry_tokens: an upload from them
    (convert.arrays_to_tensors) is one DMA, with no staging copy."""
    spec = spec or BucketSpec()
    idx, mq, nr = plan
    b_real = len(idx)
    b = _round_up(b_real, spec.pair_multiple)
    rl = ds.ref_len[idx]
    ql = ds.qry_len[idx]
    ref_t, ref_tokens = _token_rows(b, nr, pinned)
    qry_t, qry_tokens = _token_rows(b, mq, pinned)
    _gather_padded(ds.buffer, ds.ref_off[idx], rl, PAD_REF, ref_tokens)
    _gather_padded(ds.buffer, ds.qry_off[idx], ql, PAD_QRY, qry_tokens)
    ref_len = np.zeros(b, np.int32)
    qry_len = np.zeros(b, np.int32)
    pair_ids = np.full(b, -1, np.int64)
    ref_len[:b_real] = rl
    qry_len[:b_real] = ql
    pair_ids[:b_real] = idx
    return Bucket(ref_tokens, qry_tokens, ref_len, qry_len, pair_ids, b_real,
                  pinned=(ref_t, qry_t) if pinned else None)


def plan_buckets(ds: PairDataset, spec: BucketSpec | None = None,
                 timer=None) -> list[BucketPlan]:
    """bucketize's grouping, without the gathers: pairs grouped by padded
    shape (a "memmgmt.group" span of `timer`), input order kept within a
    group, each group cut into plans of at most spec.batch_pairs."""
    if timer is None:
        from tpu_align_torch.runtime.profiler import PhaseTimer

        timer = PhaseTimer()
    spec = spec or BucketSpec()
    if len(ds) == 0:
        return []
    with timer.phase("memmgmt.group"):
        mq = np.maximum(ds.qry_len, 1)
        nr = np.maximum(ds.ref_len, 1)
        pad_q = -(-mq // spec.query_multiple) * spec.query_multiple
        pad_r = -(-nr // spec.ref_multiple) * spec.ref_multiple
        # group by (pad_q, pad_r) via lexicographic sort, stable so pair
        # order kept
        order = np.lexsort((np.arange(len(ds)), pad_r, pad_q))
        keys = pad_q[order] * (1 << 32) + pad_r[order]
        boundaries = np.flatnonzero(np.diff(keys)) + 1
        plans = []
        for g in np.split(order, boundaries):
            g = np.sort(g)  # each group in input order
            q, r = int(pad_q[g[0]]), int(pad_r[g[0]])
            plans.extend(BucketPlan(g[s : s + spec.batch_pairs], q, r)
                         for s in range(0, len(g), spec.batch_pairs))
    return plans


def bucketize(ds: PairDataset, spec: BucketSpec | None = None,
              timer=None) -> list[Bucket]:
    """Group pairs into fixed-shape buckets, preserving input order within
    each bucket (output ordering across buckets is restored later by pair id,
    the job scripts/reorderOutput.py does for the reference): plan_buckets,
    then gather_bucket of each plan.

    timer (a runtime.profiler.PhaseTimer) takes the spans "memmgmt.group"
    (the sort and split) and "memmgmt.gather" (a bucket's padded token
    gathers, under the bucket's id: its index in the list returned)."""
    if timer is None:
        from tpu_align_torch.runtime.profiler import PhaseTimer

        timer = PhaseTimer()
    buckets = []
    for k, plan in enumerate(plan_buckets(ds, spec, timer)):
        with timer.on_bucket(k), timer.phase("memmgmt.gather"):
            buckets.append(gather_bucket(ds, plan, spec))
    return buckets
