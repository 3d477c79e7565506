"""Buckets onto a torch device, fills back to the host.

The system has no weights: the state a fill works on is a `Bucket` (numpy
tokens, lengths and pair ids, io/bucketing.py) and the `AlignmentParams`.
These helpers move a bucket onto a torch device and bring a fill back as
the `BucketFill` the native host walker consumes.  The port's buckets
are byte-identical to the JAX package's for the same pairs, so tests
push the same inputs through both.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_align_torch.io.bucketing import Bucket
from tpu_align_torch.kernels.common import BucketFill


def bucket_to_tensors(bucket: Bucket, device) -> tuple[torch.Tensor, ...]:
    """-> (ref_tokens (B, N) uint8, qry_tokens (B, M) uint8, ref_len (B,)
    int32, qry_len (B,) int32) on `device`.  Raw uint8 tokens cross the
    bus as they are, enqueued on the current stream so the upload never
    waits for earlier fills: a pinned bucket's (io/bucketing.py
    gather_bucket(pinned=True)) in one DMA from its own page-locked
    tensors, any other array through a pinned staging copy."""
    return arrays_to_tensors(*bucket.upload_tokens, bucket.ref_len,
                             bucket.qry_len, device)


def arrays_to_tensors(ref_tokens, qry_tokens, ref_len, qry_len,
                      device) -> tuple[torch.Tensor, ...]:
    """bucket_to_tensors of a bucket's four arrays: numpy, anything
    np.asarray takes, or host torch tensors of the same dtypes."""
    device = torch.device(device)
    out = []
    for arr, dtype in ((ref_tokens, np.uint8), (qry_tokens, np.uint8),
                       (ref_len, np.int32), (qry_len, np.int32)):
        if isinstance(arr, torch.Tensor):
            t = arr
        else:
            t = torch.from_numpy(np.ascontiguousarray(arr, dtype))
        if device.type != "cpu":
            # A page-locked tensor (or a view of one) is the DMA's source
            # as it is.  The copy records its event with torch's caching
            # host allocator, which hands the block out again only once
            # that event has passed, so freeing the tensor while the copy
            # is in flight is safe.  A numpy view of pinned memory has no
            # such record and takes the staging copy.
            if not (t is arr and t.is_pinned()):
                t = t.pin_memory()
            t = t.to(device, non_blocking=True)
        out.append(t)
    return tuple(out)


def fill_to_numpy(scores: torch.Tensor, srow: torch.Tensor,
                  scol: torch.Tensor, dirs: torch.Tensor | None, *,
                  stripe_s: int | None = None,
                  band: int | None = None,
                  rowscan: bool = False) -> BucketFill:
    """The port's fill tensors -> a host BucketFill tagged with its dirs
    layout: stripe_s for the stagger fill, band for the banded fill,
    rowscan=True for the row-sweep fill's word-major words (copies device
    tensors; host tensors, pinned or not, are shared)."""
    if (stripe_s is not None) + (band is not None) + bool(rowscan) != 1:
        raise ValueError("give exactly one of stripe_s, band and rowscan")

    def host(t):
        return t.cpu().numpy()

    return BucketFill(host(scores), host(srow), host(scol),
                      host(dirs) if dirs is not None else None,
                      stagger=stripe_s, band=band, rowscan=bool(rowscan))
