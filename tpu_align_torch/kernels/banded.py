"""The banded Smith-Waterman (BSW) fill: CUDA kernel wrapper and its plain
PyTorch version.

Port of tpu_align/kernels/banded.py: the band is stored in a skewed frame
where slot k of DP row i holds column j = i - band + k, for k in [0, K8),
K8 = max(round8(2*band), 8).  The outputs keep the JAX package's contract
so the native host walker (skew_band mode) and the banded device walk run
unchanged: (scores, srow, scol) as (B,) int32 -- the best cell, first in
row-major order, or all 0 when no cell scores above 0 -- and, with
traceback, direction words (MW, B, K8) int32, MW = ceil(M/16): cell (i,
slot k) of lane b at word ((i-1)//16, b, k), bits 2*((i-1)%16).  Only
valid cells (1 <= k <= 2*band-1, 1 <= j <= rlen, i <= qlen) are defined.

The wrapper dispatches on the device of its tensors: CPU tensors run
`fill_banded_reference`; CUDA tensors launch the hand-written kernel
(csrc/banded_fill.cu) or raise -- nothing falls back.  `launches` counts
kernel launches, so a run can show that it went through the kernel.
"""

from __future__ import annotations

import torch

from tpu_align_torch.core import directions as D
from tpu_align_torch.core.params import Algorithm, AlignmentParams
from tpu_align_torch.convert import fill_to_numpy
from tpu_align_torch.kernels import _build
from tpu_align_torch.kernels.common import (
    NEG,
    BucketFill,
    check_bucket_tensors,
    to_int32_words,
)

ROWS_PER_WORD = 16  # 2-bit codes: 16 query rows per direction word

launches = 0  # CUDA kernel launches since the last reset


def frame_width(band: int) -> int:
    """K8: the skewed frame's slots, 2*band rounded up to 8 (at least 8)."""
    return max(-(-2 * band // 8) * 8, 8)


def dirs_shape(m: int, b: int, band: int) -> tuple[int, ...]:
    """(MW, B, K8) for a bucket of padded query width m."""
    return (-(-m // ROWS_PER_WORD), b, frame_width(band))


def _check_inputs(algorithm, ref_tokens, qry_tokens, ref_len,
                  qry_len) -> None:
    if algorithm is not Algorithm.BSW:
        raise ValueError(f"the banded fill runs bsw only, not "
                         f"{algorithm.value}")
    check_bucket_tensors(ref_tokens, qry_tokens, ref_len, qry_len)


def fill_banded_reference(
    algorithm: Algorithm,
    params: AlignmentParams,
    ref_tokens: torch.Tensor, qry_tokens: torch.Tensor,
    ref_len: torch.Tensor, qry_len: torch.Tensor,
    with_traceback: bool = True,
):
    """Plain PyTorch version of the banded fill, with the kernel's outputs.

    Sweeps query rows, vectorized over pairs and the K8 slots.  A row's
    left dependency chain[k] = max(t[k], chain[k-1] + gap) is one cummax
    in G-space G[k] = t[k] - k*gap over the slots (invalid slots holding
    t = 0), as banded.py's prefix max; the tie predicates are then read off
    the finished row.  Rows past qlen are swept too and are undefined."""
    _check_inputs(algorithm, ref_tokens, qry_tokens, ref_len, qry_len)
    dev = ref_tokens.device
    b, n = ref_tokens.shape
    m = qry_tokens.shape[1]
    band = params.band
    match, mismatch, gap = params.match, params.mismatch, params.gap
    k8 = frame_width(band)
    i32 = torch.int32
    kk = torch.arange(k8, device=dev, dtype=i32)
    kgap = kk * gap
    in_band = (kk >= 1) & (kk <= 2 * band - 1)
    rl = ref_len.clamp(0, n)[:, None]
    ql = qry_len.clamp(0, m)[:, None]
    ref = ref_tokens.to(i32)
    prev = torch.zeros((b, k8), dtype=i32, device=dev)
    best = torch.zeros(b, dtype=i32, device=dev)
    brow = torch.zeros(b, dtype=i32, device=dev)
    bcol = torch.zeros(b, dtype=i32, device=dev)
    neg_col = torch.full((b, 1), NEG, dtype=i32, device=dev)
    dirs = acc = None
    if with_traceback:
        dirs = torch.zeros(dirs_shape(m, b, band), dtype=i32, device=dev)
        acc = torch.zeros((b, k8), dtype=torch.int64, device=dev)
    for i in range(1, m + 1):
        jv = i - band + kk  # each slot's column
        valid = in_band & (jv >= 1) & (jv <= rl) & (i <= ql)  # (B, K8)
        tok = ref[:, (jv - 1).clamp(0, max(n - 1, 0)).long()]
        is_match = tok == qry_tokens[:, i - 1:i].to(i32)
        mm = prev + torch.where(is_match, match, mismatch).to(i32)
        # up is slot k+1 of the previous row; the last slot's is -inf
        dele = torch.cat([prev[:, 1:], neg_col], dim=1) + gap
        t = torch.where(valid, torch.maximum(mm, dele).clamp(min=0), 0)
        chain = torch.cummax(t - kgap, dim=1).values + kgap
        row = torch.where(valid, chain, 0)
        cand = torch.where(valid, row, NEG)
        k = torch.argmax(cand, dim=1)  # the first occurrence: smallest j
        row_best = cand.gather(1, k[:, None])[:, 0]
        upd = row_best > best
        best = torch.where(upd, row_best, best)
        brow = torch.where(upd, i, brow)
        bcol = torch.where(upd, (i - band + k).to(i32), bcol)
        if with_traceback:
            ins = torch.cat([neg_col, row[:, :-1] + gap], dim=1)
            # banded.py:156-160: INSERTION on ins >= mm, then DELETION on
            # dele >= max(mm, ins)
            code = torch.where(is_match, D.MAIN_DIAG_MATCH,
                               D.MAIN_DIAG_MISMATCH)
            code = torch.where(ins >= mm, D.MAIN_QUERY_INSERTION, code)
            code = torch.where(dele >= torch.maximum(mm, ins),
                               D.MAIN_QUERY_DELETION, code)
            r = (i - 1) % ROWS_PER_WORD
            acc = (acc if r else torch.zeros_like(acc)) | (code << (2 * r))
            dirs[(i - 1) // ROWS_PER_WORD] = to_int32_words(acc)
        prev = row
    return best, brow, bcol, dirs


def _launch_kernel(params, ref_tokens, qry_tokens, ref_len, qry_len,
                   with_traceback):
    global launches
    lib = _build.library()
    dev = ref_tokens.device
    b, n = ref_tokens.shape
    m = qry_tokens.shape[1]
    shape = dirs_shape(m, b, params.band)
    k8 = shape[2]
    i32 = torch.int32
    with torch.cuda.device(dev):
        scores, srow, scol = (torch.empty(b, dtype=i32, device=dev)
                              for _ in range(3))
        dirs = (torch.empty(shape, dtype=i32, device=dev)
                if with_traceback else None)
        # past K8 = 29,056 the lanes' slots live in a global scratch
        words = lib.ta_torch_banded_scratch_words(b, k8)
        scratch = torch.empty(words, dtype=i32, device=dev) if words else None
        rc = lib.ta_torch_banded_fill(
            ref_tokens.data_ptr(), qry_tokens.data_ptr(), ref_len.data_ptr(),
            qry_len.data_ptr(), b, n, m, k8, params.band,
            params.match, params.mismatch, params.gap, int(with_traceback),
            scores.data_ptr(), srow.data_ptr(), scol.data_ptr(),
            dirs.data_ptr() if dirs is not None else None,
            scratch.data_ptr() if scratch is not None else None,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"banded fill kernel launch failed: CUDA error {rc}")
    launches += 1
    return scores, srow, scol, dirs


def fill_banded_bucket_async(
    algorithm: Algorithm,
    params: AlignmentParams,
    ref_tokens: torch.Tensor, qry_tokens: torch.Tensor,
    ref_len: torch.Tensor, qry_len: torch.Tensor,
    with_traceback: bool = True,
):
    """Fill one bucket with the band of params.band; returns (scores, srow,
    scol, dirs-or-None) on the tensors' device.  ref_tokens (B, N) uint8,
    qry_tokens (B, M) uint8, ref_len / qry_len (B,) int32, all contiguous
    on one device.  On CUDA the kernel is enqueued on the current stream
    and nothing waits."""
    _check_inputs(algorithm, ref_tokens, qry_tokens, ref_len, qry_len)
    kind = ref_tokens.device.type
    if kind == "cpu":
        return fill_banded_reference(algorithm, params, ref_tokens,
                                     qry_tokens, ref_len, qry_len,
                                     with_traceback=with_traceback)
    if kind == "cuda":
        return _launch_kernel(params, ref_tokens, qry_tokens, ref_len,
                              qry_len, with_traceback)
    raise ValueError(f"no banded fill for device {ref_tokens.device}")


def fill_banded_bucket(
    algorithm: Algorithm,
    params: AlignmentParams,
    ref_tokens: torch.Tensor, qry_tokens: torch.Tensor,
    ref_len: torch.Tensor, qry_len: torch.Tensor,
    with_traceback: bool = True,
) -> BucketFill:
    """Banded fill (synchronous) as a host BucketFill tagged with band."""
    return fill_to_numpy(
        *fill_banded_bucket_async(algorithm, params, ref_tokens, qry_tokens,
                                  ref_len, qry_len,
                                  with_traceback=with_traceback),
        band=params.band)


def defined_codes(dirs: torch.Tensor, ref_len: torch.Tensor,
                  qry_len: torch.Tensor, band: int,
                  first_word: int = 0) -> torch.Tensor:
    """Decode banded dirs (MW, B, K8) into per-cell codes (rows, K8, B),
    with -1 at every cell outside the band or past (qlen, rlen): the one
    comparison both packages' dirs are held to.  dirs may be the word
    rows from first_word on, a slice that keeps a wide frame's codes to a
    size that fits memory."""
    mw, b, k8 = dirs.shape
    dev = dirs.device
    i = torch.arange(first_word * ROWS_PER_WORD + 1,
                     (first_word + mw) * ROWS_PER_WORD + 1, device=dev)
    kk = torch.arange(k8, device=dev)
    # (rows, K8, B)
    w = dirs[(i - 1) // ROWS_PER_WORD - first_word].permute(0, 2, 1)
    codes = (w >> (2 * ((i - 1) % ROWS_PER_WORD)).to(w.dtype)[:, None, None]
             ) & 3
    j = (i[:, None] - band + kk[None, :])[..., None]  # (rows, K8, 1)
    valid = (((kk >= 1) & (kk <= 2 * band - 1))[None, :, None]
             & (j >= 1) & (j <= ref_len.to(dev))
             & (i[:, None, None] <= qry_len.to(dev)))
    return torch.where(valid, codes, -1)
