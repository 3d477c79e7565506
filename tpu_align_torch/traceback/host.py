"""Host traceback over the fills' packed direction words.

Port of tpu_align/traceback/host.py for the three dirs layouts: the
stagger fill's (stripes, W, S, B) words, the banded fill's skewed (MW, B,
K8) words and the row-sweep fill's word-major (MW, B, N) words.  Two
walks, each pair on its own:

* the threaded native walker (native/tpualign.cpp, the c++/backtrack.cpp
  counterpart), which reads every layout directly -- the default, and the
  engine's path;
* the NumPy walk (``traceback_bucket(use_native=False)``): each pair's
  words decoded into oracle-style direction matrices (unpack_pair_dirs,
  unpack_stagger_pair_dirs, unpack_banded_pair_dirs) and walked by the
  oracle's own walkers (oracle/traceback.py), with the local aligners'
  backward re-scoring stop.  It is the native walker's Python
  counterpart, which the tests hold it to.

Nothing falls back: when the native library cannot load, the native walk
raises, and only an explicit ``use_native=False`` takes the NumPy walk.
"""

from __future__ import annotations

import numpy as np

from tpu_align_torch.core import directions as D
from tpu_align_torch.core.params import Algorithm, AlignmentParams
from tpu_align_torch.core.result import AlignmentResult, results_from_arrays
from tpu_align_torch.io.bucketing import Bucket
from tpu_align_torch.kernels.common import BucketFill, bits_per_cell
from tpu_align_torch.oracle.traceback import _walk_anw, _walk_nw

# packed code (bits[1:0]) -> oracle direction enum
_MAIN_LUT = np.zeros(4, np.uint8)
_MAIN_LUT[D.MAIN_DIAG_MATCH] = D.MATCH
_MAIN_LUT[D.MAIN_DIAG_MISMATCH] = D.MISMATCH
_MAIN_LUT[D.MAIN_QUERY_DELETION] = D.QUERY_DELETION
_MAIN_LUT[D.MAIN_QUERY_INSERTION] = D.QUERY_INSERTION


def _decode_words(words: np.ndarray, bits: int) -> np.ndarray:
    """(MW, N) packed words -> (MW * 32//bits, N) per-cell codes."""
    per = 32 // bits
    shifts = (bits * np.arange(per, dtype=np.uint32))[None, :, None]
    mask = np.uint32((1 << bits) - 1)
    mw, n = words.shape
    return (
        (words.astype(np.uint32)[:, None, :] >> shifts) & mask
    ).reshape(mw * per, n)


def _matrices(codes: np.ndarray, qlen: int, rlen: int,
              algorithm: Algorithm):
    """(qlen, rlen) interior codes -> (main, e, f) direction matrices of
    shape (qlen+1, rlen+1) with the oracle's border conventions (row and
    column 0 forced INSERTION / DELETION for the global aligners,
    c++/LinearNeedlemanWunsch.cpp:31-41; NONE for the local ones); e and f
    are None for the linear aligners."""
    e_dirs = f_dirs = None
    if algorithm.is_affine:
        e_dirs = np.zeros((qlen + 1, rlen + 1), np.uint8)
        f_dirs = np.zeros((qlen + 1, rlen + 1), np.uint8)
        e_dirs[1:, 1:] = np.where(codes & D.BIT_E_EXTEND, D.GAP_EXTEND,
                                  D.GAP_OPEN)
        f_dirs[1:, 1:] = np.where(codes & D.BIT_F_EXTEND, D.GAP_EXTEND,
                                  D.GAP_OPEN)
    main_dirs = np.zeros((qlen + 1, rlen + 1), np.uint8)
    main_dirs[1:, 1:] = _MAIN_LUT[codes & 3]
    if not algorithm.is_local:
        main_dirs[1:, 0] = D.QUERY_DELETION
        main_dirs[0, 1:] = D.QUERY_INSERTION
    return main_dirs, e_dirs, f_dirs


def unpack_pair_dirs(
    words: np.ndarray, qlen: int, rlen: int, algorithm: Algorithm
):
    """Decode one pair's word-major words (the row-sweep fill's layout)
    into oracle-style direction matrices.

    words: (MW, N) int32 with 32//bits query rows a word, bits =
    bits_per_cell(algorithm): 16 rows a word for the 2-bit linear
    aligners, 8 for the 4-bit affine one.  DP interior row i sits at bits
    [bits*((i-1)%rows) ..] of word row (i-1)//rows.

    Returns (main_dirs, e_dirs, f_dirs) of shape (qlen+1, rlen+1) uint8
    (e_dirs and f_dirs None for the linear aligners)."""
    codes = _decode_words(words, bits_per_cell(algorithm))[:qlen, :rlen]
    return _matrices(codes, qlen, rlen, algorithm)


def unpack_stagger_pair_dirs(
    words: np.ndarray, qlen: int, rlen: int, algorithm: Algorithm, s_rows: int
):
    """Decode one pair's stagger-layout words (stripes, W, S) into
    oracle-style direction matrices.

    Stagger packing (kernels/stagger.py): cell (i, j), 1-based, lives in
    stripe (i-1)//S, sublane r = (i-1)%S, step k = (j-1) + r, word
    k // (32//bits) at bits [bits*(k%spw) ..]."""
    bits = bits_per_cell(algorithm)
    spw = 32 // bits
    si = np.arange(qlen) // s_rows  # (qlen,) stripe of each row
    ri = np.arange(qlen) % s_rows   # (qlen,) sublane of each row
    k = ri[:, None] + np.arange(rlen)[None, :]  # (qlen, rlen) step index
    rw = words.astype(np.uint32)[si[:, None], k // spw, ri[:, None]]
    codes = (rw >> (bits * (k % spw)).astype(np.uint32)) & np.uint32(
        (1 << bits) - 1)
    return _matrices(codes, qlen, rlen, algorithm)


def unpack_banded_pair_dirs(
    words: np.ndarray, qlen: int, rlen: int, band: int
):
    """Decode one pair's skewed banded words (MW, K8) into a full
    (qlen+1, rlen+1) main-direction matrix (NONE outside the band).  Slot k
    of DP row i is column j = i - band + k (kernels/banded.py layout);
    e_dirs and f_dirs are None."""
    k8 = words.shape[1]
    main = _MAIN_LUT[_decode_words(words, 2)[:qlen] & 3]
    main_dirs = np.zeros((qlen + 1, rlen + 1), np.uint8)
    i_idx = np.arange(1, qlen + 1)[:, None]
    k_idx = np.arange(k8)[None, :]
    jmat = i_idx - band + k_idx
    valid = (
        (k_idx >= 1) & (k_idx <= 2 * band - 1) & (jmat >= 1) & (jmat <= rlen)
    )
    main_dirs[np.broadcast_to(i_idx, jmat.shape)[valid], jmat[valid]] = (
        main[valid]
    )
    return main_dirs, None, None


def _walk_local_rescore(main_dirs, ref: str, qry: str, r: int, c: int,
                        score: int, params: AlignmentParams):
    """Local walk with the backward re-scoring stop: along the optimal
    path H[pred] = H[cell] - move cost, so the remaining score reaches 0
    exactly at the clamped-to-zero path start (no stored stop flag)."""
    out_r, out_m, out_q = [], [], []
    remaining = score
    while remaining > 0 and r > 0 and c > 0:
        d = main_dirs[r, c]
        if d == D.MATCH or d == D.MISMATCH:
            out_r.append(ref[c - 1])
            out_m.append(D.REL_MATCH if d == D.MATCH else D.REL_MISMATCH)
            out_q.append(qry[r - 1])
            remaining -= params.match if d == D.MATCH else params.mismatch
            r -= 1
            c -= 1
        elif d == D.QUERY_DELETION:
            out_r.append(D.GAP_CHAR)
            out_m.append(D.REL_GAP)
            out_q.append(qry[r - 1])
            remaining -= params.gap
            r -= 1
        else:  # QUERY_INSERTION
            out_r.append(ref[c - 1])
            out_m.append(D.REL_GAP)
            out_q.append(D.GAP_CHAR)
            remaining -= params.gap
            c -= 1
    return (
        "".join(reversed(out_r)),
        "".join(reversed(out_m)),
        "".join(reversed(out_q)),
    )


def _check_layout(fill: BucketFill) -> None:
    if fill.dirs is None:
        raise ValueError("bucket was filled with with_traceback=False")
    if not (fill.stagger or fill.band or fill.rowscan):
        raise ValueError("the fill carries no dirs layout tag (stagger, "
                         "band or rowscan)")


def traceback_bucket_arrays(
    algorithm: Algorithm, bucket: Bucket, fill: BucketFill,
    params: AlignmentParams,
):
    """Walk every real pair of a filled bucket natively; returns raw
    (out_buf (B, 3, stride) uint8, out_lens (B,) int32) arrays for the
    native block formatter.  Raises when the native library cannot
    load."""
    from tpu_align_torch import native

    _check_layout(fill)
    native.require("the native host walk; traceback_bucket(use_native="
                   "False) takes the NumPy walk")
    nb = bucket.num_real
    return native.native_traceback_bucket(
        algorithm.value,
        fill.dirs, bucket.ref_tokens[:nb], bucket.qry_tokens[:nb],
        bucket.ref_len[:nb], bucket.qry_len[:nb],
        fill.start_row[:nb], fill.start_col[:nb], fill.scores[:nb],
        skew_band=fill.band or 0,
        stagger=fill.stagger or 0,
        bits=bits_per_cell(algorithm),
        match=params.match, mismatch=params.mismatch, gap=params.gap,
    )


def _pair_dirs(algorithm: Algorithm, fill: BucketFill, row: int,
               qlen: int, rlen: int):
    """Pair `row`'s direction matrices, decoded from the fill's layout."""
    if fill.band:
        return unpack_banded_pair_dirs(fill.dirs[:, row, :], qlen, rlen,
                                       fill.band)
    if fill.stagger:
        return unpack_stagger_pair_dirs(fill.dirs[:, :, :, row], qlen,
                                        rlen, algorithm, fill.stagger)
    return unpack_pair_dirs(fill.dirs[:, row, :], qlen, rlen, algorithm)


def traceback_bucket(
    algorithm: Algorithm,
    bucket: Bucket,
    fill: BucketFill,
    params: AlignmentParams | None = None,
    use_native: bool = True,
) -> list[AlignmentResult]:
    """Walk every real pair of a filled bucket into an AlignmentResult
    (pair_num = original dataset index).

    use_native=True (the default) runs the threaded native walker and
    raises RuntimeError when its library cannot load: unlike the JAX
    package, the port never drops to the NumPy walk on its own.
    use_native=False runs the NumPy walk, the same alignments in
    Python: each pair's words decoded by its layout's unpacker, then the
    oracle's Gotoh walk (ANW), the backward re-scoring walk (LSW, BSW;
    a lane with score <= 0 gives an empty block) or the NW walk (LNW)."""
    params = params or AlignmentParams()
    if use_native:
        out_buf, out_lens = traceback_bucket_arrays(algorithm, bucket, fill,
                                                    params)
        return results_from_arrays(bucket.pair_ids, fill.scores, out_buf,
                                   out_lens, bucket.num_real)
    _check_layout(fill)
    results = []
    for row in range(bucket.num_real):
        qlen = int(bucket.qry_len[row])
        rlen = int(bucket.ref_len[row])
        # latin-1, as results_from_arrays decodes the native walk's bytes
        ref = bucket.ref_tokens[row, :rlen].tobytes().decode("latin-1")
        qry = bucket.qry_tokens[row, :qlen].tobytes().decode("latin-1")
        score = int(fill.scores[row])
        main, e_dirs, f_dirs = _pair_dirs(algorithm, fill, row, qlen, rlen)
        if algorithm.is_affine:
            r, m, q = _walk_anw(main, e_dirs, f_dirs, ref, qry, qlen, rlen)
        elif algorithm.is_local:
            if score <= 0:
                r = m = q = ""  # empty block, cuda/LinearSmithWaterman.cu
            else:
                r, m, q = _walk_local_rescore(
                    main, ref, qry, int(fill.start_row[row]),
                    int(fill.start_col[row]), score, params)
        else:
            r, m, q = _walk_nw(main, ref, qry, qlen, rlen, stop_local=False)
        results.append(AlignmentResult(int(bucket.pair_ids[row]), score,
                                       r, m, q))
    return results
