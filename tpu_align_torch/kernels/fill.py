"""The row-sweep fill (B2) for all four aligners: CUDA kernel wrapper, its
plain PyTorch version, and the row sweep that the plain stagger version
shares.

Port of tpu_align/kernels/fill.py.  The fill sweeps query rows; a row's
left dependency H[i][j] = max(t[j], H[i][j-1] + gap) is one prefix max in
column-shifted space G[j] = H[i][j] - j*gap (fill.py:97-115), so a row is
parallel across its columns.  Three modes:
  * dirs: word-major direction words (MW, B, N) int32, MW = ceil(M/rpw),
    rpw = rows_per_word(algorithm): pair b's word for rows rpw*k+1 ..
    rpw*k+rpw and column j is dirs[k, b, j-1], row i's code at bits
    bits*((i-1) % rpw) -- 16 2-bit codes a word for LNW, LSW and BSW, 8
    4-bit codes (main code + E/F extend bits) for ANW;
  * scores-only: (scores, srow, scol) as (B,) int32 -- for LSW and BSW the
    best cell, first in row-major order, or all 0 when no cell scores
    above 0; for LNW and ANW H[qlen][rlen] at (qlen, rlen);
  * last rows (LNW, ANW): H[qlen][j] at hlast[j-1, b] of an (N, B) int32
    output, and for ANW F[qlen][j] in flast -- the Hirschberg split's
    input.  ANW's open_top (B,) gives the gap-open cost of vertical gaps
    that start on the top boundary (the Myers-Miller credit).
Only cells with i <= qlen and j <= rlen are defined (codes, last-row
entries); lanes with qlen or rlen 0 give H[qlen][rlen] of the DP.

The wrappers dispatch on the device of their tensors: CPU tensors run
`fill_rowscan_reference` (`last_rows_reference`); CUDA tensors launch the
hand-written kernel (csrc/rowscan_fill.cu) or raise -- nothing falls back.
`launches` and `last_rows_launches` count kernel launches, and
`band_warps` holds the persistent warps of the last launch (the kernel's
grid x warps a block, which the entry point sizes from the occupancy the
instantiation's registers allow, and hands back through a host int).
The kernel is a band wavefront, a warp a band of `band_rows` query rows:
the launch's band size, chosen here and passed to the entry point, which
refuses one it was not built for; `launch_band_rows`,
`launch_scores_step` and `launch_offset_form` keep the last launch's, for
the counters (runtime/profiler.py count_fill).  The kernel itself counts
the real cells of the band items that take its scores step, into a 64-bit
word a device that this module owns (`scores_cells`,
`reset_scores_cells`): one atomic add a band item, read only when asked.
Unlike the JAX wrapper, B is not padded to 128 lanes, so callers compare
real rows.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpu_align_torch.core import directions as D
from tpu_align_torch.core.params import Algorithm, AlignmentParams
from tpu_align_torch.convert import fill_to_numpy
from tpu_align_torch.kernels import _build
from tpu_align_torch.kernels.common import (
    NEG,
    BucketFill,
    bits_per_cell,
    check_bucket_tensors,
    steps_per_word,
    to_int32_words,
)

_ALGO_CODE = {Algorithm.LNW: 0, Algorithm.LSW: 1, Algorithm.ANW: 2,
              Algorithm.BSW: 3}
_MODE_SCORES, _MODE_DIRS, _MODE_LAST_ROWS = 0, 1, 2

launches = 0  # fill kernel launches (dirs or scores-only)
last_rows_launches = 0  # last-row kernel launches
band_warps = 0  # persistent warps of the last launch, either mode
launch_band_rows = 128  # query rows a band of the last launch
# whether the last launch's full bands could take the scores step, and
# whether that step ran in the gap-offset form (LNW's)
launch_scores_step = False
launch_offset_form = False
# a device's int64 count of the cells of band items that took the scores
# step (csrc/rowscan_fill.cu fill_band_scores), made at its first launch
_scores_cells: dict[torch.device, torch.Tensor] = {}

# Query rows a band of the wavefront (32 lanes' rows): BAND_ROWS (4 a
# lane) in every mode, or WIDE_BAND_ROWS (8 a lane) for a scores-only
# instantiation built with them (LNW and ANW: the entry point says which)
# on a launch whose wide bands are at least WIDE_BANDS_A_WARP a resident
# warp.  The dirs and last-row modes keep 4: a 16-row dirs word spans 4
# lanes.  The kernel refuses any other.
BAND_ROWS = 128
WIDE_BAND_ROWS = 256
# on the H100, 8 rows a lane led 4 on full launches and lost on a
# near-empty card (PERF.md section 6)
WIDE_BANDS_A_WARP = 5


def band_rows(scores: bool, b: int, m: int, resident_warps) -> int:
    """Query rows a band of the wavefront for a launch over b problems of
    m padded query rows: the one band size the launcher, the scratch and
    the counters read.  resident_warps(rows) gives the warps the card
    holds at once of the instantiation with bands of `rows`, or a count
    below 1 where none is built."""
    if scores:
        warps = resident_warps(WIDE_BAND_ROWS)
        if 0 < warps and (b * bands_of(m, WIDE_BAND_ROWS)
                          >= WIDE_BANDS_A_WARP * warps):
            return WIDE_BAND_ROWS
    return BAND_ROWS


@functools.cache
def _resident_warps(device: torch.device, algorithm: Algorithm, mode: int,
                    rows: int) -> int:
    """The warps `device` holds at once of one instantiation (its
    occupancy x SMs), -1 where none is built for `rows`
    (csrc/rowscan_fill.cu ta_torch_rowscan_resident_warps)."""
    with torch.cuda.device(device):
        return _build.library().ta_torch_rowscan_resident_warps(
            _ALGO_CODE[algorithm], mode, rows)


def _scores_counter(device: torch.device) -> torch.Tensor:
    counter = _scores_cells.get(device)
    if counter is None:
        counter = _scores_cells[device] = torch.zeros(
            1, dtype=torch.int64, device=device)
    return counter


def reset_scores_cells() -> None:
    """Zero every device's scores-step cell count, in stream order."""
    for counter in _scores_cells.values():
        counter.zero_()


def scores_cells() -> int:
    """The real cells of the band items that took the scores step since
    the last reset, summed over the devices: each device is synchronised
    and its count read once (0 where no kernel was launched)."""
    total = 0
    for device, counter in _scores_cells.items():
        torch.cuda.synchronize(device)
        total += int(counter.item())
    return total


def bands_of(m: int, rows: int) -> int:
    """Bands a problem of a bucket of m padded query rows (at least
    one: a problem with qlen 0 is row 0)."""
    return max(1, -(-m // rows))


def profile_fits(algorithm: Algorithm, params: AlignmentParams, m: int,
                 n: int) -> bool:
    """Whether the scores step's profile holds the weights in signed
    bytes, as the kernel tests it (csrc/rowscan_fill.cu profile_fits) for
    a bucket of m padded query rows and n columns; else every band takes
    the general step.  LNW's step runs in the gap-offset form, H - gap x
    (i + j): its bytes are match and mismatch less 2 x gap, and it runs
    only where (m + n) x (their larger magnitude + |gap|) fits int32."""
    lnw = algorithm is Algorithm.LNW
    shift = 2 * params.gap if lnw else 0
    weights = [w - shift for w in (params.match, params.mismatch)]
    if not all(-128 <= w <= 127 for w in weights):
        return False
    size = max(abs(w) for w in weights) + abs(params.gap)
    return not lnw or (m + n) * size <= 2**31 - 1


def rows_per_word(algo: Algorithm) -> int:
    """Query rows per direction word: 16 linear, 8 affine."""
    return steps_per_word(algo)


def dirs_shape(algorithm: Algorithm, m: int, n: int,
               b: int) -> tuple[int, int, int]:
    """(MW, B, N) of a bucket with padded query width m and reference
    width n."""
    return (-(-m // rows_per_word(algorithm)), b, n)


def _affine_row(params, prev, prevf, w, i, tb):
    """One ANW row from H[i-1] and F[i-1] (B, n+1): returns (H[i] (B, n+1),
    F[i] (B, n+1), take_del, take_ins, f_ext_bit, e_ext_bit (B, n)).

    tb (B, 1) is the gap-open cost of a vertical gap from the top boundary:
    the border H[i][0] = tb + i*ge, and row 1's F opens at tb (fill.py:
    199-229); tb = gap_open everywhere but in Hirschberg's split fills.
    Within the row, E[j] = max(H[i][j-1] + goe, E[i][j-1] + ge) is one
    cummax in G-space G[k] = t[k] - k*ge over t = max(mm, F) and the border
    H[i][0]: opening from an H that came from E is dominated by extending
    that E when gap_open <= 0 (tpu_align/oracle/vectorized.py:148-210)."""
    go, ge = params.gap_open, params.gap_extend
    goe = go + ge
    b, n1 = prev.shape
    dev = prev.device
    i32 = torch.int32
    jge = torch.arange(n1, device=dev, dtype=i32) * ge  # k*ge
    mm = prev[:, :-1] + w
    f_open = prev[:, 1:] + (tb + ge if i == 1 else goe)
    f_ext = prevf[:, 1:] + ge
    f = torch.maximum(f_open, f_ext)
    t = torch.maximum(mm, f)
    head = tb + i * ge  # H[i][0]
    g = torch.cummax(torch.cat([head, t], dim=1) - jge, dim=1).values
    e = g[:, :-1] + jge[:-1] + goe  # E[i][1..n]
    row = torch.cat([head, torch.maximum(t, e)], dim=1)
    e_prev = torch.cat([torch.full((b, 1), NEG, dtype=i32, device=dev),
                        e[:, :-1]], dim=1)  # E[i][0] = -inf
    fcol = torch.cat([torch.full((b, 1), NEG, dtype=i32, device=dev), f],
                     dim=1)
    return (row, fcol, f >= mm, e >= t, f_open < f_ext,
            row[:, :-1] + goe < e_prev + ge)


def plain_sweep(algorithm: Algorithm, params: AlignmentParams,
                ref_tokens: torch.Tensor, qry_tokens: torch.Tensor,
                ref_len: torch.Tensor, qry_len: torch.Tensor,
                on_codes=None, open_top: torch.Tensor | None = None):
    """The DP row by row, vectorized over pairs and columns: the plain
    version of both fills.  Calls on_codes(i, codes) with row i's (B, N)
    direction codes (E/F bits included for ANW) when given.  Returns
    (scores, srow, scol, hlast, flast): the scores-only outputs, and for
    the global aligners H[qlen] and (ANW) F[qlen] as (B, N+1) rows, column
    0 included.

    A linear row is one cummax in G-space over t = max(mm, dele) (and 0
    for LSW and BSW); ANW's E is one cummax too (_affine_row).  The tie
    predicates are then read off the finished row.  BSW forces
    out-of-band cells to H = 0 before the scan and again after it, its
    codes read from the scanned row (fill.py:335-355).  LSW's and BSW's
    best cell is each row's first argmax, kept when it beats the rows above
    strictly.  Padded cells are computed too and are undefined."""
    local = algorithm.is_local
    affine = algorithm.is_affine
    dev = ref_tokens.device
    b, n = ref_tokens.shape
    m = qry_tokens.shape[1]
    match, mismatch, gap = params.match, params.mismatch, params.gap
    i32 = torch.int32
    ref = ref_tokens.to(i32)
    jgap = torch.arange(n + 1, device=dev, dtype=i32) * gap  # j*gap
    cols = torch.arange(1, n + 1, device=dev)
    rl = ref_len.long().clamp(0, n)[:, None]
    ql = qry_len.long().clamp(0, m)
    prevf = tb = None
    if affine:
        tb = (torch.full((b, 1), params.gap_open, dtype=i32, device=dev)
              if open_top is None else open_top.to(i32).reshape(b, 1))
        # H[0][0] = 0, H[0][j] = go + j*ge; F[0][j] = -inf
        prev = (params.gap_open + torch.arange(n + 1, device=dev, dtype=i32)
                * params.gap_extend).expand(b, n + 1).clone()
        prev[:, 0] = 0
        prevf = torch.full((b, n + 1), NEG, dtype=i32, device=dev)
    elif local:  # H[0][j] = 0
        prev = torch.zeros((b, n + 1), dtype=i32, device=dev)
    else:  # H[0][j] = j*gap
        prev = jgap.expand(b, n + 1).clone()
    hlast, flast = prev, prevf
    scores = srow = scol = None
    if local:
        in_ref = cols[None, :] <= rl
        scores, srow, scol = (torch.zeros(b, dtype=i32, device=dev)
                              for _ in range(3))
    for i in range(1, m + 1):
        is_match = ref == qry_tokens[:, i - 1:i].to(i32)
        w = torch.where(is_match, match, mismatch).to(i32)
        in_band = None
        if affine:
            row, prevf, take_del, take_ins, f_bit, e_bit = _affine_row(
                params, prev, prevf, w, i, tb)
        else:
            mm = prev[:, :-1] + w
            dele = prev[:, 1:] + gap
            t = torch.maximum(mm, dele)
            if local:
                t = t.clamp(min=0)
            if algorithm.is_banded:
                # python/LinearBandedSmithWaterman.py:71: out-of-band
                # cells are H = 0, before the scan so nothing leaks
                in_band = (cols >= i - params.band + 1) & (
                    cols <= i + params.band - 1)
                t = torch.where(in_band, t, 0)
            head = torch.full((b, 1), 0 if local else i * gap, dtype=i32,
                              device=dev)
            g = torch.cummax(torch.cat([head, t - jgap[1:]], dim=1),
                             dim=1).values
            row = g + jgap  # H[i][0..n]
        if on_codes is not None:
            diag = torch.where(is_match, D.MAIN_DIAG_MATCH,
                               D.MAIN_DIAG_MISMATCH)
            if affine:
                # stagger.py:347-359: DELETION on F >= mm, then INSERTION
                # on E >= max(F, mm); the E/F bits mark an extend
                code = torch.where(
                    take_ins, D.MAIN_QUERY_INSERTION,
                    torch.where(take_del, D.MAIN_QUERY_DELETION, diag))
                code = (code | torch.where(f_bit, D.BIT_F_EXTEND, 0)
                        | torch.where(e_bit, D.BIT_E_EXTEND, 0))
            elif local:
                ins = row[:, :-1] + gap
                # cuda/LinearSmithWaterman.cu:126-137: INSERTION on
                # ins >= mm, then DELETION on dele >= max(ins, mm) -- the
                # last test wins a tie
                take_ins = ins >= mm
                take_del = dele >= torch.maximum(ins, mm)
                code = torch.where(
                    take_del, D.MAIN_QUERY_DELETION,
                    torch.where(take_ins, D.MAIN_QUERY_INSERTION, diag))
            else:
                ins = row[:, :-1] + gap
                # c++/LinearNeedlemanWunsch.cpp:122-126: DELETION on
                # dele >= mm, then INSERTION on ins >= max(dele, mm)
                take_del = dele >= mm
                take_ins = ins >= t
                code = torch.where(
                    take_ins, D.MAIN_QUERY_INSERTION,
                    torch.where(take_del, D.MAIN_QUERY_DELETION, diag))
            on_codes(i, code)
        if in_band is not None:
            row[:, 1:] = torch.where(in_band, row[:, 1:], 0)
        if local:
            cand = torch.where(in_ref, row[:, 1:], torch.iinfo(i32).min)
            col = torch.argmax(cand, dim=1)  # the first occurrence
            best = cand.gather(1, col[:, None])[:, 0]
            upd = (best > scores) & (i <= ql)
            scores = torch.where(upd, best, scores)
            srow = torch.where(upd, i, srow)
            scol = torch.where(upd, (col + 1).to(i32), scol)
        else:
            now = (ql == i)[:, None]
            hlast = torch.where(now, row, hlast)
            if affine:
                flast = torch.where(now, prevf, flast)
        prev = row
    if local:
        return scores, srow, scol, None, None
    return (hlast.gather(1, rl)[:, 0], qry_len.clone(), ref_len.clone(),
            hlast, flast)


def _check_inputs(algorithm, params, ref_tokens, qry_tokens, ref_len,
                  qry_len) -> None:
    if algorithm not in _ALGO_CODE:
        raise ValueError(f"unknown algorithm {algorithm!r}")
    if algorithm.is_affine and params.gap_open > 0:
        raise ValueError("ANW kernel requires gap_open <= 0")
    check_bucket_tensors(ref_tokens, qry_tokens, ref_len, qry_len)


def check_last_rows(algorithm, open_top, ref_tokens) -> None:
    """fill.py:737-742: last rows are global-only, open_top affine-only."""
    if algorithm.is_local:
        raise ValueError("last-row fill is global-only (LNW/ANW)")
    if open_top is None:
        return
    if not algorithm.is_affine:
        raise ValueError("open_top is affine-only")
    b = ref_tokens.shape[0]
    if (open_top.dtype != torch.int32 or open_top.shape != (b,)
            or not open_top.is_contiguous()
            or open_top.device != ref_tokens.device):
        raise ValueError(f"open_top must be a contiguous ({b},) int32 "
                         f"tensor on {ref_tokens.device}")


def fill_rowscan_reference(
    algorithm: Algorithm,
    params: AlignmentParams,
    ref_tokens: torch.Tensor, qry_tokens: torch.Tensor,
    ref_len: torch.Tensor, qry_len: torch.Tensor,
    with_traceback: bool = True,
):
    """Plain PyTorch version of the row-sweep fill, with the kernel's
    outputs: (scores, srow, scol, dirs (MW, B, N) int32 or None)."""
    _check_inputs(algorithm, params, ref_tokens, qry_tokens, ref_len,
                  qry_len)
    b, n = ref_tokens.shape
    m = qry_tokens.shape[1]
    dev = ref_tokens.device
    dirs = on_codes = None
    if with_traceback:
        rpw = rows_per_word(algorithm)
        bits = bits_per_cell(algorithm)
        dirs = torch.zeros(dirs_shape(algorithm, m, n, b), dtype=torch.int32,
                           device=dev)
        acc = torch.zeros((b, n), dtype=torch.int64, device=dev)

        def on_codes(i, code):
            r = (i - 1) % rpw
            acc.bitwise_or_(code.to(torch.int64) << (bits * r))
            if r == rpw - 1 or i == m:
                dirs[(i - 1) // rpw] = to_int32_words(acc)
                acc.zero_()

    scores, srow, scol, _, _ = plain_sweep(
        algorithm, params, ref_tokens, qry_tokens, ref_len, qry_len,
        on_codes=on_codes)
    return scores, srow, scol, dirs


def last_rows_reference(
    algorithm: Algorithm,
    params: AlignmentParams,
    ref_tokens: torch.Tensor, qry_tokens: torch.Tensor,
    ref_len: torch.Tensor, qry_len: torch.Tensor,
    open_top: torch.Tensor | None = None,
):
    """Plain version of both last-row fills (rowscan and stagger): returns
    (scores (B,), hlast (N, B), flast (N, B) or None)."""
    _check_inputs(algorithm, params, ref_tokens, qry_tokens, ref_len,
                  qry_len)
    check_last_rows(algorithm, open_top, ref_tokens)
    scores, _, _, hlast, flast = plain_sweep(
        algorithm, params, ref_tokens, qry_tokens, ref_len, qry_len,
        open_top=open_top)
    return (scores, hlast[:, 1:].T.contiguous(),
            None if flast is None else flast[:, 1:].T.contiguous())


def _launch_kernel(mode, algorithm, params, ref_tokens, qry_tokens, ref_len,
                   qry_len, open_top=None):
    global band_warps, launch_band_rows, launch_scores_step, \
        launch_offset_form
    lib = _build.library()
    dev = ref_tokens.device
    b, n = ref_tokens.shape
    m = qry_tokens.shape[1]
    i32 = torch.int32
    affine = algorithm.is_affine
    last_rows = mode == _MODE_LAST_ROWS
    rows = band_rows(mode == _MODE_SCORES, b, m,
                     lambda r: _resident_warps(dev, algorithm, mode, r))
    with torch.cuda.device(dev):
        scores = torch.empty(b, dtype=i32, device=dev)
        srow = scol = dirs = hlast = flast = None
        if last_rows:
            hlast = torch.empty((n, b), dtype=i32, device=dev)
            flast = torch.empty((n, b), dtype=i32, device=dev) if affine \
                else None
        else:
            srow, scol = (torch.empty(b, dtype=i32, device=dev)
                          for _ in range(2))
        if mode == _MODE_DIRS:
            dirs = torch.empty(dirs_shape(algorithm, m, n, b), dtype=i32,
                               device=dev)
        # global scratch as csrc/rowscan_fill.cu sizes it: the band
        # wavefront's ticket and ready words (reset by the launch), its
        # boundary rows and, for LSW and BSW, each band's best cell
        words = lib.ta_torch_rowscan_scratch_words(
            _ALGO_CODE[algorithm], mode, b, n, m, rows)
        scratch = torch.empty(words, dtype=i32, device=dev)
        counter = _scores_counter(dev)
        warps = ctypes.c_int(0)
        rc = lib.ta_torch_rowscan_fill(
            _ALGO_CODE[algorithm], mode, rows,
            ref_tokens.data_ptr(), qry_tokens.data_ptr(),
            ref_len.data_ptr(), qry_len.data_ptr(),
            open_top.data_ptr() if open_top is not None else None,
            b, n, m, params.match, params.mismatch, params.gap,
            params.gap_open, params.gap_extend, params.band,
            scratch.data_ptr(),
            scores.data_ptr(),
            srow.data_ptr() if srow is not None else None,
            scol.data_ptr() if scol is not None else None,
            dirs.data_ptr() if dirs is not None else None,
            hlast.data_ptr() if hlast is not None else None,
            flast.data_ptr() if flast is not None else None,
            counter.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
            ctypes.byref(warps),
        )
    if rc != 0:
        raise RuntimeError(
            f"rowscan fill kernel launch failed: CUDA error {rc}")
    band_warps = warps.value
    launch_band_rows = rows
    launch_scores_step = mode == _MODE_SCORES and profile_fits(
        algorithm, params, m, n)
    launch_offset_form = launch_scores_step and algorithm is Algorithm.LNW
    return scores, srow, scol, dirs, hlast, flast


def fill_bucket_async(
    algorithm: Algorithm,
    params: AlignmentParams,
    ref_tokens: torch.Tensor, qry_tokens: torch.Tensor,
    ref_len: torch.Tensor, qry_len: torch.Tensor,
    with_traceback: bool = True,
):
    """Fill one bucket; returns (scores, srow, scol, dirs-or-None) on the
    tensors' device.  ref_tokens (B, N) uint8, qry_tokens (B, M) uint8,
    ref_len / qry_len (B,) int32, all contiguous on one device.  On CUDA
    the kernel is enqueued on the current stream and nothing waits."""
    global launches
    _check_inputs(algorithm, params, ref_tokens, qry_tokens, ref_len,
                  qry_len)
    kind = ref_tokens.device.type
    if kind == "cpu":
        return fill_rowscan_reference(
            algorithm, params, ref_tokens, qry_tokens, ref_len, qry_len,
            with_traceback=with_traceback)
    if kind == "cuda":
        mode = _MODE_DIRS if with_traceback else _MODE_SCORES
        out = _launch_kernel(mode, algorithm, params, ref_tokens, qry_tokens,
                             ref_len, qry_len)
        launches += 1
        return out[:4]
    raise ValueError(f"no rowscan fill for device {ref_tokens.device}")


def fill_bucket(
    algorithm: Algorithm,
    params: AlignmentParams,
    ref_tokens: torch.Tensor, qry_tokens: torch.Tensor,
    ref_len: torch.Tensor, qry_len: torch.Tensor,
    with_traceback: bool = True,
) -> BucketFill:
    """Rowscan fill (synchronous) as a host BucketFill tagged with the
    word-major layout."""
    return fill_to_numpy(
        *fill_bucket_async(algorithm, params, ref_tokens, qry_tokens,
                           ref_len, qry_len, with_traceback=with_traceback),
        rowscan=True)


def fill_last_rows_async(
    algorithm: Algorithm,
    params: AlignmentParams,
    ref_tokens: torch.Tensor, qry_tokens: torch.Tensor,
    ref_len: torch.Tensor, qry_len: torch.Tensor,
    open_top: torch.Tensor | None = None,
):
    """Scores-only fill that also emits each pair's last DP row (LNW,
    ANW): returns (scores (B,), hlast (N, B), flast (N, B) or None) on the
    tensors' device, hlast[j-1, b] = H[qlen][j] (flast: F[qlen][j]).  The
    j = 0 border is analytic (qlen*gap; open_top + qlen*gap_extend)."""
    global last_rows_launches
    _check_inputs(algorithm, params, ref_tokens, qry_tokens, ref_len,
                  qry_len)
    check_last_rows(algorithm, open_top, ref_tokens)
    kind = ref_tokens.device.type
    if kind == "cpu":
        return last_rows_reference(algorithm, params, ref_tokens,
                                   qry_tokens, ref_len, qry_len,
                                   open_top=open_top)
    if kind == "cuda":
        scores, _, _, _, hlast, flast = _launch_kernel(
            _MODE_LAST_ROWS, algorithm, params, ref_tokens, qry_tokens,
            ref_len, qry_len, open_top=open_top)
        last_rows_launches += 1
        return scores, hlast, flast
    raise ValueError(f"no rowscan fill for device {ref_tokens.device}")


def defined_codes(algorithm: Algorithm, dirs: torch.Tensor,
                  ref_len: torch.Tensor,
                  qry_len: torch.Tensor) -> torch.Tensor:
    """Decode word-major dirs (MW, B, N) into per-cell codes (rows, N, B)
    with -1 at every cell outside i <= qlen, j <= rlen."""
    mw, _, n = dirs.shape
    dev = dirs.device
    bits = bits_per_cell(algorithm)
    rpw = rows_per_word(algorithm)
    i = torch.arange(1, mw * rpw + 1, device=dev)
    w = dirs[(i - 1) // rpw].permute(0, 2, 1)  # (rows, N, B)
    shift = (bits * ((i - 1) % rpw)).to(w.dtype)[:, None, None]
    codes = (w >> shift) & ((1 << bits) - 1)
    j = torch.arange(1, n + 1, device=dev)
    defined = ((i[:, None, None] <= qry_len.to(dev)) &
               (j[None, :, None] <= ref_len.to(dev)))
    return torch.where(defined, codes, -1)
