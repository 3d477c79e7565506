"""Hirschberg divide-and-conquer traceback: alignment in O(M+N) memory.

Port of tpu_align/traceback/hirschberg.py, function for function.  No
direction tensor exists in any memory: each split level runs one batched
scores-only fill that emits only the problems' LAST ROWS
(kernels/fill.py fill_last_rows_async, or the stagger fill's last-row
variant), the optimal path's crossing column at each query midrow is the
argmax of forward + reversed-suffix last-row sums (`split_reduce`, a CUDA
kernel on the card, so 4 ints per subproblem cross to the host), and the
halves recurse.  Subproblems small enough for the packed-direction fills
become leaves that run through the port's ordinary engine; every split
cell lies on an optimal path, so the leaves' lines concatenate into a full
optimal alignment.  LNW exactly; ANW via Myers-Miller (1988) with per-pair
boundary gap-open credits (open_top); LSW by endpoint discovery (two
scores-only row-sweep fills find a co-optimal path's end and start cells)
and global Hirschberg between them.  BSW is banded, its direction storage
already O(M x band).

Output contract: a co-optimal alignment whose score is exact (re-scored);
the recursion makes the same splits as the JAX package's, so the output
is byte-identical to it.  The shorter sequence becomes the fills'
reference axis (the problem is symmetric under the swap).

On the card the split fills take the row-sweep kernel's last-row mode, a
band wavefront that spreads each problem's rows over many warps (one warp
a 128-row band), so a long pair's top levels, which have only a few
problems, fill the card: the stagger fill's last-row variant runs one
warp per problem over its bands in sequence (LAST_ROWS_KERNEL = "stagger"
selects it, bit-identical).  On CPU tensors every kernel's plain version
runs.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from tpu_align_torch.core.params import Algorithm, AlignmentParams
from tpu_align_torch.core.result import AlignmentResult
from tpu_align_torch.kernels import _build
from tpu_align_torch.kernels import fill as rowscan
from tpu_align_torch.kernels import stagger
from tpu_align_torch.kernels.common import NEG
from tpu_align_torch.runtime import profiler

GAP = "_"

# Split-level last-row fill: "auto" (the row-sweep fill, on the card and
# on CPU), "rowscan" or "stagger" (kernels/stagger.py
# fill_stagger_last_rows_async).  The two are bit-identical at every
# defined entry, so the knob is a pure performance A/B.
LAST_ROWS_KERNEL = "auto"

launches = 0  # split_reduce kernel launches
# the recursion's phases, each a "backtrack.<phase>" span
PHASES = ("fill", "reduce", "endpoints", "leaves")
# per card: split_reduce's state (its keys and ticket counters), zeroed
# once; every launch leaves it at 0 again (csrc/split_reduce.cu), so
# launches on one stream at a time, as the recursion makes them, share it
_state: dict = {}


def _last_rows_kernel() -> str:
    """The split levels' last-row fill, "rowscan" or "stagger", by
    LAST_ROWS_KERNEL."""
    pick = "rowscan" if LAST_ROWS_KERNEL == "auto" else LAST_ROWS_KERNEL
    if pick not in ("rowscan", "stagger"):
        raise ValueError(f"unknown LAST_ROWS_KERNEL {LAST_ROWS_KERNEL!r}")
    return pick


def fill_last_rows_async(algorithm, params, refs, qrys, rlen, qlen,
                         open_top=None):
    """The split level's last-row fill on the tensors' device, by
    LAST_ROWS_KERNEL."""
    if _last_rows_kernel() == "stagger":
        return stagger.fill_stagger_last_rows_async(
            algorithm, params, refs, qrys, rlen, qlen, open_top=open_top)
    return rowscan.fill_last_rows_async(algorithm, params, refs, qrys, rlen,
                                        qlen, open_top=open_top)


def _count_fill(kernel: str, probs, device) -> None:
    """Count a fill launch over these (ref_tokens, qry_tokens) problems
    (profiler.count_fill) when it ran on a card."""
    if device.type == "cuda":
        profiler.count_fill(kernel, [p[0].size for p in probs],
                            [p[1].size for p in probs])


def split_reduce_reference(hlast, flast, fhb, bhb, nn, go):
    """Plain PyTorch version of the split combine (hirschberg.py:139-152):
    for sub k with nn[k] real columns, F(i) = fhb[k] if i == 0 else
    hlast[i-1, 2k], B(j) the same from column 2k+1 and bhb, tot[i] = F(i)
    + B(nn-i) (+ extra), masked to NEG where nn - i < 0, in int32 as XLA
    adds.  Returns (4, K) int32: argmax_h, max_h, argmax_f, max_f, with
    np.argmax's first-max rule; the affine rows combine flast with extra =
    -go, and copy the H rows when flast is None."""
    n = hlast.shape[0]
    k = nn.shape[0]
    i32 = torch.int32

    def combine(last, extra):
        f = torch.cat([fhb[:, None], last[:, 0:2 * k:2].T], dim=1)
        bfull = torch.cat([bhb[:, None], last[:, 1:2 * k:2].T], dim=1)
        j = nn[:, None].long() - torch.arange(n + 1, device=hlast.device)
        b = bfull.gather(1, j.clamp(0, n))
        tot = torch.where(j >= 0, f + b + extra, NEG).to(i32)
        return torch.argmax(tot, dim=1).to(i32), tot.max(dim=1).values

    jh, mh = combine(hlast, 0)
    if flast is None:
        return torch.stack([jh, mh, jh, mh])
    jf, mf = combine(flast, -go[:, None])
    return torch.stack([jh, mh, jf, mf])


def split_reduce(hlast, flast, fhb, bhb, nn, go):
    """The split combine on the tensors' device: hlast, flast (N, 2K) int32
    (flast None for LNW); fhb, bhb, nn, go (K,) int32, all contiguous.
    CPU tensors run split_reduce_reference; CUDA tensors launch
    csrc/split_reduce.cu or raise.  Returns (4, K) int32."""
    global launches
    tensors = [hlast, fhb, bhb, nn, go] + ([flast] if flast is not None
                                           else [])
    k = nn.shape[0]
    for t in tensors:
        if t.dtype != torch.int32 or not t.is_contiguous() \
                or t.device != hlast.device:
            raise ValueError("split_reduce takes contiguous int32 tensors "
                             "on one device")
    if hlast.dim() != 2 or hlast.shape[1] < 2 * k or (
            flast is not None and flast.shape != hlast.shape):
        raise ValueError(f"last rows {tuple(hlast.shape)} do not hold 2 x "
                         f"{k} problems")
    kind = hlast.device.type
    if kind == "cpu":
        return split_reduce_reference(hlast, flast, fhb, bhb, nn, go)
    if kind != "cuda":
        raise ValueError(f"no split_reduce for device {hlast.device}")
    lib = _build.library()
    dev = hlast.device
    n, k2 = hlast.shape
    affine = int(flast is not None)
    with torch.cuda.device(dev):
        out = torch.empty((4, k), dtype=torch.int32, device=dev)
        need = lib.ta_torch_split_reduce_state_words(n, k2, k, affine)
        state = _state.get(dev)
        if state is None or state.numel() < need:
            state = _state[dev] = torch.zeros(
                max(need, 1 << 16), dtype=torch.int32, device=dev)
        rc = lib.ta_torch_split_reduce(
            hlast.data_ptr(), flast.data_ptr() if flast is not None else None,
            fhb.data_ptr(), bhb.data_ptr(), nn.data_ptr(), go.data_ptr(),
            n, k2, k, state.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"split_reduce kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    return out


def _tokens(s: str) -> np.ndarray:
    return np.frombuffer(s.encode("ascii"), np.uint8)


def _text(a: np.ndarray) -> str:
    return a.tobytes().decode("ascii")


def _batch_problems(probs, device):
    """Pad a list of (ref_tokens, qry_tokens) into fill tensors on
    `device`: (refs (B, N) uint8, qrys (B, M) uint8, rlen, qlen (B,)
    int32), N and M the longest side rounded up to 8.  The JAX package pads
    B, N and M to powers of two for its compile cache; the split results do
    not depend on padding (only entries j <= rlen are read)."""
    b = len(probs)
    n = -(-max(max(p[0].size for p in probs), 1) // 8) * 8
    m = -(-max(max(p[1].size for p in probs), 1) // 8) * 8
    refs = np.zeros((b, n), np.uint8)
    qrys = np.ones((b, m), np.uint8)  # pad token 1 never equals ref pad 0
    rlen = np.zeros(b, np.int32)
    qlen = np.zeros(b, np.int32)
    for k, (r, q) in enumerate(probs):
        refs[k, : r.size] = r
        qrys[k, : q.size] = q
        rlen[k] = r.size
        qlen[k] = q.size
    return tuple(_to(x, device) for x in (refs, qrys, rlen, qlen))


def _to(arr: np.ndarray, device) -> torch.Tensor:
    t = torch.from_numpy(arr)
    return t if device.type == "cpu" else t.to(device)


def _split_reduce(hlast, flast, fhb, bhb, nn, go, device):
    """Run the device combine; returns numpy (argmax_h, max_h, argmax_f,
    max_f) -- one (4, K) copy to the host per level."""
    out = split_reduce(hlast, flast,
                       *(_to(np.ascontiguousarray(v, np.int32), device)
                         for v in (fhb, bhb, nn, go)))
    return tuple(out.cpu().numpy())


def _split_level(params, subs, device, phase):
    """Split every open subproblem at its query midrow.

    subs: list of (ref_t, qry_t, (qi, qj, ri, rj)) -- possibly spanning
    different pairs.  One batched last-row fill serves the entire level:
    problem 2k is the forward top half, problem 2k+1 the reversed bottom
    half.  Returns (mids, split columns) -- the optimal path passes
    through (mid, split) of each subproblem."""
    probs = []
    mids = []
    for ref_t, qry_t, (qi, qj, ri, rj) in subs:
        mid = (qi + qj) // 2
        mids.append(mid)
        probs.append((ref_t[ri:rj], qry_t[qi:mid]))
        probs.append((ref_t[ri:rj][::-1].copy(), qry_t[mid:qj][::-1].copy()))
    with phase("fill"):
        _, hlast, _ = fill_last_rows_async(
            Algorithm.LNW, params, *_batch_problems(probs, device))
    _count_fill(_last_rows_kernel(), probs, device)
    g = params.gap
    # column 0 border is analytic: H[qlen][0] = qlen * gap
    fhb = [(mids[k] - s[2][0]) * g for k, s in enumerate(subs)]
    bhb = [(s[2][1] - mids[k]) * g for k, s in enumerate(subs)]
    nn = [s[2][3] - s[2][2] for s in subs]
    with phase("reduce"):
        jh, _, _, _ = _split_reduce(hlast, None, fhb, bhb, nn,
                                    np.zeros(len(subs)), device)
    splits = [subs[k][2][2] + int(jh[k]) for k in range(len(subs))]
    return mids, splits


def _leaf_lines_batch(params, leaves, device, phase):
    """Align leaf segments -- (ref_t, qry_t, (qi, qj, ri, rj)) from any
    number of pairs -- with ONE run of the port's engine on `device`
    (fill + packed-dirs host walk); returns the per-leaf 3-tuples in input
    order."""
    from tpu_align_torch.io.dataset import PairDataset
    from tpu_align_torch.runtime.engine import AlignmentEngine

    pairs = []
    out: dict[int, tuple[str, str, str]] = {}
    for idx, (ref_t, qry_t, (qi, qj, ri, rj)) in enumerate(leaves):
        rseg = _text(ref_t[ri:rj])
        qseg = _text(qry_t[qi:qj])
        if not rseg and not qseg:
            out[idx] = ("", "", "")
        elif not rseg:
            out[idx] = (GAP * len(qseg), " " * len(qseg), qseg)
        elif not qseg:
            out[idx] = (rseg, " " * len(rseg), GAP * len(rseg))
        else:
            pairs.append((idx, rseg, qseg))
    if pairs:
        with phase("leaves"):
            ds = PairDataset.from_pairs([(r, q) for _, r, q in pairs])
            eng = AlignmentEngine(Algorithm.LNW, params, device=device)
            res = eng.run(ds).results  # sorted by pair_num = position
        for (idx, _, _), r in zip(pairs, res):
            out[idx] = (r.ref_aligned, r.relation, r.query_aligned)
    return [out[i] for i in range(len(leaves))]


def _global_lines_batch(params, seqs, leaf_q, device, phase):
    """Hirschberg recursion for global LNW alignments of MANY pairs.

    seqs: list of (ref_t, qry_t).  Level-synchronous across pairs: every
    open subproblem of every pair at a given depth splits in one batched
    fill, and all leaves of all pairs run through one engine batch.
    Returns one (ref, rel, qry) line 3-tuple per pair."""
    def settle(seg):
        qi, qj, ri, rj = seg
        return "leaf" if (qj - qi <= leaf_q or rj == ri) else "open"

    # one ordered worklist per pair; entries ["open"|"leaf", (qi,qj,ri,rj)]
    worklists = []
    for ref_t, qry_t in seqs:
        root = (0, qry_t.size, 0, ref_t.size)
        worklists.append([[settle(root), root]])
    while True:
        open_refs = [
            (p, i)
            for p, items in enumerate(worklists)
            for i, (kind, _) in enumerate(items) if kind == "open"
        ]
        if not open_refs:
            break
        subs = [(seqs[p][0], seqs[p][1], worklists[p][i][1])
                for p, i in open_refs]
        mids, splits = _split_level(params, subs, device, phase)
        # replace back-to-front within each pair so indices stay valid
        for (p, i), mid, js in sorted(zip(open_refs, mids, splits),
                                      key=lambda t: (t[0][0], -t[0][1])):
            items = worklists[p]
            qi, qj, ri, rj = items[i][1]
            left = (qi, mid, ri, js)
            right = (mid, qj, js, rj)
            items[i:i + 1] = [[settle(left), left], [settle(right), right]]
    leaves = [
        (seqs[p][0], seqs[p][1], e)
        for p, items in enumerate(worklists) for _, e in items
    ]
    lines = _leaf_lines_batch(params, leaves, device, phase)
    out = []
    pos = 0
    for items in worklists:
        chunk = lines[pos: pos + len(items)]
        pos += len(items)
        out.append(("".join(x[0] for x in chunk),
                    "".join(x[1] for x in chunk),
                    "".join(x[2] for x in chunk)))
    return out


# ---------------------------------------------------------------------------
# Myers-Miller (affine gaps): Hirschberg with boundary gap credits
# ---------------------------------------------------------------------------


def _one_row_lines(params, rseg, qc, tb, te):
    """Optimal single-query-row alignment under boundary credits (the
    Myers-Miller M == 1 base case): either the query char takes a diagonal
    at some column k (horizontal gap runs on both sides), or the whole row
    is one vertical gap move opening at the better credit."""
    go, ge = params.gap_open, params.gap_extend

    def gap(x):
        return 0 if x == 0 else go + x * ge

    n = rseg.size
    k = np.arange(n)
    w = np.where(rseg == qc, params.match, params.mismatch)
    left = np.where(k == 0, 0, go + k * ge)
    right_len = n - 1 - k
    right = np.where(right_len == 0, 0, go + right_len * ge)
    diag = left + w + right
    vert = gap(n) + max(tb, te) + ge
    rstr = _text(rseg)
    qch = chr(qc)
    if diag.size and diag.max() >= vert:
        kk = int(np.argmax(diag))
        rel = "*" if rseg[kk] == qc else "|"
        return (rstr,
                " " * kk + rel + " " * (n - 1 - kk),
                GAP * kk + qch + GAP * (n - 1 - kk))
    # vertical: place the deleted row at the credited boundary so the gap
    # merges with the adjoining subproblem's gap run
    if te >= tb:
        return rstr + GAP, " " * (n + 1), GAP * n + qch
    return GAP + rstr, " " * (n + 1), qch + GAP * n


def _affine_split_level(params, subs, device, phase):
    """Myers-Miller split for every open (qi, qj, ri, rj, tb, te).

    subs: list of (ref_t, qry_t, sub6) -- possibly spanning different
    pairs.  One batched credited last-row fill serves the level (problem
    2k = forward top half with open_top=tb, 2k+1 = reversed bottom half
    with open_top=te).  Each sub resolves to a piece list: two child subs
    (type-1 crossing, H + H), or child/bridge-lines/child (type-2: the
    path crosses the midrow INSIDE a vertical gap -- rows mid and mid+1
    are forced deletions and the halves get a free open at the shared
    boundary, Myers & Miller 1988)."""
    go, ge = params.gap_open, params.gap_extend
    probs, opens = [], []
    for ref_t, qry_t, (qi, qj, ri, rj, tb, te) in subs:
        mid = (qi + qj) // 2
        probs.append((ref_t[ri:rj], qry_t[qi:mid]))
        opens.append(tb)
        probs.append((ref_t[ri:rj][::-1].copy(), qry_t[mid:qj][::-1].copy()))
        opens.append(te)
    with phase("fill"):
        _, hlast, flast = fill_last_rows_async(
            Algorithm.ANW, params, *_batch_problems(probs, device),
            open_top=_to(np.array(opens, np.int32), device))
    _count_fill(_last_rows_kernel(), probs, device)
    # border column j = 0 is one vertical gap from the corner: it IS
    # the F state there and opens at the boundary credit; tot_f counts
    # the bridged gap's open once (-go in the device combine).  The
    # argmax/max reduction runs on the device -- 4 ints per sub transfer.
    fhb = [s[2][4] + ((s[2][0] + s[2][1]) // 2 - s[2][0]) * ge for s in subs]
    bhb = [s[2][5] + (s[2][1] - (s[2][0] + s[2][1]) // 2) * ge for s in subs]
    nns = [s[2][3] - s[2][2] for s in subs]
    with phase("reduce"):
        jhs, mhs, jfs, mfs = _split_reduce(hlast, flast, fhb, bhb, nns,
                                           np.full(len(subs), go), device)
    pieces = []
    for k, (ref_t, qry_t, (qi, qj, ri, rj, tb, te)) in enumerate(subs):
        mid = (qi + qj) // 2
        if mfs[k] > mhs[k]:
            js = ri + int(jfs[k])
            bridge = (GAP * 2, "  ", _text(qry_t[mid - 1: mid + 1]))
            pieces.append([
                (qi, mid - 1, ri, js, tb, 0),
                ["lines", bridge],
                (mid + 1, qj, js, rj, 0, te),
            ])
        else:
            js = ri + int(jhs[k])
            pieces.append([
                (qi, mid, ri, js, tb, go),
                (mid, qj, js, rj, go, te),
            ])
    return pieces


def _affine_lines_batch(params, seqs, leaf_q, device, phase):
    """Myers-Miller recursion for global ANW alignments of MANY pairs;
    level-synchronous across pairs like _global_lines_batch."""
    go = params.gap_open

    def settle(ref_t, qry_t, sub):
        qi, qj, ri, rj, tb, te = sub
        qlen, rlen = qj - qi, rj - ri
        if qlen == 0:
            rseg = _text(ref_t[ri:rj])
            return ["lines", (rseg, " " * rlen, GAP * rlen)]
        if rlen == 0:
            qseg = _text(qry_t[qi:qj])
            return ["lines", (GAP * qlen, " " * qlen, qseg)]
        if qlen == 1:
            return ["lines",
                    _one_row_lines(params, ref_t[ri:rj], qry_t[qi], tb, te)]
        if tb == go and te == go and qlen <= leaf_q:
            # credit-free subproblem: the standard packed-dirs engine is
            # optimal for it (boundary gaps cannot merge with neighbors
            # without contradicting the parent split's optimality)
            return ["engine", (qi, qj, ri, rj)]
        return ["open", sub]

    worklists = [
        [settle(r, q, (0, q.size, 0, r.size, go, go))] for r, q in seqs
    ]
    while True:
        open_refs = [
            (p, i)
            for p, items in enumerate(worklists)
            for i, (kind, _) in enumerate(items) if kind == "open"
        ]
        if not open_refs:
            break
        subs = [(seqs[p][0], seqs[p][1], worklists[p][i][1])
                for p, i in open_refs]
        pieces = _affine_split_level(params, subs, device, phase)
        for (p, i), piece in sorted(zip(open_refs, pieces),
                                    key=lambda t: (t[0][0], -t[0][1])):
            ref_t, qry_t = seqs[p]
            worklists[p][i:i + 1] = [
                x if isinstance(x, list) else settle(ref_t, qry_t, x)
                for x in piece
            ]
    eng_refs = [
        (p, i)
        for p, items in enumerate(worklists)
        for i, (kind, _) in enumerate(items) if kind == "engine"
    ]
    if eng_refs:
        from tpu_align_torch.io.dataset import PairDataset
        from tpu_align_torch.runtime.engine import AlignmentEngine

        with phase("leaves"):
            ds = PairDataset.from_pairs([
                (_text(seqs[p][0][ri:rj]), _text(seqs[p][1][qi:qj]))
                for p, i in eng_refs
                for (qi, qj, ri, rj) in [worklists[p][i][1]]
            ])
            eng = AlignmentEngine(Algorithm.ANW, params, device=device)
            res = eng.run(ds).results
        for (p, i), r in zip(eng_refs, res):
            worklists[p][i] = ["lines",
                               (r.ref_aligned, r.relation, r.query_aligned)]
    out = []
    for items in worklists:
        parts = [v for _, v in items]
        out.append(("".join(x[0] for x in parts),
                    "".join(x[1] for x in parts),
                    "".join(x[2] for x in parts)))
    return out


def _local_endpoints_batch(params, seqs, device, phase):
    """Locate a co-optimal local path's end and start cells for MANY pairs
    with two batched scores-only row-sweep fills (one forward fill for all
    pairs; one reversed fill over each end cell's prefix).  Returns a list
    of (score, (sr, er, sc, ec) | None)."""
    with phase("endpoints"):
        sc, er, ec, _ = rowscan.fill_bucket_async(
            Algorithm.LSW, params, *_batch_problems(list(seqs), device),
            with_traceback=False)
        _count_fill("rowscan", seqs, device)
        scores, ers, ecs = (t.cpu().numpy().astype(int)
                            for t in (sc, er, ec))
    n = len(seqs)
    live = [k for k in range(n) if scores[k] > 0]
    out = [(int(scores[k]), None) for k in range(n)]
    if not live:
        return out
    rev = [(seqs[k][0][: ecs[k]][::-1].copy(),
            seqs[k][1][: ers[k]][::-1].copy()) for k in live]
    with phase("endpoints"):
        sc2, rr, rc, _ = rowscan.fill_bucket_async(
            Algorithm.LSW, params, *_batch_problems(rev, device),
            with_traceback=False)
        _count_fill("rowscan", rev, device)
        sc2, rr, rc = (t.cpu().numpy().astype(int) for t in (sc2, rr, rc))
    for j, k in enumerate(live):
        if int(sc2[j]) != int(scores[k]):  # suffix max == the global max
            raise RuntimeError(
                f"LSW endpoint discovery (pair {k}): reversed-fill max "
                f"{int(sc2[j])} != forward local max {int(scores[k])}; "
                "fill kernel regression?")
        out[k] = (int(scores[k]),
                  (int(ers[k] - rr[j]), int(ers[k]),
                   int(ecs[k] - rc[j]), int(ecs[k])))
    return out  # qry [sr:er], ref [sc:ec]


def hirschberg_align(
    algorithm: Algorithm,
    params: AlignmentParams | None,
    ref: str,
    qry: str,
    pair_num: int = 0,
    leaf_q: int = 128,
    device: str | torch.device = "cuda",
) -> AlignmentResult:
    """Align one pair with no direction storage (O(M+N) working memory);
    see hirschberg_align_batch."""
    return hirschberg_align_batch(
        algorithm, params, [(ref, qry)], pair_nums=[pair_num],
        leaf_q=leaf_q, device=device,
    )[0]


def hirschberg_align_batch(
    algorithm: Algorithm,
    params: AlignmentParams | None,
    pairs,
    pair_nums=None,
    leaf_q: int = 128,
    device: str | torch.device = "cuda",
    phase_seconds: dict | None = None,
    timer: profiler.PhaseTimer | None = None,
) -> list[AlignmentResult]:
    """Align MANY pairs with no direction storage, level-batched across
    pairs: every recursion depth's open subproblems -- of all pairs --
    merge into one fill, and all leaves run through one engine batch.

    LNW: Hirschberg over the last-row fill.  ANW: Myers-Miller -- the
    split also considers the path crossing the midrow inside a vertical
    gap (the captured F last rows), forcing two bridge deletions and
    handing the halves a free gap-open credit.  LSW: endpoint discovery,
    then global Hirschberg on the max-cell-to-max-cell segment.

    pairs: [(ref, qry), ...]; pair_nums: result numbering (default
    positional).  leaf_q: subproblems with at most this many query rows
    run through the engine's packed-dirs fill and walk.  device: where
    the fills and the combine run ("cpu" runs their plain versions).
    timer: the PhaseTimer the phases are spans of, "backtrack.fill",
    "backtrack.reduce", "backtrack.endpoints" and "backtrack.leaves"
    (AlignmentEngine passes its own, inside its "backtrack"); nothing
    waits for the card at their ends.  phase_seconds, when given,
    accumulates the seconds of those spans under "fill", "reduce",
    "endpoints" and "leaves", and then the card is synchronised at each
    one's end, so its kernels' time lands in it; the rest of the wall is
    the host recursion."""
    params = params or AlignmentParams()
    if algorithm is Algorithm.BSW:
        raise NotImplementedError(
            "hirschberg is for unbanded pairs; BSW direction storage is "
            "already O(M*band) -- use the banded kernel"
        )
    if algorithm.is_affine and params.gap_open > 0:
        raise ValueError("ANW requires gap_open <= 0")
    device = torch.device(device)
    timer = timer if timer is not None else profiler.PhaseTimer()
    sync = phase_seconds is not None and device.type == "cuda"
    before = {n: timer.seconds.get(f"backtrack.{n}", 0.0) for n in PHASES}

    @contextlib.contextmanager
    def phase(name):
        with timer.phase(f"backtrack.{name}"):
            yield
            if sync:
                torch.cuda.synchronize(device)

    if pair_nums is None:
        pair_nums = list(range(len(pairs)))
    # The DP problem is symmetric under swapping the two sequences (the
    # relation line and score are invariant; the gap lines swap; for
    # affine the E and F matrices trade roles under the same weights), and
    # this mode promises a co-optimal alignment, not the walkers' tie
    # chain -- so solve with the SHORTER side as the fills' reference
    # axis, the one whose rows the fills hold.
    seqs, flips = [], []
    for ref, qry in pairs:
        ref_t, qry_t = _tokens(ref), _tokens(qry)
        flip = ref_t.size > qry_t.size
        if flip:
            ref_t, qry_t = qry_t, ref_t
        seqs.append((ref_t, qry_t))
        flips.append(flip)

    def result(k, score, r="", m="", q=""):
        if flips[k]:
            r, q = q, r
        return AlignmentResult(pair_nums[k], score, r, m, q)

    try:
        if algorithm is Algorithm.ANW:
            lines = _affine_lines_batch(params, seqs, leaf_q, device, phase)
            return [result(k, _rescore_affine(params, r, q), r, m, q)
                    for k, (r, m, q) in enumerate(lines)]
        if algorithm is Algorithm.LSW:
            ends = _local_endpoints_batch(params, seqs, device, phase)
            seg_idx = [k for k, (_, seg) in enumerate(ends) if seg is not None]
            seg_seqs = []
            for k in seg_idx:
                sr, er, sc, ec = ends[k][1]
                ref_t, qry_t = seqs[k]
                seg_seqs.append((ref_t[sc:ec], qry_t[sr:er]))
            seg_lines = (_global_lines_batch(params, seg_seqs, leaf_q, device,
                                             phase) if seg_seqs else [])
            out = [result(k, score) for k, (score, _) in enumerate(ends)]
            for k, (r, m, q) in zip(seg_idx, seg_lines):
                # the score comes from the forward fill: reconcile the emitted
                # segment against it, so a regression fails loudly
                got = _rescore(params, r, q)
                if got != ends[k][0]:
                    raise RuntimeError(
                        f"hirschberg LSW rescore mismatch (pair "
                        f"{pair_nums[k]}): lines score {got}, fill says "
                        f"{ends[k][0]}")
                out[k] = result(k, ends[k][0], r, m, q)
            return out
        lines = _global_lines_batch(params, seqs, leaf_q, device, phase)
        return [result(k, _rescore(params, r, q), r, m, q)
                for k, (r, m, q) in enumerate(lines)]
    finally:
        if phase_seconds is not None:
            for n in PHASES:
                if f"backtrack.{n}" in timer.seconds:
                    phase_seconds[n] = (phase_seconds.get(n, 0.0) - before[n]
                                        + timer.seconds[f"backtrack.{n}"])


def _rescore(params, ref_line: str, qry_line: str) -> int:
    """Exact linear-gap score of an emitted alignment (sum over columns)."""
    score = 0
    for rc, qc in zip(ref_line, qry_line):
        if rc == GAP or qc == GAP:
            score += params.gap
        else:
            score += params.match if rc == qc else params.mismatch
    return score


def _rescore_affine(params, ref_line: str, qry_line: str) -> int:
    """Exact affine-gap score of an emitted alignment (gap-run aware)."""
    score = 0
    in_e = in_f = False  # inside a horizontal (E) / vertical (F) gap run
    for rc, qc in zip(ref_line, qry_line):
        if rc == GAP:  # vertical: query char consumed, gap in the ref line
            score += params.gap_extend + (0 if in_f else params.gap_open)
            in_f, in_e = True, False
        elif qc == GAP:  # horizontal
            score += params.gap_extend + (0 if in_e else params.gap_open)
            in_e, in_f = True, False
        else:
            score += params.match if rc == qc else params.mismatch
            in_e = in_f = False
    return score
