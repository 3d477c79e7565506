"""The plain reference: the four aligners' fills and walks in plain
PyTorch, one query row at a time over a batch of pairs.

It imports nothing of the program.  It states the semantics the
program's blocks are held to (the reference project's, as the program's
oracle states them in its docstrings):

* LNW: H = max(diag + w, up + gap, left + gap), borders j*gap and i*gap;
  on ties insertion (left) >= deletion (up) >= diagonal.
* LSW: H = max(0, diag + w, up + gap, left + gap), zero borders; on ties
  NONE (0) >= deletion >= insertion >= diagonal; the walk starts at the
  first strict maximum in row-major order and stops at a NONE cell.
* BSW: LSW on the cells of row i with 1 + max(0, i - band) <= j <
  i + band; cells outside keep 0 and NONE.
* ANW: Gotoh, F (vertical) and E (horizontal) opening at open + extend,
  extending at extend, opening winning ties, row 1 and column 1 opening;
  H = max(diag + w, F, E), on ties E >= F >= diagonal; borders
  open + i*extend; the walk follows E and F runs, then flushes.

A row's left-to-right dependency is a prefix maximum: with T the best of
the diagonal and the up move, H[j] = max_k<=j (T[k] + (j - k) * gap),
which torch.cummax gives (for ANW, E[j] = open + j*extend +
max_k<j (D[k] - k*extend), with D the best of the diagonal and F).

Every score tensor has the dtype the caller gives: torch.int32 is the
program's stated precision; a narrower one wraps as that type does, which
is how the control computes "the reference in the next precision down".
"""

from __future__ import annotations

import numpy as np
import torch

NONE, MATCH, MISMATCH, DELETION, INSERTION = 0, 1, 2, 3, 4
E_EXTEND, F_EXTEND = 8, 16  # ANW: E and F came from an extension
GAP, REL_MATCH, REL_MISMATCH, REL_GAP = ord("_"), ord("*"), ord("|"), ord(" ")
PAD_REF, PAD_QRY = 0, 1  # never equal to each other or to a base

GLOBAL = ("lnw", "anw")
LOCAL = ("lsw", "bsw")


def tokens(pairs, device) -> tuple:
    """(ref (B, N) uint8, qry (B, M) uint8, rlen, qlen (B,) int64) of a
    list of (reference, query) byte strings, padded with PAD_REF/PAD_QRY."""
    b = len(pairs)
    n = max(len(r) for r, _ in pairs)
    m = max(len(q) for _, q in pairs)
    ref = torch.full((b, n), PAD_REF, dtype=torch.uint8)
    qry = torch.full((b, m), PAD_QRY, dtype=torch.uint8)
    for k, (r, q) in enumerate(pairs):
        ref[k, :len(r)] = torch.frombuffer(bytearray(r), dtype=torch.uint8)
        qry[k, :len(q)] = torch.frombuffer(bytearray(q), dtype=torch.uint8)
    rlen = torch.tensor([len(r) for r, _ in pairs], dtype=torch.int64)
    qlen = torch.tensor([len(q) for _, q in pairs], dtype=torch.int64)
    return tuple(t.to(device) for t in (ref, qry, rlen, qlen))


def fill(aligner: str, scoring: dict, ref, qry, rlen, qlen,
         dtype=torch.int32, with_dirs: bool = True) -> dict:
    """Fill every pair's matrix row by row.  Returns score (B,) int64,
    the walk's start cell srow, scol (B,) int64, and with_dirs the
    direction codes dirs (B, M + 1, N + 1) uint8 (ANW: with E_EXTEND and
    F_EXTEND bits)."""
    b, n = ref.shape
    m = qry.shape[1]
    dev = ref.device
    match, mismatch = scoring["match"], scoring["mismatch"]
    gap = scoring["gap"]
    go, ge = scoring["gap_open"], scoring["gap_extend"]
    band = scoring["band"]
    j = torch.arange(n + 1, device=dev)
    jg = (j * gap).to(dtype)
    je = (j * ge).to(dtype)
    local = aligner in LOCAL
    if aligner == "lnw":
        h = jg.expand(b, n + 1).clone()
    elif aligner == "anw":
        h = (go + j * ge).to(dtype).expand(b, n + 1).clone()
        h[:, 0] = 0
    elif local:
        h = torch.zeros((b, n + 1), dtype=dtype, device=dev)
    else:
        raise ValueError(f"unknown aligner {aligner!r}")
    f = None
    dirs = None
    if with_dirs:
        dirs = torch.empty((b, m + 1, n + 1), dtype=torch.uint8, device=dev)
        dirs[:, 0, :] = NONE if local else INSERTION
        dirs[:, :, 0] = NONE if local else DELETION
        dirs[:, 0, 0] = NONE
    zero = torch.zeros((), dtype=dtype, device=dev)
    final = h.gather(1, rlen[:, None])[:, 0].to(torch.int64)
    best = torch.zeros(b, dtype=torch.int64, device=dev)
    srow = torch.zeros(b, dtype=torch.int64, device=dev)
    scol = torch.zeros(b, dtype=torch.int64, device=dev)
    in_ref = j[None, 1:] <= rlen[:, None]
    for i in range(1, m + 1):
        eq = ref == qry[:, i - 1:i]
        w = torch.where(eq, match, mismatch).to(dtype)
        diag = h[:, :-1] + w
        up = h[:, 1:] + gap
        dcode = torch.where(eq, MATCH, MISMATCH).to(torch.uint8)
        if aligner == "anw":
            border = torch.full((b, 1), go + i * ge, device=dev).to(dtype)
            f_open = h[:, 1:] + (go + ge)
            if f is None:
                f = f_open
                f_ext = torch.zeros_like(eq)
            else:
                f_extend = f + ge
                f_ext = f_extend > f_open
                f = torch.maximum(f_open, f_extend)
            d = torch.maximum(diag, f)
            code = torch.where(f >= diag, DELETION, dcode)
            c = torch.cummax(torch.cat([border, d], 1) - je, 1).values
            e = (go + je[1:]) + c[:, :-1]
            hn = torch.maximum(d, e)
            code = torch.where(e >= d, INSERTION, code)
            e_ext = torch.zeros_like(eq)
            e_ext[:, 1:] = (e[:, :-1] + ge) > (hn[:, :-1] + (go + ge))
            h = torch.cat([border, hn], 1)
            code = code | (e_ext.to(torch.uint8) << 3) \
                | (f_ext.to(torch.uint8) << 4)
        elif aligner == "lnw":
            t = torch.maximum(diag, up)
            border = torch.full((b, 1), i * gap, device=dev).to(dtype)
            h = torch.cummax(torch.cat([border, t], 1) - jg, 1).values + jg
            left = h[:, :-1] + gap
            code = torch.where(left >= t, INSERTION,
                               torch.where(up >= diag, DELETION, dcode))
        else:
            u = torch.maximum(torch.maximum(diag, up), zero)
            if aligner == "bsw":
                jj = j[1:]
                in_band = (jj >= 1 + max(0, i - band)) & (jj < i + band)
                u = torch.where(in_band, u, zero)
            col0 = torch.zeros((b, 1), dtype=dtype, device=dev)
            h = torch.cummax(torch.cat([col0, u], 1) - jg, 1).values + jg
            if aligner == "bsw":
                h[:, 1:] = torch.where(in_band, h[:, 1:], zero)
            h[:, 0] = 0
            left = h[:, :-1] + gap
            b1 = torch.where(left >= diag, left, diag)
            code = torch.where(left >= diag, INSERTION, dcode)
            code = torch.where(up >= b1, DELETION, code)
            code = torch.where(torch.maximum(up, b1) <= 0, NONE, code)
            if aligner == "bsw":
                code = torch.where(in_band, code, NONE)
            row = torch.where(in_ref, h[:, 1:],
                              torch.full_like(h[:, 1:], -1)).to(torch.int64)
            row_best, at = row.max(1)
            better = (row_best > best) & (i <= qlen)
            best = torch.where(better, row_best, best)
            srow = torch.where(better, i, srow)
            scol = torch.where(better, at + 1, scol)
        if with_dirs:
            dirs[:, i, 1:] = code.to(torch.uint8)
        if not local:
            final = torch.where(qlen == i,
                                h.gather(1, rlen[:, None])[:, 0].to(
                                    torch.int64), final)
    if local:
        return {"score": best, "srow": srow, "scol": scol, "dirs": dirs}
    return {"score": final, "srow": qlen.clone(), "scol": rlen.clone(),
            "dirs": dirs}


def walk(aligner: str, ref, qry, filled: dict):
    """Walk every pair's codes back from its start cell.  Returns
    (ref_line, rel_line, qry_line) as (B, L) uint8, each pair's first
    lengths[b] entries in reverse alignment order, and lengths (B,)."""
    dirs = filled["dirs"]
    b, m1, n1 = dirs.shape
    dev = dirs.device
    r = filled["srow"].clone()
    c = filled["scol"].clone()
    steps = m1 + n1
    out = torch.zeros((3, b, steps), dtype=torch.uint8, device=dev)
    length = torch.zeros(b, dtype=torch.int64, device=dev)
    state = torch.zeros(b, dtype=torch.int64, device=dev)  # ANW: 0, INS, DEL
    flat = dirs.reshape(b, -1)
    rows = torch.arange(b, device=dev)
    for step in range(steps):
        d = flat.gather(1, (r * n1 + c)[:, None])[:, 0].to(torch.int64)
        main = d & 7
        if aligner == "lnw":
            active = (r > 0) | (c > 0)
            kind = main
        elif aligner in LOCAL:
            active = (r > 0) & (c > 0) & (main != NONE)
            kind = main
        else:
            inside = (r > 0) & (c > 0)
            active = (r > 0) | (c > 0)
            eff = torch.where(state == 0,
                              torch.where(main == DELETION, 2,
                                          torch.where(main == INSERTION, 1,
                                                      0)),
                              state)
            kind = torch.where(eff == 1, INSERTION,
                               torch.where(eff == 2, DELETION, MATCH))
            nxt = torch.where(eff == 1, torch.where((d & E_EXTEND) > 0, 1, 0),
                              torch.where(eff == 2,
                                          torch.where((d & F_EXTEND) > 0, 2,
                                                      0), 0))
            state = torch.where(inside, nxt, state)
            # past row 0 or column 0: the flush, deletions then insertions
            kind = torch.where(inside, kind,
                               torch.where(r > 0, DELETION, INSERTION))
        if step % 64 == 0 and not bool(active.any()):
            break
        diag = (kind == MATCH) | (kind == MISMATCH)
        rc = ref[rows, (c - 1).clamp(min=0)]
        qc = qry[rows, (r - 1).clamp(min=0)]
        out[0, :, step] = torch.where(kind == DELETION, GAP, rc)
        out[2, :, step] = torch.where(kind == INSERTION, GAP, qc)
        out[1, :, step] = torch.where(
            diag, torch.where(rc == qc, REL_MATCH, REL_MISMATCH), REL_GAP
        ).to(torch.uint8)
        length += active
        r = r - (active & (diag | (kind == DELETION))).to(torch.int64)
        c = c - (active & (diag | (kind == INSERTION))).to(torch.int64)
    return out[0], out[1], out[2], length


def blocks(aligner: str, scoring: dict, pairs, device,
           dtype=torch.int32, pair_base: int = 0) -> tuple[list, dict]:
    """Each pair's 4-line block as bytes (numbered from pair_base), and the
    walk's counts: moves (every pair's alignment length) and gaps (its
    gap columns)."""
    ref, qry, rlen, qlen = tokens(pairs, device)
    filled = fill(aligner, scoring, ref, qry, rlen, qlen, dtype)
    lines = walk(aligner, ref, qry, filled)
    r_line, m_line, q_line, length = (t.cpu().numpy() for t in lines)
    scores = filled["score"].cpu().tolist()
    out = []
    for k, (n, s) in enumerate(zip(length.tolist(), scores)):
        out.append(b"%d | %d\n%s\n%s\n%s\n" % (
            pair_base + k, s, r_line[k, :n][::-1].tobytes(),
            m_line[k, :n][::-1].tobytes(), q_line[k, :n][::-1].tobytes()))
    gaps = int(((m_line == REL_GAP)
                & (np.arange(m_line.shape[1])[None, :] < length[:, None])
                ).sum())
    return out, {"moves": int(length.sum()), "gaps": gaps}


def scores(aligner: str, scoring: dict, pairs, device,
           dtype=torch.int32) -> list[int]:
    """The optimal score of each pair (no directions kept)."""
    ref, qry, rlen, qlen = tokens(pairs, device)
    filled = fill(aligner, scoring, ref, qry, rlen, qlen, dtype,
                  with_dirs=False)
    return filled["score"].cpu().tolist()


def rescore(aligner: str, scoring: dict, ref_line: bytes,
            qry_line: bytes) -> int:
    """The exact score of an emitted alignment, column by column (ANW:
    a gap run opens once; a column with a gap in the reference line is a
    vertical gap, else one in the query line a horizontal one)."""
    r = np.frombuffer(ref_line, np.uint8)
    q = np.frombuffer(qry_line, np.uint8)
    vertical = r == GAP
    horizontal = (q == GAP) & ~vertical
    pair = ~(vertical | horizontal)
    score = int(np.where(r[pair] == q[pair], scoring["match"],
                         scoring["mismatch"]).sum())
    gaps = int(vertical.sum() + horizontal.sum())
    if aligner != "anw":
        return score + gaps * scoring["gap"]
    opens = sum(int((run & ~np.concatenate([[False], run[:-1]])).sum())
                for run in (vertical, horizontal))
    return score + gaps * scoring["gap_extend"] + opens * scoring["gap_open"]
