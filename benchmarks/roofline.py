"""The yardstick of the rooflines: the card's peaks and the least work the
inputs need.

Peaks are those of one H100 SXM at its 700 W limit (NVIDIA's data sheet
and Hopper white paper): 3.35 TB/s of HBM; 132 SMs x 64 int32 lanes x
1.98 GHz boost = 16.7 T int32 (or DPX) lane-operations a second, and
twice that in 16-bit pairs (the s16x2 DPX forms, which the program's own
s16x2 experiment measured at 2.0x int32).  A cell whose every score fits
in int16 could run in 16-bit pairs, so its bound uses the 16-bit rate;
any other cell the int32 rate.

Work is what the inputs need, whatever implements it: each real cell of
each pair's matrix once, at CELL_OPS integer operations (one fewer when
no direction is kept); the sequences read once and the scores written
once.  Recomputation (Hirschberg's) and direction words are not counted:
an implementation may avoid both.  A walk takes WALK_OPS operations a
move and reads one 2-bit code a move; it writes its gap events (uint16).
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_S = 3.35e12
INT32_OPS_S = 132 * 64 * 1.98e9
INT16X2_OPS_S = 2 * INT32_OPS_S
INT16_MAX = 32767
# the fewest integer operations a cell takes, a fused DPX add-max as one:
# the substitution weight, two gap add-maxes and the direction code (LNW);
# LSW and BSW clamp at 0 as well; ANW adds E's and F's add-max and a max
CELL_OPS = {"lnw": 4, "lsw": 5, "bsw": 5, "anw": 7}
WALK_OPS = 4
SCORE_BYTES = 4
EVENT_BYTES = 2


def fits_int16(aligner: str, scoring: dict, rlen, qlen) -> bool:
    """Every score of every cell of these pairs lies within int16: no
    path is longer than qlen + rlen columns, none of which moves the
    score by more than the largest weight."""
    if aligner == "anw":
        step = max(abs(scoring["match"]), abs(scoring["mismatch"]),
                   abs(scoring["gap_open"]) + abs(scoring["gap_extend"]))
    else:
        step = max(abs(scoring["match"]), abs(scoring["mismatch"]),
                   abs(scoring["gap"]))
    longest = int(np.max(np.asarray(rlen) + np.asarray(qlen)))
    return longest * step <= INT16_MAX


def cells(aligner: str, scoring: dict, rlen, qlen) -> int:
    """The real cells of the pairs' matrices (BSW: those in its band)."""
    rlen = np.asarray(rlen, np.int64)
    qlen = np.asarray(qlen, np.int64)
    if aligner != "bsw":
        return int(np.sum(rlen * qlen))
    band = scoring["band"]
    total = 0
    for n, m in zip(rlen.tolist(), qlen.tolist()):
        i = np.arange(1, m + 1)
        lo = np.maximum(1, i - band + 1)
        hi = np.minimum(n, i + band - 1)
        total += int(np.maximum(hi - lo + 1, 0).sum())
    return total


def fill_work(aligner: str, scoring: dict, rlen, qlen,
              with_dirs: bool) -> tuple[int, int]:
    """(operations, bytes) the fills of these pairs need."""
    ops = cells(aligner, scoring, rlen, qlen) * (
        CELL_OPS[aligner] - (0 if with_dirs else 1))
    nbytes = int(np.sum(rlen) + np.sum(qlen)) + SCORE_BYTES * len(rlen)
    return ops, nbytes


def walk_work(moves: int, gaps: int, pairs: int) -> tuple[int, int]:
    """(operations, bytes) of walks that take `moves` moves, `gaps` of
    them gaps: a code read a move, an event written a gap, a score read
    a pair."""
    return (WALK_OPS * moves,
            moves // 4 + EVENT_BYTES * gaps + SCORE_BYTES * pairs)


def bound_seconds(ops: int, nbytes: int, ops_s: float) -> tuple[float, str]:
    """The least time the card could take, and which side bounds it."""
    t_ops = ops / ops_s
    t_bytes = nbytes / HBM_BYTES_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
