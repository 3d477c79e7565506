"""The comparison that decides `correct`: the program's outputs from the
window against the plain reference (reference.py).

Which comparison a cell takes follows from its traffic:

* "blocks" (a traceback run through the walkers): every pair's 4-line
  block byte-identical to the reference's.  Number: blocks_wrong.
* "alignment" (traceback "hirschberg"): the contract is a co-optimal
  alignment, not the walkers' tie chain, so each block is parsed: its
  score must be the reference's optimal score (score_gap, the widest
  difference), and its lines a valid alignment of the pair whose exact
  score is the one printed (bad_alignments).
* "scores" (with_traceback false): every compared pair's score equal to
  the reference's, each block a header and three empty lines
  (scores_wrong).

Every number is a count or a difference of exact integer results, so
every limit is 0.
"""

from __future__ import annotations

import numpy as np

from benchmarks import reference

LIMITS = {"blocks_wrong": 0, "score_gap": 0, "bad_alignments": 0,
          "scores_wrong": 0}


def mode(traffic: dict) -> str:
    if not traffic["with_traceback"]:
        return "scores"
    return "alignment" if traffic["traceback"] == "hirschberg" else "blocks"


def split_blocks(buf) -> list[bytes]:
    """A pair-ordered byte stream of 4-line blocks, one bytes a block (a
    trailing fragment of fewer than 4 lines is its own last entry)."""
    data = bytes(buf)
    nl = np.flatnonzero(np.frombuffer(data, np.uint8) == 10)
    ends = (nl[3::4] + 1).tolist()
    starts = [0] + ends[:-1]
    out = [data[s:e] for s, e in zip(starts, ends)]
    tail = ends[-1] if ends else 0
    if tail < len(data):
        out.append(data[tail:])
    return out


def _header(block: bytes):
    head, _, rest = block.partition(b"\n")
    num, sep, score = head.partition(b" | ")
    try:
        return int(num), int(score), rest
    except ValueError:
        return None, None, rest


def blocks_wrong(got, expected: list[bytes]) -> int:
    """Pairs whose block differs from the reference's (a missing or an
    extra block counts once)."""
    if bytes(got) == b"".join(expected):
        return 0
    have = split_blocks(got)
    wrong = sum(a != b for a, b in zip(have, expected))
    return wrong + abs(len(have) - len(expected))


def _valid(aligner: str, scoring: dict, ref: bytes, qry: bytes,
           score: int, lines: list[bytes]) -> bool:
    """The three lines align ref and qry (whole for a global aligner, a
    contiguous piece of each for a local one), their relation line says
    what each column is, and they score `score` exactly."""
    if len(lines) != 3 or not len(lines[0]) == len(lines[1]) == len(lines[2]):
        return False
    r, m, q = (np.frombuffer(x, np.uint8) for x in lines)
    r_gap = r == reference.GAP
    q_gap = q == reference.GAP
    want = np.where(r_gap | q_gap, reference.REL_GAP,
                    np.where(r == q, reference.REL_MATCH,
                             reference.REL_MISMATCH))
    if (r_gap & q_gap).any() or not np.array_equal(m, want):
        return False
    r_bases = r[~r_gap].tobytes()
    q_bases = q[~q_gap].tobytes()
    if aligner in reference.GLOBAL:
        if r_bases != ref or q_bases != qry:
            return False
    elif r_bases not in ref or q_bases not in qry:
        return False
    return reference.rescore(aligner, scoring, lines[0], lines[2]) == score


def alignment_numbers(aligner: str, scoring: dict, got, pairs,
                      optimal: list[int]) -> dict:
    """score_gap and bad_alignments of one batch's output."""
    have = split_blocks(got)
    gap = 0
    bad = abs(len(have) - len(pairs))
    for k, (block, (ref, qry), best) in enumerate(zip(have, pairs, optimal)):
        num, score, rest = _header(block)
        if num != k:
            bad += 1
            continue
        gap = max(gap, abs(score - best))
        lines = rest.split(b"\n")[:-1]
        if not _valid(aligner, scoring, ref, qry, score, lines):
            bad += 1
    return {"score_gap": gap, "bad_alignments": bad}


def scores_wrong(got, sample: list[int], expected: list[int],
                 pairs: int) -> int:
    """Sampled pairs whose score differs from the reference's, and blocks
    that are not a header and three empty lines."""
    have = split_blocks(got)
    wrong = abs(len(have) - pairs)
    for k, block in enumerate(have[:pairs]):
        num, _, rest = _header(block)
        if num != k or rest != b"\n\n\n":
            wrong += 1
    for k, want in zip(sample, expected):
        if k < len(have) and _header(have[k])[1] != want:
            wrong += 1
    return wrong
