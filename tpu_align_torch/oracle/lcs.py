"""Longest common subsequence: the no-penalty special case of NW (the
port's copy of tpu_align/oracle/lcs.py).

Behavioral spec: python/LongestCommonSubsequence.py (the reference's fifth
pedagogical aligner): fill Memo[i][j] = diag+1 on match else max(up, left)
(:41-51), then BFS-enumerate every co-optimal subsequence from the
bottom-right corner, branching BOTH ways on up/left ties (:95-110 --
"DELIBERATELY 2 IF STATEMENTS").  Enumeration order follows the reference's
breadth-first queue; duplicates arise from converging paths exactly as they
do there (dedup=True collapses them while preserving first-seen order).
"""

from __future__ import annotations

from collections import deque

import numpy as np


def lcs_matrix(reference: str, query: str) -> np.ndarray:
    """(len(query)+1, len(reference)+1) int32 LCS-length DP matrix."""
    q = np.frombuffer(query.encode("latin-1"), np.uint8)
    r = np.frombuffer(reference.encode("latin-1"), np.uint8)
    m, n = len(q), len(r)
    memo = np.zeros((m + 1, n + 1), np.int32)
    for i in range(1, m + 1):
        eq = q[i - 1] == r
        up = memo[i - 1, 1:]
        diag = memo[i - 1, :-1] + 1
        row = memo[i]
        for j in range(1, n + 1):  # left dependency is a running max
            row[j] = diag[j - 1] if eq[j - 1] else max(up[j - 1], row[j - 1])
    return memo


def lcs(reference: str, query: str, all_paths: bool = True,
        dedup: bool = False) -> tuple[int, list[str]]:
    """Return (lcs_length, subsequences).

    all_paths=True enumerates every co-optimal subsequence in the
    reference's BFS order; all_paths=False returns just the first.
    """
    memo = lcs_matrix(reference, query)
    length = int(memo[-1, -1])
    out: list[str] = []
    queue = deque([(len(reference), len(query), "")])
    while queue:
        c, r, acc = queue.popleft()
        if c != 0 and r != 0:
            if reference[c - 1] == query[r - 1]:
                queue.append((c - 1, r - 1, reference[c - 1] + acc))
                continue
            # branch both ways on ties (reference :95-110)
            if memo[r, c - 1] >= memo[r - 1, c]:
                queue.append((c - 1, r, acc))
            if memo[r, c - 1] <= memo[r - 1, c]:
                queue.append((c, r - 1, acc))
        else:
            out.append(acc)
            if not all_paths:
                break
    if dedup:
        seen = set()
        out = [s for s in out if not (s in seen or seen.add(s))]
    return length, out
