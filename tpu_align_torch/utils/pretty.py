"""ANSI DP-matrix pretty printer (the pedagogical visualization layer;
the port's copy of tpu_align/utils/pretty.py).

Parity with python/SequenceAligner.py:17-51: reference characters across the
top in red, query characters down the left in green, 3-wide cells.  Works on
any FillResult (oracle or kernel-unpacked matrices).
"""

from __future__ import annotations

import numpy as np

RED = "\033[31m"
GREEN = "\033[32m"
RESET = "\033[0m"


def format_matrix(
    matrix: np.ndarray,
    reference: str,
    query: str,
    title: str = "Memo Matrix",
    color: bool = True,
) -> str:
    """Render an (m+1, n+1) DP matrix with sequence rulers."""
    red, green, reset = (RED, GREEN, RESET) if color else ("", "", "")
    lines = [
        "=" * 44,
        f"{title} {red}REFERENCE {green}QUERY{reset}",
        "-" * 44,
        "",
        red + "      " + "".join(f"{ch:>5}" for ch in reference) + reset,
    ]
    mat = np.asarray(matrix)
    # cell width fits the widest value (affine E/F borders hold the
    # ~-2.5e8 neg sentinel, which is 10 chars -- fixed 5 misaligned them)
    w = max(5, max((len(str(int(v))) for v in mat.reshape(-1)), default=1))
    if w > 5:
        lines[-1] = (red + " " * (w + 1)
                     + "".join(f"{ch:>{w}}" for ch in reference) + reset)
    for i, row in enumerate(mat):
        label = " " if i == 0 else query[i - 1]
        cells = "".join(f"{int(v):{w}d}" for v in row)
        lines.append(f"{green}{label}{reset}{cells}")
    lines += ["", "=" * 44]
    return "\n".join(lines)


def print_fill(fill, reference: str, query: str, color: bool = True) -> None:
    """Print all matrices of a FillResult (H, and E/F for affine)."""
    print(format_matrix(fill.h, reference, query, "Scoring Matrix", color))
    if fill.e is not None:
        print(format_matrix(fill.e, reference, query,
                            "Query-Insertion Matrix (E)", color))
    if fill.f is not None:
        print(format_matrix(fill.f, reference, query,
                            "Query-Deletion Matrix (F)", color))
