"""Synthetic read-pair workloads (the port's copy of
tpu_align/utils/synthetic.py: the same numbers from the same seed).

The reference benchmarks on the bandedSWA SRR7733443 100k-pair input
(c++/Makefile:4), which is git-LFS-absent; we regenerate statistically
similar workloads: short-read pairs where the query is a mutated copy of
the reference (substitutions + indels), so alignments are biologically
shaped rather than random-vs-random.
"""

from __future__ import annotations

import numpy as np

from tpu_align_torch.io.dataset import PairDataset

_BASES = np.frombuffer(b"ATCG", np.uint8)


def mutate(rng: np.random.Generator, seq: np.ndarray, sub_rate=0.05,
           ins_rate=0.02, del_rate=0.02, bases: np.ndarray = _BASES
           ) -> np.ndarray:
    """Apply substitutions and indels to a uint8 base array.  New bases
    are drawn from `bases` so a reduced alphabet stays reduced (the
    tie-rich property all-paths golden generation relies on)."""
    n = seq.size
    keep = rng.random(n) >= del_rate
    subs = rng.random(n) < sub_rate
    out = seq.copy()
    out[subs] = bases[rng.integers(0, len(bases), int(subs.sum()))]
    out = out[keep]
    n_ins = int(rng.binomial(max(out.size, 1), ins_rate))
    if n_ins:
        pos = np.sort(rng.integers(0, out.size + 1, n_ins))
        out = np.insert(out, pos, bases[rng.integers(0, len(bases), n_ins)])
    return out


def synthetic_dataset(
    num_pairs: int,
    min_len: int = 96,
    max_len: int = 256,
    seed: int = 0,
    sub_rate: float = 0.05,
    indel_rate: float = 0.02,
    uniform_len: int | None = None,
    alphabet: str | None = None,
) -> PairDataset:
    """Generate `num_pairs` (reference, query) read pairs.

    Reference lengths are uniform in [min_len, max_len] (or fixed to
    uniform_len); queries are mutated copies, so their lengths scatter
    around the reference length.  A reduced `alphabet` (e.g. "AT") makes
    co-optimal ties rich (all-paths golden generation).
    """
    bases = np.frombuffer(alphabet.encode(), np.uint8) if alphabet else _BASES
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(num_pairs):
        n = uniform_len or int(rng.integers(min_len, max_len + 1))
        ref = bases[rng.integers(0, len(bases), n)]
        qry = mutate(rng, ref, sub_rate, indel_rate, indel_rate, bases)
        if qry.size == 0:
            qry = bases[rng.integers(0, len(bases), 1)]
        pairs.append((ref.tobytes().decode(), qry.tobytes().decode()))
    return PairDataset.from_pairs(pairs)


def random_dna(rng, lo: int = 1, hi: int = 40, alphabet: str = "ATCG") -> str:
    """A random sequence of rng.randint(lo, hi) letters of `alphabet`
    (rng a random.Random): the tests' random_dna (tests/conftest.py), so a
    fuzz seed draws the same pairs as the JAX package's fuzzers."""
    n = rng.randint(lo, hi)
    return "".join(rng.choice(alphabet) for _ in range(n))


# around the stagger fill's 4-row lanes, 32-column chunks and 128-row bands
SEAM_LENS = (1, 4, 5, 31, 32, 33, 63, 64, 65, 127, 128, 129, 257)
# LSW pairs (reference, query, (score, row, col) of the first best cell in
# row-major order) whose best, 6, ties at a later column of an earlier row:
# rows 5 and 6, which one lane of the stagger fill holds; rows 127 and 130,
# on both sides of its first band seam
SEAM_LSW_TIES = (
    ("G" * 8 + "CA" + "G" * 8 + "AC", "TTT" + "ACA", (6, 5, 20)),
    ("G" * 8 + "CA" + "G" * 38 + "AC" + "G" * 10, "T" * 125 + "ACTCA",
     (6, 127, 50)),
)


def seam_bucket(device):
    """The stagger fill's seams as one bucket on `device`: every
    (reference, query) pair of SEAM_LENS (every other one on "AC"), the
    SEAM_LSW_TIES pairs, a qlen = 0 and an rlen = 0 lane (the last two),
    and padding lanes.  Returns (bucket, [ref, qry, ref_len, qry_len])."""
    import itertools

    from tpu_align_torch.convert import bucket_to_tensors
    from tpu_align_torch.io.bucketing import BucketSpec, bucketize

    rng = np.random.default_rng(31)
    pairs = []
    for k, (r, q) in enumerate(itertools.product(SEAM_LENS, SEAM_LENS)):
        letters = np.array(list("AC" if k % 2 else "ACGT"))
        pairs.append(("".join(rng.choice(letters, r)),
                      "".join(rng.choice(letters, q))))
    pairs += [(ref, qry) for ref, qry, _ in SEAM_LSW_TIES]
    pairs += [("ACGTA", "ACG"), ("ACG", "ACGTA")]
    (b,) = bucketize(PairDataset.from_pairs(pairs),
                     BucketSpec(batch_pairs=len(pairs), query_multiple=384,
                                ref_multiple=384))
    t = list(bucket_to_tensors(b, device))
    t[3][b.num_real - 2] = 0  # qlen = 0
    t[2][b.num_real - 1] = 0  # rlen = 0
    return b, t


def long_run_bucket(device):
    """Long insertion and deletion runs as one bucket on `device`: a
    257-bp reference against queries of 1 to 8 bp (each global path is
    mostly a run of insertions along a few rows) and the reverse (runs of
    deletions down a few columns), random ACGT, then one unrelated
    257 x 257 pair (runs both ways) and padding lanes.  Returns (bucket,
    [ref, qry, ref_len, qry_len])."""
    from tpu_align_torch.convert import bucket_to_tensors
    from tpu_align_torch.io.bucketing import BucketSpec, bucketize

    rng = np.random.default_rng(37)
    letters = np.array(list("ACGT"))

    def seq(n):
        return "".join(rng.choice(letters, n))

    pairs = [p for q in range(1, 9) for p in ((seq(257), seq(q)),
                                               (seq(q), seq(257)))]
    pairs.append((seq(257), seq(257)))
    (b,) = bucketize(PairDataset.from_pairs(pairs),
                     BucketSpec(batch_pairs=len(pairs), query_multiple=384,
                                ref_multiple=384))
    return b, list(bucket_to_tensors(b, device))


# around the row sweep's band wavefront (kernels/fill.py): its 128-row
# bands, its 16-row (ANW: 8-row) direction words and its 32-column chunks
ROWSCAN_SEAM_QLENS = (1, 127, 128, 129, 255, 256, 257)
ROWSCAN_SEAM_RLENS = (1, 31, 32, 33, 65)
# one bucket of every seam and tie pair
ROWSCAN_SEAM_SPEC = {"query_multiple": 264, "ref_multiple": 256}
_TIE_X = "ACCACACCAACACCCA"  # 16 bases of A and C
_TIE_P = "ACCA" * 5  # period 4: _TIE_P[:16] occurs at offsets 0 and 4
# LSW and BSW pairs (reference, query, (score, row, col) of the first best
# cell in row-major order, for LSW and for BSW at band >= 3) whose best
# ties.  G against T never matches, so the best is a whole copy of the
# query's motif.  The first ties at (128, 128), the last row of the
# wavefront's band 0, and (192, 192) in band 1, and for LSW also at
# (128, 192), in one row; the second at columns 127 and 131 of row 129,
# band 1's first row, both 2 from the diagonal.
ROWSCAN_TIES = (
    ("G" * 112 + _TIE_X + "G" * 48 + _TIE_X + "G" * 8,
     "T" * 112 + _TIE_X + "T" * 48 + _TIE_X + "T" * 8, (48, 128, 128)),
    ("G" * 111 + _TIE_P + "G" * 9, "T" * 113 + _TIE_P[:16] + "T" * 19,
     (48, 129, 127)),
)


def rowscan_seam_pairs() -> list[tuple[str, str]]:
    """Every (reference, query) pair of ROWSCAN_SEAM_RLENS x
    ROWSCAN_SEAM_QLENS (every other one on "AC"), then the ROWSCAN_TIES and
    SEAM_LSW_TIES pairs: one bucket under ROWSCAN_SEAM_SPEC."""
    import itertools

    rng = np.random.default_rng(41)
    pairs = []
    for k, (r, q) in enumerate(itertools.product(ROWSCAN_SEAM_RLENS,
                                                 ROWSCAN_SEAM_QLENS)):
        letters = np.array(list("AC" if k % 2 else "ACGT"))
        pairs.append(("".join(rng.choice(letters, r)),
                      "".join(rng.choice(letters, q))))
    return pairs + [(ref, qry) for ref, qry, _ in ROWSCAN_TIES
                    + SEAM_LSW_TIES]


def rowscan_seam_bucket(device):
    """rowscan_seam_pairs as one bucket on `device`, with a qlen = 0 lane
    and two rlen = 0 lanes, of qlen 5 and 257 (three bands, whose local
    bests pass down a chain with no column to wait on), the last three,
    and padding lanes.  Returns (bucket, [ref, qry, ref_len, qry_len])."""
    from tpu_align_torch.convert import bucket_to_tensors
    from tpu_align_torch.io.bucketing import BucketSpec, bucketize

    pairs = rowscan_seam_pairs() + [("ACGTA", "ACG"), ("ACG", "ACGTA"),
                                    ("ACG", "ACGT" * 64 + "A")]
    (b,) = bucketize(PairDataset.from_pairs(pairs),
                     BucketSpec(batch_pairs=len(pairs), **ROWSCAN_SEAM_SPEC))
    t = list(bucket_to_tensors(b, device))
    n = b.num_real
    t[3][n - 3] = 0  # qlen = 0
    t[2][n - 2] = 0  # rlen = 0
    t[2][n - 1] = 0  # rlen = 0, qlen 257
    return b, t


# around the band wavefront's scores step (csrc/rowscan_fill.cu
# fill_band_scores): its 128- and 256-row bands (4 and 8 rows a lane), full
# and partial, its ramps (rlen under 64) and its 32-column chunks
SCORES_STEP_QLENS = (1, 31, 32, 33, 127, 128, 129, 255, 256, 257, 384, 511,
                     512, 513)
SCORES_STEP_RLENS = (1, 31, 32, 33, 63, 64, 65, 96, 97, 160)
# an LSW and BSW tie as the first ROWSCAN_TIES pair's, 128 rows lower: at
# (256, 256), the last row of a 256-row band, and (320, 320)
SCORES_STEP_TIES = (
    ("G" * 240 + _TIE_X + "G" * 48 + _TIE_X + "G" * 8,
     "T" * 240 + _TIE_X + "T" * 48 + _TIE_X + "T" * 8, (48, 256, 256)),
)


def scores_step_pairs() -> list[tuple[bytes, bytes]]:
    """Every (reference, query) pair of SCORES_STEP_RLENS x
    SCORES_STEP_QLENS, random ACGT queries holding a copy of part of their
    reference (so local scores vary), some with codes the scores step's
    profile does not cover: N in the reference (every 5th) or the query
    (every 7th), lowercase a in the reference (every 9th), and the
    bucket's pad codes 0 and 1 inside both sequences (every 11th); then the
    ROWSCAN_TIES, SEAM_LSW_TIES and SCORES_STEP_TIES pairs."""
    import itertools

    rng = np.random.default_rng(47)
    letters = np.frombuffer(b"ACGT", np.uint8)
    pairs = []
    for k, (r, q) in enumerate(itertools.product(SCORES_STEP_RLENS,
                                                 SCORES_STEP_QLENS)):
        ref = letters[rng.integers(0, 4, r)]
        qry = letters[rng.integers(0, 4, q)]
        n = min(r, q) // 2
        if n:  # a copy of part of the reference, 5 % of it substituted
            at, to = rng.integers(0, r - n + 1), rng.integers(0, q - n + 1)
            part = ref[at:at + n].copy()
            hit = rng.random(n) < 0.05
            part[hit] = letters[rng.integers(0, 4, int(hit.sum()))]
            qry[to:to + n] = part
        for every, seq, code in ((5, ref, b"N"), (7, qry, b"N"),
                                 (9, ref, b"a"), (11, ref, b"\x00"),
                                 (11, qry, b"\x01"), (11, ref, b"\x01")):
            if k % every == 0 and seq.size:
                seq[rng.integers(0, seq.size)] = code[0]
        pairs.append((ref.tobytes(), qry.tobytes()))
    return pairs + [(ref.encode(), qry.encode()) for ref, qry, _ in
                    ROWSCAN_TIES + SEAM_LSW_TIES + SCORES_STEP_TIES]


def scores_step_bucket(device):
    """scores_step_pairs as one ragged bucket on `device` (520 padded
    query rows: 5 bands of 128, 3 of 256; 512 columns), with a qlen = 0
    lane and rlen = 0 lanes of qlen 128 and 513 (full and partial bands
    with no column), the last three, and padding lanes.  Returns (bucket,
    [ref, qry, ref_len, qry_len])."""
    from tpu_align_torch.convert import bucket_to_tensors
    from tpu_align_torch.io.bucketing import BucketSpec, bucketize

    pairs = scores_step_pairs() + [(b"ACGTA", b"ACG"), (b"ACG", b"ACGT" * 32),
                                   (b"ACG", b"ACGT" * 128 + b"A")]
    (b,) = bucketize(PairDataset.from_pairs(pairs),
                     BucketSpec(batch_pairs=len(pairs) + 5,
                                query_multiple=520, ref_multiple=512))
    t = list(bucket_to_tensors(b, device))
    n = b.num_real
    t[3][n - 3] = 0  # qlen = 0
    t[2][n - 2] = 0  # rlen = 0, one full band of 128
    t[2][n - 1] = 0  # rlen = 0, qlen 513
    return b, t


def band_run_pairs(runs=(2, 19, 31), flanks=(40, 50)) -> list[tuple[str, str]]:
    """BSW paths that cross word rows and run along the band's edges: for
    each L in runs, a reference with L extra bases between two stretches
    it shares with the query, of flanks bp (a run of L insertions, which
    ends at slot band + L: 2*band - 1 when L = band - 1), and a query with
    L extra bases (a run of L deletions, from slot band - L: slot 1 when
    L = band - 1).  The stretches are random ACG (seed 43) and the extra
    bases T, which match nothing, so each run is one gap, taken where the
    stretches outscore it (3/-1/-2: L < 60 at the default flanks; 150-bp
    flanks take runs of 128)."""
    rng = np.random.default_rng(43)
    letters = np.array(list("ACG"))

    def seq(n):
        return "".join(rng.choice(letters, n))

    pairs = []
    for run in runs:
        a, b = seq(flanks[0]), seq(flanks[1])
        pairs += [(a + "T" * run + b, a + b), (a + b, a + "T" * run + b)]
    return pairs


def wide_band_bucket(band: int, device):
    """band_run_pairs with runs of band - 1 insertions and deletions, to
    the band's edge slots 2*band - 1 and 1, on flanks of 2*band/3 + 400 bp
    (long enough that a run is worth its gap at 3/-1/-2), as one bucket
    of two long pairs on `device`.  Both sides of each pair reach band +
    64 bp, so every slot of the band holds valid cells.  Returns (bucket,
    [ref, qry, ref_len, qry_len])."""
    from tpu_align_torch.convert import bucket_to_tensors
    from tpu_align_torch.io.bucketing import BucketSpec, bucketize

    flank = 2 * band // 3 + 400
    pairs = band_run_pairs(runs=(band - 1,), flanks=(flank, flank))
    width = -(-max(len(r) for r, _ in pairs) // 512) * 512
    (b,) = bucketize(PairDataset.from_pairs(pairs),
                     BucketSpec(batch_pairs=len(pairs), query_multiple=width,
                                ref_multiple=width))
    return b, list(bucket_to_tensors(b, device))


# (K, n, kind) of split-reduction inputs that the CUDA kernel's grid
# splits differently: one subproblem over long rows (a lane of
# subproblems, 256 row pairs a block step), a K that is no multiple of
# its 32-lane groups, row counts that leave the last chunk part full,
# maxima tied across chunks, and widths past the rows
SPLIT_REDUCE_SHAPES = ((1, 5000, "random"), (1, 5000, "ties"),
                       (45, 3001, "random"), (45, 3001, "ties"),
                       (3, 40000, "ties"), (300, 700, "random"),
                       (45, 3001, "past"))


def split_reduce_inputs(k: int, n: int, kind: str = "random",
                        seed: int = 0):
    """Hirschberg split-reduction arguments as numpy int32: last rows H
    and F (n, 2K), fhb, bhb, nn, go (K,).  nn runs over 0..n, 0 at the
    first subproblem and n at the last.  kind "random": values from a
    small set (ties everywhere), 10 % NEG entries, an all-NEG subproblem
    and F rows NEG half the time; "past": the same with widths up to 2n,
    which B's row index clips to the last row; "ties": every B entry -1
    and each
    subproblem's largest total at two rows, a third and two thirds of its
    width, so the earlier of two maxima in different chunks must win."""
    neg = -(2**30)
    rng = np.random.default_rng(seed)
    go = np.full(k, -4, np.int32)
    if kind in ("random", "past"):
        last = rng.integers(-6, 3, (n, 2 * k)).astype(np.int32)
        last[rng.random((n, 2 * k)) < 0.1] = neg
        last[:, 2:4] = neg
        flast = np.where(rng.random((n, 2 * k)) < 0.5, neg,
                         last - 2).astype(np.int32)
        top = n if kind == "random" else 2 * n
        nn = rng.integers(0, top + 1, k).astype(np.int32)
        nn[0], nn[-1] = 0, top
        fhb, bhb = (rng.integers(-5, 1, k).astype(np.int32)
                    for _ in range(2))
        return last, flast, fhb, bhb, nn, go
    if kind != "ties":
        raise ValueError(f"unknown kind {kind!r}")
    nn = rng.integers(0, n + 1, k).astype(np.int32)
    nn[0], nn[-1] = 0, n
    last = np.full((n, 2 * k), -1, np.int32)
    last[:, 0::2] = rng.integers(-6, 0, (n, k))
    for s, w in enumerate(nn):
        for row in (w // 3, 2 * w // 3):
            if row >= 1:  # F(row) = last[row - 1, 2s]
                last[row - 1, 2 * s] = 100
    flast = last.copy()
    fhb = np.full(k, -10, np.int32)
    bhb = np.full(k, -1, np.int32)
    return last, flast, fhb, bhb, nn, go


def main_path_bucket(pairs: int = 2048):
    """A full bucket of the main path's shape: the first bucket of
    2 * pairs synthetic 250-bp pairs (seed 42), pairs lanes of 256 x 256."""
    from tpu_align_torch.io.bucketing import BucketSpec, bucketize

    return bucketize(synthetic_dataset(2 * pairs, uniform_len=250, seed=42),
                     BucketSpec(batch_pairs=pairs))[0]


def planted_local_pair(rlen: int, qlen: int, plants, seed: int,
                       ref_copies=()) -> tuple[bytes, bytes]:
    """A (reference, query) pair whose local best is planted: the
    reference drawn from A and C, the query from G and T (seed), so no
    base of the query's background matches the reference.  Each (src, dst,
    length) of ref_copies first copies reference[src - length:src] over
    reference[dst - length:dst]; each (row, col, length) of plants then
    copies reference[col - length:col] into query[row - length:row], an
    exact match of 3 x length at 3/-1/-2 that ends at cell (row, col).  A
    plant that two rows (or, through a reference copy, two columns) end
    alike is a tie of the local best."""
    rng = np.random.default_rng(seed)
    ref = rng.choice(np.frombuffer(b"AC", np.uint8), rlen)
    qry = rng.choice(np.frombuffer(b"GT", np.uint8), qlen)
    for src, dst, length in ref_copies:
        ref[dst - length:dst] = ref[src - length:src]
    for row, col, length in plants:
        qry[row - length:row] = ref[col - length:col]
    return ref.tobytes(), qry.tobytes()
