"""The plain reference against the program's oracle and its CPU engine,
in every cell's mode."""

import numpy as np
import pytest
import torch

from benchmarks import checks, reference, traffic
from benchmarks.tests.conftest import TINY, cpu_run, tiny_cell

SCORING = dict(match=3, mismatch=-1, gap=-2, gap_open=-4, gap_extend=-1,
               band=4)
ALIGNERS = ("lnw", "lsw", "bsw", "anw")


def _random_pairs(seed, alphabet, n=40, hi=30):
    rng = np.random.default_rng(seed)
    a = np.frombuffer(alphabet.encode(), np.uint8)
    return [(a[rng.integers(0, len(a), int(rng.integers(1, hi)))].tobytes(),
             a[rng.integers(0, len(a), int(rng.integers(1, hi)))].tobytes())
            for _ in range(n)]


@pytest.mark.parametrize("alphabet", ["ACGT", "AC"])
@pytest.mark.parametrize("aligner", ALIGNERS)
def test_blocks_and_scores_equal_the_oracle(aligner, alphabet):
    from tpu_align_torch import Algorithm, AlignmentParams
    from tpu_align_torch.oracle.api import align_pair

    pairs = _random_pairs(len(alphabet) * 7 + len(aligner), alphabet)
    params = AlignmentParams(**SCORING)
    want = [align_pair(Algorithm(aligner), params, r.decode(), q.decode(),
                       pair_num=k) for k, (r, q) in enumerate(pairs)]
    got, counts = reference.blocks(aligner, SCORING, pairs, "cpu")
    assert got == [w.block().encode() for w in want]
    assert counts["moves"] == sum(len(w.relation) for w in want)
    assert counts["gaps"] == sum(w.relation.count(" ") for w in want)
    assert reference.scores(aligner, SCORING, pairs, "cpu") == \
        [w.score for w in want]


@pytest.mark.parametrize("name", sorted(TINY))
def test_each_cell_on_the_cpu_engine_is_correct(name, bench):
    res = cpu_run(tiny_cell(name), bench)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert all(v["value"] == 0 for v in res["checks"].values())


@pytest.mark.parametrize("aligner", ["lnw", "lsw", "anw"])
def test_hirschberg_blocks_are_co_optimal(aligner):
    from tpu_align_torch import Algorithm, AlignmentParams
    from tpu_align_torch.io import PairDataset
    from tpu_align_torch.runtime.engine import AlignmentEngine

    gen = torch.Generator()
    gen.manual_seed(3)
    sizes = traffic.batch_sizes(3, [150, 400], 4, 0.02, 0.02)
    batch = traffic.mutated_batch(traffic.rng_for(3, 0), gen, sizes, 0.05)
    pairs = traffic.pairs_of(batch)
    engine = AlignmentEngine(Algorithm(aligner), AlignmentParams(),
                             traceback="hirschberg", output="blocks",
                             device="cpu")
    out = engine.run(PairDataset(*batch))
    scoring = dict(match=3, mismatch=-1, gap=-2, gap_open=-4, gap_extend=-1,
                   band=16)
    best = reference.scores(aligner, scoring, pairs, "cpu")
    assert [int(s) for s in out.scores()] == best
    numbers = checks.alignment_numbers(aligner, scoring, out.blocks, pairs,
                                       best)
    assert numbers == {"score_gap": 0, "bad_alignments": 0}


def test_the_co_optimality_check_refuses_a_worse_alignment():
    scoring = dict(match=3, mismatch=-1, gap=-2, gap_open=-4, gap_extend=-1,
                   band=16)
    pairs = [(b"ACGTACGT", b"ACGTTCGT")]
    block = b"0 | 20\nACGTACGT\n****|***\nACGTTCGT\n"
    assert checks.alignment_numbers("lnw", scoring, block, pairs, [20]) == \
        {"score_gap": 0, "bad_alignments": 0}
    worse = b"0 | 20\nACGTA_CGT\n**** ***\nACGT_TCGT\n"
    assert checks.alignment_numbers("lnw", scoring, worse, pairs, [20])[
        "bad_alignments"] == 1
    wrong_bases = b"0 | 20\nACGTACGT\n****|***\nACGTTCGA\n"
    assert checks.alignment_numbers("lnw", scoring, wrong_bases, pairs,
                                    [20])["bad_alignments"] == 1
    lower = b"0 | 18\nACGTACGT\n****|***\nACGTTCGT\n"
    assert checks.alignment_numbers("lnw", scoring, lower, pairs, [20])[
        "score_gap"] == 2


def test_blocks_wrong_counts_pairs():
    expected = [b"0 | 1\nA\n*\nA\n", b"1 | 1\nC\n*\nC\n", b"2 | 1\nG\n*\nG\n"]
    assert checks.blocks_wrong(b"".join(expected), expected) == 0
    assert checks.blocks_wrong(b"".join(expected[:2]), expected) == 1
    bad = expected[0] + b"1 | 2\nC\n*\nC\n" + expected[2]
    assert checks.blocks_wrong(bad, expected) == 1
