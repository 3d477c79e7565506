"""Affine-gap (Gotoh) global scores of long HiFi-like pairs through the
engine's main path (ANW, scores only, kernel="auto"), against the
benchmark's plain reference (benchmarks/reference.py), on the CPU.

The pairs are 1,000-1,300 bp, at least 8 bands of 128 query rows, so
`pick_fill` gives every bucket to the band wavefront (B2, the "rowscan"
fill; its plain version here): the path of the `anw-long16k-scores`
benchmark cell at a size the CPU holds.  Pairs at the configuration's
mutation rates come from the benchmark's own traffic generator; pairs
with 40-200 bp indels score differently under any linear gap cost, so a
fill that lost E's or F's extension would fail them.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmarks import harness, reference, traffic  # noqa: E402
from tpu_align_torch import Algorithm, AlignmentParams  # noqa: E402
from tpu_align_torch.distributed import sharding  # noqa: E402
from tpu_align_torch.io import PairDataset  # noqa: E402
from tpu_align_torch.runtime.engine import AlignmentEngine  # noqa: E402

CELL = harness.load_cell("anw-long16k-scores")
SCORING = CELL.config["scoring"]
MUTATION = CELL.config["mutation"]
LENGTHS = [1000, 1300]
BASES = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _engine_scores(pairs, monkeypatch):
    """The engine's scores of the pairs, and the fill wrapper each bucket
    went through."""
    calls = []

    def spy(name, real):
        def fill(*args, **kwargs):
            calls.append(name)
            return real(*args, **kwargs)
        return fill

    monkeypatch.setattr(sharding, "fill_stagger_bucket_async",
                        spy("stagger", sharding.fill_stagger_bucket_async))
    monkeypatch.setattr(sharding.rowscan, "fill_bucket_async",
                        spy("rowscan", sharding.rowscan.fill_bucket_async))
    params = AlignmentParams(**{k: SCORING[k] for k in
                                ("match", "mismatch", "gap_open",
                                 "gap_extend")})
    engine = AlignmentEngine(Algorithm.ANW, params, with_traceback=False,
                             kernel=CELL.traffic["kernel"], output="blocks",
                             device="cpu")
    out = engine.run(PairDataset.from_pairs(pairs))
    return [int(s) for s in out.scores()], calls


def _seq(rng, n):
    return BASES[rng.integers(0, 4, n)].tobytes()


def _long_indel_pairs(seed, kind, n=4):
    """Pairs whose query loses ("deletion") or gains ("insertion") one or
    two runs of 40-200 bases, with a few substitutions."""
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(n):
        ref = bytearray(_seq(rng, int(rng.integers(*LENGTHS))))
        qry = bytearray(ref)
        for k in rng.choice(len(qry), 8, replace=False):
            qry[k] = BASES[rng.integers(0, 4)]
        for _ in range(int(rng.integers(1, 3))):
            run = int(rng.integers(40, 201))
            at = int(rng.integers(1, len(qry) - run))
            if kind == "deletion":
                del qry[at:at + run]
            else:
                qry[at:at] = _seq(rng, run)
        pairs.append((bytes(ref), bytes(qry)))
    return pairs


@pytest.mark.parametrize("seed", [2**31 + 19, 7, 4_000_000_019])
def test_hifi_pairs_take_the_band_wavefront_and_score_optimally(seed,
                                                                monkeypatch):
    """Seeded pairs at the configuration's mutation rates: every bucket
    on the band wavefront, every score the reference's."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    sizes = traffic.batch_sizes(seed % 97, LENGTHS, 6, MUTATION["insertion"],
                                MUTATION["deletion"])
    pairs = traffic.pairs_of(traffic.mutated_batch(
        traffic.rng_for(seed, 0), gen, sizes, MUTATION["substitution"]))
    assert min(len(q) for _, q in pairs) > \
        (sharding.RULE_MIN_BANDS - 1) * 128
    got, calls = _engine_scores(pairs, monkeypatch)
    assert calls and set(calls) == {"rowscan"}
    assert got == reference.scores("anw", SCORING, pairs, "cpu")


@pytest.mark.parametrize("kind", ["deletion", "insertion"])
def test_long_indels_score_with_affine_gaps(kind, monkeypatch):
    """40-200 bp gaps: the engine's scores are the reference's affine
    ones, and differ on every pair from the linear scores at the open
    plus extend cost (a fill that never extends) and at the extend cost
    alone (a fill that never opens)."""
    pairs = _long_indel_pairs(31 if kind == "deletion" else 37, kind)
    got, calls = _engine_scores(pairs, monkeypatch)
    assert calls and set(calls) == {"rowscan"}
    want = reference.scores("anw", SCORING, pairs, "cpu")
    assert got == want
    for gap in (SCORING["gap_open"] + SCORING["gap_extend"],
                SCORING["gap_extend"]):
        linear = reference.scores("lnw", {**SCORING, "gap": gap}, pairs,
                                  "cpu")
        assert all(a != b for a, b in zip(want, linear)), (gap, want, linear)
