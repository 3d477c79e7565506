"""Local (Smith-Waterman) scores of long HiFi-like pairs through the
engine's main path (LSW, scores only, kernel="auto"), against the
benchmark's plain reference (benchmarks/reference.py), on the CPU.

The pairs are 1,000-1,300 bp, at least 8 bands of 128 query rows, so
`pick_fill` gives every bucket to the band wavefront (B2, the "rowscan"
fill; its plain version here): the path of the `lsw-long16k-scores`
benchmark cell at a size the CPU holds.  Pairs at the configuration's
mutation rates come from the benchmark's own traffic generator.  Planted
pairs (utils/synthetic.py planted_local_pair: no base of the query's
background matches the reference's) put the local best where the band
wavefront hands it down: in an upper band, in the middle of a band, in a
partial bottom band, and tied across two bands or inside a row, where the
first cell in row-major order wins.  Their end cells come from the fill
the engine gives each of its buckets (distributed/sharding.py
fill_sharded).
"""

import sys
from pathlib import Path

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
from tpu_align_torch.utils.synthetic import planted_local_pair  # noqa: E402

CELL = harness.load_cell("lsw-long16k-scores")
SCORING = CELL.config["scoring"]
MUTATION = CELL.config["mutation"]
PARAMS = AlignmentParams(**{k: SCORING[k] for k in
                            ("match", "mismatch", "gap")})
LENGTHS = [1000, 1300]
BAND = 128  # LSW's band rows: it has no 8-row build

# (name, reference length, query length, plants, reference copies, the
# band the best ends in): the query's 1,100 rows are 8 full bands and a
# partial bottom band of 76 rows
PLANTED = [
    ("upper-band", 1200, 1100, [(200, 700, 150)], (), 1),
    ("mid-band", 1200, 1100, [(4 * BAND + 64, 400, 150)], (), 4),
    ("partial-bottom", 1200, 1100, [(1060, 1150, 150)], (), 8),
    # one reference window ends rows 300 and 900 alike: bands 2 and 7
    ("tie-across-bands", 1250, 1100, [(300, 600, 150), (900, 600, 150)],
     (), 2),
    # the window twice in the reference: row 700 ends at two columns
    ("tie-in-a-row", 1250, 1100, [(700, 400, 150)], ((400, 1000, 150),),
     5),
]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spy_fills(monkeypatch):
    """The fill wrapper each bucket goes through, as a list of names."""
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
    return calls


def _engine():
    return AlignmentEngine(Algorithm.LSW, PARAMS, with_traceback=False,
                           kernel=CELL.traffic["kernel"], output="blocks",
                           device="cpu")


def _engine_scores(pairs, monkeypatch):
    """The engine's scores of the pairs, and the fill wrapper each bucket
    went through."""
    calls = _spy_fills(monkeypatch)
    out = _engine().run(PairDataset.from_pairs(pairs))
    return [int(s) for s in out.scores()], calls


def _engine_end_cells(pairs, monkeypatch):
    """Each pair's (score, srow, scol) from the fill the engine gives its
    buckets (fill_sharded, kernel "auto"), in pair order, and the fill
    wrapper each bucket went through."""
    calls = _spy_fills(monkeypatch)
    engine = _engine()
    got = {}
    for b in engine._buckets_of(PairDataset.from_pairs(pairs)):
        outs = sharding.fill_sharded(
            engine.mesh, Algorithm.LSW, PARAMS, b.ref_tokens, b.qry_tokens,
            b.ref_len, b.qry_len, with_traceback=False, kernel="auto")
        score, srow, scol = (torch.cat(o).tolist() for o in outs[:3])
        for k in range(b.num_real):
            got[int(b.pair_ids[k])] = (score[k], srow[k], scol[k])
    return [got[i] for i in range(len(pairs))], calls


def _reference_end_cells(pairs):
    filled = reference.fill("lsw", SCORING, *reference.tokens(pairs, "cpu"),
                            with_dirs=False)
    return list(zip(*(filled[k].tolist() for k in ("score", "srow",
                                                    "scol"))))


@pytest.mark.parametrize("seed", [2**31 + 23, 11, 4_000_000_037])
def test_hifi_pairs_take_the_band_wavefront_and_score_optimally(seed,
                                                                monkeypatch):
    """Seeded pairs at the configuration's mutation rates: every bucket
    on the band wavefront, every score the reference's."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    sizes = traffic.batch_sizes(seed % 89, LENGTHS, 6, MUTATION["insertion"],
                                MUTATION["deletion"])
    pairs = traffic.pairs_of(traffic.mutated_batch(
        traffic.rng_for(seed, 0), gen, sizes, MUTATION["substitution"]))
    assert min(len(q) for _, q in pairs) > \
        (sharding.RULE_MIN_BANDS - 1) * BAND
    got, calls = _engine_scores(pairs, monkeypatch)
    assert calls and set(calls) == {"rowscan"}
    want = reference.scores("lsw", SCORING, pairs, "cpu")
    assert got == want
    assert all(s > 0 for s in want)  # every pair aligns


def _planted_pairs():
    return [planted_local_pair(rlen, qlen, plants, seed=70 + k,
                               ref_copies=copies)
            for k, (_, rlen, qlen, plants, copies, _) in enumerate(PLANTED)]


def test_planted_bests_end_where_planted_in_the_reference():
    """The reference's best ends in the band each case names, at 3 x the
    plant's length; the ties are ties: both cells score the best, and the
    first in row-major order is the one reported."""
    pairs = _planted_pairs()
    want = _reference_end_cells(pairs)
    for (name, _, qlen, plants, _, band), (score, srow, scol) in zip(
            PLANTED, want):
        row, col, length = plants[0]
        assert (score, srow, scol) == (3 * length, row, col), name
        assert (srow - 1) // BAND == band, name
        if name == "partial-bottom":
            assert (srow - 1) // BAND == (qlen - 1) // BAND
            assert qlen % BAND
    # the ties, cell by cell: the later cell (i, j) scores the best too.
    # The pair cut to rows i0 + 1 .. i and columns j0 + 1 .. j, past the
    # first cell's plant, ends at its own last cell with that score
    for name, (i, j), (i0, j0) in (
            ("tie-across-bands", (900, 600), (600, 0)),
            ("tie-in-a-row", (700, 1000), (0, 600))):
        k = [p[0] for p in PLANTED].index(name)
        ref, qry = pairs[k]
        cut = _reference_end_cells([(ref[j0:j], qry[i0:i])])[0]
        assert cut == (want[k][0], i - i0, j - j0), name
        assert (i, j) != want[k][1:] and (i, j) > want[k][1:]
    assert (900 - 1) // BAND == 7 and (700 - 1) // BAND == 5


def test_planted_pairs_score_and_end_as_the_reference(monkeypatch):
    """The planted pairs through the engine on the band wavefront: every
    score the reference's, and through the fill the engine gives each
    bucket, every (score, srow, scol) the reference's, so a tie goes to
    the first band (and the first column) in row-major order."""
    pairs = _planted_pairs()
    want = _reference_end_cells(pairs)
    got, calls = _engine_scores(pairs, monkeypatch)
    assert calls and set(calls) == {"rowscan"}
    assert got == [w[0] for w in want]
    cells, calls = _engine_end_cells(pairs, monkeypatch)
    assert calls and set(calls) == {"rowscan"}
    assert cells == want
