"""kernel="auto": the fill distributed/sharding.py `pick_fill` gives each
bucket (each shard's rows on a mesh), on the CPU plain versions.

The band wavefront (B2, the "rowscan" fill) takes a scores-only bucket of
long pairs too few to fill the card one warp a pair; the stagger fill
(B1) every other bucket and every fill with direction words; BSW the
banded fill.  Explicit kernels force as before.  Both fills give the
same scores and start cells, so `auto` and `kernel="stagger"` agree
through the engine.  A CPU shard picks as the H100 would
(sharding.CPU_SMS), so these runs take the card's choices.
"""

import numpy as np
import pytest
import torch

from tpu_align_torch.core.params import Algorithm, AlignmentParams
from tpu_align_torch.distributed import sharding
from tpu_align_torch.distributed.sharding import (
    RULE_MAX_PAIRS_PER_SM,
    RULE_MIN_BANDS,
    make_pairs_mesh,
    pick_fill,
    shard_kernels,
)
from tpu_align_torch.io.dataset import PairDataset
from tpu_align_torch.runtime.engine import AlignmentEngine
from tpu_align_torch.runtime.profiler import PhaseTimer

H100_SMS = 132
# padded query rows of the benchmark's 16 kbp HiFi-like buckets
LONG_ROWS = 16_416
# the shortest query the rule puts on the band wavefront
MIN_LONG_QLEN = (RULE_MIN_BANDS - 1) * 128 + 1


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("algo", [Algorithm.LNW, Algorithm.LSW,
                                  Algorithm.ANW], ids=lambda a: a.value)
@pytest.mark.parametrize("pairs", [1, 2, 549])
def test_long_scores_only_buckets_take_the_band_wavefront(algo, pairs):
    assert pick_fill(algo, False, LONG_ROWS, pairs, H100_SMS) == "rowscan"


@pytest.mark.parametrize("algo", [Algorithm.LNW, Algorithm.LSW,
                                  Algorithm.ANW], ids=lambda a: a.value)
def test_a_full_bucket_of_reads_stays_on_the_stagger_fill(algo):
    assert pick_fill(algo, False, 256, 2048, H100_SMS) == "stagger"


@pytest.mark.parametrize("rows,pairs,want", [
    (MIN_LONG_QLEN + 31, 1, "rowscan"),  # padded to the least band count
    (MIN_LONG_QLEN - 1, 1, "stagger"),  # a band short
    (LONG_ROWS, RULE_MAX_PAIRS_PER_SM * H100_SMS - 1, "rowscan"),
    (LONG_ROWS, RULE_MAX_PAIRS_PER_SM * H100_SMS, "stagger"),  # card full
    (LONG_ROWS, 0, "rowscan"),
])
def test_the_rule_at_its_edges(rows, pairs, want):
    assert pick_fill(Algorithm.LNW, False, rows, pairs, H100_SMS) == want


def test_the_pair_limit_scales_with_the_sms():
    pairs = RULE_MAX_PAIRS_PER_SM * 66
    assert pick_fill(Algorithm.LNW, False, LONG_ROWS, pairs, 66) == "stagger"
    assert pick_fill(Algorithm.LNW, False, LONG_ROWS, pairs, 132) == \
        "rowscan"


@pytest.mark.parametrize("algo", list(Algorithm), ids=lambda a: a.value)
@pytest.mark.parametrize("rows,pairs", [(LONG_ROWS, 1), (LONG_ROWS, 549),
                                        (256, 2048)])
def test_dirs_fills_and_bsw_keep_their_kernel(algo, rows, pairs):
    want = "banded" if algo.is_banded else "stagger"
    assert pick_fill(algo, True, rows, pairs, H100_SMS) == want
    if algo.is_banded:
        assert pick_fill(algo, False, rows, pairs, H100_SMS) == "banded"


@pytest.mark.parametrize("kernel", ["stagger", "rowscan"])
def test_an_explicit_kernel_still_forces(kernel):
    mesh = make_pairs_mesh(["cpu"] * 2)
    for rows, lens in ((LONG_ROWS, [16_384, 0] * 8), (256, [250] * 4096)):
        lens = np.array(lens, np.int32)
        for tb in (False, True):
            assert shard_kernels(mesh, Algorithm.LNW, tb, kernel, rows,
                                 lens, lens) == [kernel, kernel]
            assert shard_kernels(mesh, Algorithm.BSW, tb, kernel, rows,
                                 lens, lens) == ["banded", "banded"]


def test_an_unknown_kernel_is_refused():
    mesh = make_pairs_mesh(["cpu"])
    lens = np.ones(8, np.int32)
    with pytest.raises(ValueError, match="unknown kernel"):
        shard_kernels(mesh, Algorithm.LNW, False, "wavefront", 32, lens,
                      lens)


def test_each_shard_picks_from_its_own_real_pairs():
    """On a mesh the rule reads each shard's real pairs (both sides
    non-empty; padding rows have none): a shard that holds many long
    pairs takes the stagger fill, a shard of a few the wavefront."""
    mesh = make_pairs_mesh(["cpu"] * 2)
    many = RULE_MAX_PAIRS_PER_SM * sharding.CPU_SMS
    ref = np.zeros(2 * many, np.int32)
    qry = np.zeros(2 * many, np.int32)
    ref[:many] = qry[:many] = 16_384  # shard 0: full
    ref[many:many + 3] = qry[many:many + 3] = 16_384  # shard 1: 3 real
    qry[many + 3:many + 10] = 16_384  # reference empty: not a real pair
    assert shard_kernels(mesh, Algorithm.LNW, False, "auto", LONG_ROWS,
                         ref, qry) == ["stagger", "rowscan"]
    assert shard_kernels(mesh, Algorithm.LNW, True, "auto", LONG_ROWS,
                         ref, qry) == ["stagger", "stagger"]


def _dataset(seed: int = 3) -> PairDataset:
    """Long pairs in buckets of 1 and 2 (queries not a multiple of 128
    rows), short pairs in their own buckets, and a pair with each side
    empty."""
    rng = np.random.default_rng(seed)

    def seq(n):
        return "".join(rng.choice(list("ACGT"), n))

    long_q = MIN_LONG_QLEN + 104  # padded to 32 rows: one bucket alone
    pairs = [(seq(long_q + 9), seq(long_q)),
             (seq(long_q + 200), seq(long_q + 137)),
             (seq(long_q + 190), seq(long_q + 140)),
             (seq(90), seq(100)), (seq(40), seq(33)),
             ("", seq(20)), (seq(20), ""), (seq(64), seq(70))]
    return PairDataset.from_pairs(pairs)


def _spy(monkeypatch):
    """Record which fill wrapper fill_sharded calls."""
    calls = []

    def wrap(name, real):
        def fill(*args, **kwargs):
            calls.append(name)
            return real(*args, **kwargs)
        return fill

    monkeypatch.setattr(sharding, "fill_stagger_bucket_async",
                        wrap("stagger", sharding.fill_stagger_bucket_async))
    monkeypatch.setattr(sharding.rowscan, "fill_bucket_async",
                        wrap("rowscan", sharding.rowscan.fill_bucket_async))
    monkeypatch.setattr(sharding, "fill_banded_bucket_async",
                        wrap("banded", sharding.fill_banded_bucket_async))
    return calls


@pytest.mark.parametrize("algo", [Algorithm.LNW, Algorithm.LSW,
                                  Algorithm.ANW], ids=lambda a: a.value)
def test_auto_equals_the_stagger_fill_through_the_engine(algo, monkeypatch):
    """Each bucket's scores, start rows and start columns, and the run's
    records, equal between kernel="auto" and kernel="stagger"; under
    auto the 1- and 2-pair buckets of long pairs went to the band
    wavefront, the short ones to the stagger fill."""
    ds = _dataset()
    params = AlignmentParams()
    auto, stagger = (AlignmentEngine(algo, params, device="cpu",
                                     with_traceback=False, kernel=k)
                     for k in ("auto", "stagger"))
    calls = _spy(monkeypatch)
    picks = []  # (real pairs, long?, auto's fill, stagger's fill)
    for b in auto._buckets_of(ds):
        got = []
        for engine in (auto, stagger):
            del calls[:]
            timer = PhaseTimer()
            got.append(engine._wait_fill(engine._dispatch(b, timer), timer))
            got[-1] = got[-1][:3] + (calls[0],)
        for field in range(3):
            np.testing.assert_array_equal(
                np.asarray(got[0][field])[:b.num_real],
                np.asarray(got[1][field])[:b.num_real])
        picks.append((b.num_real, b.qry_tokens.shape[1] >= MIN_LONG_QLEN,
                      got[0][3], got[1][3]))
    assert sorted(n for n, long, _, _ in picks if long) == [1, 2]
    assert all(a == ("rowscan" if long else "stagger") and s == "stagger"
               for _, long, a, s in picks)
    runs = [[(r.pair_num, r.score) for r in e.run(ds).results]
            for e in (auto, stagger)]
    assert runs[0] == runs[1]
    assert len(runs[0]) == len(ds)


@pytest.mark.parametrize("algo,traceback", [
    (Algorithm.LNW, "host"), (Algorithm.LSW, "device"),
    (Algorithm.BSW, "host")], ids=lambda v: getattr(v, "value", v))
def test_dirs_paths_take_the_stagger_or_banded_fill(algo, traceback,
                                                    monkeypatch):
    """A traceback run under auto on the long 1-pair bucket fills it as
    the parent did: stagger (banded for BSW), never the wavefront."""
    ds = _dataset()
    engine = AlignmentEngine(algo, device="cpu", traceback=traceback)
    long_one = next(b for b in engine._buckets_of(ds)
                    if b.num_real == 1 and b.qry_tokens.shape[1] >= 896)
    calls = _spy(monkeypatch)
    engine._dispatch(long_one, PhaseTimer())
    assert calls == ["banded" if algo.is_banded else "stagger"]


def test_warmup_takes_each_shape_and_kernel(monkeypatch):
    """warmup fills one bucket of each (shape, kernel): both kernels
    where auto splits one dataset between them."""
    ds = _dataset()
    engine = AlignmentEngine(Algorithm.LNW, device="cpu",
                             with_traceback=False)
    calls = _spy(monkeypatch)
    engine.warmup(ds)
    assert set(calls) == {"stagger", "rowscan"}
    assert len(calls) == len(engine._buckets_of(ds))
