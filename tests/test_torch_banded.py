"""The port's banded fill (BSW) and banded walk against the JAX package's.

The same bucket goes through tpu_align.kernels.banded.fill_banded_bucket
(the Pallas kernel in interpret mode, as the JAX tests run it on CPU) and
through tpu_align_torch's wrapper on CPU tensors (its plain PyTorch
version), at bands 1, 3, 16, 20 and 32, with weights under which a
deletion can win at the band's edge, at bands 3 and 4, and on a few short
pairs at bands 14,528 and 14,529 (K8 = 29,056, the widest frame whose
slots fit one warp's shared memory in the CUDA fill, and 29,064, the
first past it, whose slots live in a global scratch).  The walk runs
from the JAX fill's dirs through both packages: tpu_align's Pallas
banded walker (interpret mode) and its XLA walker _device_walk_banded,
against the port's plain walk.  Integer work, so every comparison is
exact: scores, start cells, the code at every valid cell, per-lane move
sequences, events and replayed alignments.  Each package builds its own
dataset, bucket and parameters from the same pairs and values; only
numpy arrays pass between them.
"""

import dataclasses
import random

import numpy as np
import pytest
import torch

import tpu_align.core.params as jp
import tpu_align.io as jio
from tpu_align.kernels import banded as jb
from tpu_align.traceback import device as jd
from tpu_align.traceback.host import traceback_bucket as jax_traceback
from tpu_align_torch import Algorithm, AlignmentParams
from tpu_align_torch.convert import bucket_to_tensors, fill_to_numpy
from tpu_align_torch.core import directions as D
from tpu_align_torch.io import BucketSpec, PairDataset, bucketize
from tpu_align_torch.native import available
from tpu_align_torch.utils.synthetic import band_run_pairs, synthetic_dataset
from tpu_align_torch.kernels import banded as tb
from tpu_align_torch.traceback import device as td
from tpu_align_torch.traceback import walk_kernel as wk
from tpu_align_torch.traceback.host import traceback_bucket
from tests.conftest import random_dna
from tests.test_torch_walk import assert_same_replay, jax_replay  # noqa: F401

BSW = Algorithm.BSW
JAX_BSW = jp.Algorithm.BSW
# weights under which dele = 0 + gap can beat mm and ins at the band's
# last slot, so the K8 edge rule shows in the codes
ALT = {"mismatch": -3, "gap": -1}
CASES = {
    "band1": AlignmentParams(band=1),
    "band3": AlignmentParams(band=3),
    "band16": AlignmentParams(band=16),
    # K8 = 40 and 64: two slots a lane in the CUDA fill
    "band20": AlignmentParams(band=20),
    "band32": AlignmentParams(band=32),
    "band3-alt": AlignmentParams(band=3, **ALT),
    "band4-alt": AlignmentParams(band=4, **ALT),
    # K8 = 29,056 and 29,064: the CUDA fill's slots in shared memory, then
    # in a global scratch; on the WIDE_PAIRS bucket
    "band14528": AlignmentParams(band=14528),
    "band14529": AlignmentParams(band=14529),
}
WIDE = ("band14528", "band14529")
_rng = random.Random(0xB5)
_mutated = synthetic_dataset(20, min_len=20, max_len=70, seed=5)
PAIRS = (
    [_mutated.pair(k) for k in range(len(_mutated))]
    + [("A", "A"), ("A", "T"), ("AAAA", "TTTT"), ("ACGTACGTACGT", "ACG"),
       ("ACG", "ACGTACGTACGT"), ("A" * 100, "A" * 70),
       ("ACGT" * 12, "ACGT" * 12)]
    + [(random_dna(_rng, 2, 40, "AC"), random_dna(_rng, 2, 40, "AC"))
       for _ in range(15)]
    + [(random_dna(_rng, 1, 70), random_dna(_rng, 1, 70)) for _ in range(10)]
)
# a few short pairs for the WIDE bands, whose frames hold 29 k slots a
# row: the JAX fill in interpret mode takes seconds a row bucket of 16
WIDE_PAIRS = [p for p in PAIRS if max(map(len, p)) <= 32][:8]
# one bucket shape a set of pairs, so the JAX side compiles one shape per
# band
SPEC = dict(batch_pairs=64, query_multiple=128, ref_multiple=128)
BUCKETS = {"narrow": (PAIRS, SPEC),
           "wide": (WIDE_PAIRS, dict(batch_pairs=len(WIDE_PAIRS),
                                     query_multiple=32, ref_multiple=32))}


def _kind(case):
    """The bucket a case runs on."""
    return "wide" if case in WIDE else "narrow"


def _jax(params):
    """The JAX package's AlignmentParams of the same values."""
    return jp.AlignmentParams(**dataclasses.asdict(params))


@pytest.fixture(scope="module")
def buckets():
    out = {}
    for kind, (pairs, spec) in BUCKETS.items():
        (b,) = bucketize(PairDataset.from_pairs(pairs), BucketSpec(**spec))
        assert b.num_real == len(pairs)
        out[kind] = b
    return out


@pytest.fixture(scope="module")
def jax_buckets():
    """The same pairs through the JAX package's own bucketize."""
    out = {}
    for kind, (pairs, spec) in BUCKETS.items():
        (out[kind],) = jio.bucketize(jio.PairDataset.from_pairs(pairs),
                                     jio.BucketSpec(**spec))
    return out


@pytest.fixture(scope="module")
def bucket(buckets):
    return buckets["narrow"]


@pytest.fixture(scope="module")
def jax_bucket(jax_buckets):
    return jax_buckets["narrow"]


@pytest.fixture(scope="module")
def jax_fills(jax_buckets):
    out = {}
    for name, p in CASES.items():
        b = jax_buckets[_kind(name)]
        out[name] = jb.fill_banded_bucket(_jax(p), b.ref_tokens,
                                          b.qry_tokens, b.ref_len, b.qry_len)
    return out


@pytest.fixture(scope="module")
def port_fills(buckets):
    tensors = {kind: bucket_to_tensors(b, "cpu")
               for kind, b in buckets.items()}
    return {name: tb.fill_banded_bucket(BSW, p, *tensors[_kind(name)])
            for name, p in CASES.items()}


def _codes(fill, bucket, band):
    n = bucket.num_real
    return tb.defined_codes(torch.from_numpy(np.array(fill.dirs)[:, :n]),
                            torch.from_numpy(bucket.ref_len[:n]),
                            torch.from_numpy(bucket.qry_len[:n]), band)


@pytest.mark.parametrize("case", CASES)
def test_scores_and_start_cells_match_jax(buckets, jax_fills, port_fills,
                                          case):
    """The best cell, first in row-major order; all 0 when no cell scores
    above 0."""
    n = buckets[_kind(case)].num_real
    want, got = jax_fills[case], port_fills[case]
    for field in ("scores", "start_row", "start_col"):
        np.testing.assert_array_equal(getattr(got, field)[:n],
                                      np.asarray(getattr(want, field))[:n],
                                      err_msg=field)


def test_scores_only_matches_jax(bucket, jax_fills):
    params = CASES["band16"]
    got = tb.fill_banded_bucket(BSW, params,
                                *bucket_to_tensors(bucket, "cpu"),
                                with_traceback=False)
    assert got.dirs is None and got.band == params.band
    n = bucket.num_real
    np.testing.assert_array_equal(got.scores[:n],
                                  np.asarray(jax_fills["band16"].scores)[:n])


@pytest.mark.parametrize("case", CASES)
def test_dirs_match_jax_at_valid_cells(buckets, jax_fills, port_fills, case):
    band = CASES[case].band
    bucket = buckets[_kind(case)]
    want, got = jax_fills[case], port_fills[case]
    assert got.dirs.shape == np.asarray(want.dirs).shape
    assert got.dirs.shape[2] == tb.frame_width(band) == jb.frame_width(band)
    codes = _codes(got, bucket, band)
    assert torch.equal(codes, _codes(want, bucket, band))
    assert int((codes >= 0).sum()) > 0


@pytest.mark.parametrize("band,trap", [(4, True), (3, False)],
                         ids=["K8=2band", "K8>2band"])
def test_edge_slot_up_neighbour(bucket, jax_fills, port_fills, band, trap):
    """banded.py fills the last slot's up neighbour with -inf: when K8 ==
    2*band the band's edge slot 2*band-1 never takes a deletion; when K8 >
    2*band it reads the invalid slot 2*band as H = 0, and a deletion can
    win there.  Both packages agree either way."""
    case = f"band{band}-alt"
    edge = 2 * band - 1
    for fill in (port_fills[case], jax_fills[case]):
        codes = _codes(fill, bucket, band)[:, edge]
        dels = int((codes == D.MAIN_QUERY_DELETION).sum())
        assert (dels == 0) if trap else (dels > 0)


@pytest.mark.parametrize("first_word", [0, 1, 3])
def test_defined_codes_of_word_slices(bucket, port_fills, first_word):
    """Word rows from first_word on decode to those rows of the whole
    decode, so a wide frame's codes can be compared a slice at a time."""
    n = bucket.num_real
    dirs = torch.from_numpy(np.array(port_fills["band16"].dirs)[:, :n])
    lens = (torch.from_numpy(bucket.ref_len[:n]),
            torch.from_numpy(bucket.qry_len[:n]), 16)
    whole = tb.defined_codes(dirs, *lens)
    part = tb.defined_codes(dirs[first_word:first_word + 2], *lens,
                            first_word=first_word)
    assert torch.equal(part, whole[16 * first_word:16 * (first_word + 2)])
    assert int((part >= 0).sum()) > 0


@pytest.mark.parametrize("band,k8", [(1, 8), (3, 8), (4, 8), (5, 16),
                                     (16, 32), (14528, 29056),
                                     (14529, 29064)])
def test_frame_width(band, k8):
    assert tb.frame_width(band) == jb.frame_width(band) == k8


def _tensors(fill):
    return tuple(torch.from_numpy(np.array(x, np.int32)) for x in (
        fill.scores, fill.start_row, fill.start_col, fill.dirs))


def _seqs(packed, steps, nb, unpack=jd.unpack_moves):
    codes = unpack(np.asarray(packed), steps)
    return [tuple(int(c) for c in codes[:, k] if c) for k in range(nb)]


@pytest.fixture(scope="module")
def jax_walks(buckets, jax_fills):
    out = {}
    for case, fill in jax_fills.items():
        nb = buckets[_kind(case)].num_real
        params = CASES[case]
        sc, sr, sj, dirs = (np.asarray(x) for x in (
            fill.scores, fill.start_row, fill.start_col, fill.dirs))
        seqs = {}
        for walker in ("pallas", "xla"):
            packed, steps = jd.device_traceback_moves(
                JAX_BSW, _jax(params), dirs, sr, sj, sc, 32, walker=walker)
            seqs[walker] = _seqs(packed, steps, nb)
        handle = jd.device_walk_dispatch_events(
            JAX_BSW, _jax(params), dirs, sr, sj, sc, 32, walker="pallas",
            extras=(sc, sr, sj))
        out[case] = {"seqs": seqs, "fin": jd.finalize_any(handle)}
    return out


@pytest.fixture(scope="module")
def port_walks(buckets, jax_fills):
    out = {}
    for case, fill in jax_fills.items():
        nb = buckets[_kind(case)].num_real
        params = CASES[case]
        sc, sr, sj, dirs = _tensors(fill)
        walk = wk.device_walk(BSW, params, dirs, sr, sj, sc, 32)
        handle = td.device_walk_dispatch_events(
            BSW, params, dirs, sr, sj, sc, 32, extras=(sc, sr, sj))
        steps = td.walk_steps(BSW, params, dirs.shape)
        out[case] = {"walk": walk, "fin": td.finalize_any(handle),
                     "seqs": _seqs(walk[0].numpy(), steps, nb,
                                   td.unpack_moves)}
    return out


@pytest.mark.parametrize("walker", ["pallas", "xla"])
@pytest.mark.parametrize("case", CASES)
def test_walk_moves_match_jax(jax_walks, port_walks, case, walker):
    """Per-lane move sequences of the port's plain banded walk equal
    device_walk_pallas_banded's and _device_walk_banded's."""
    assert port_walks[case]["seqs"] == jax_walks[case]["seqs"][walker]


@pytest.mark.parametrize("case", CASES)
def test_finalized_walk_matches_jax(buckets, jax_walks, port_walks, case):
    """The mode both packages take -- events, except band 3 with the alt
    weights, whose busiest lane has 36 events, past ev_max = 32, and the
    WIDE bands, whose path bound 2M + band - 1 passes 2**12 -- and in it
    equal nev and flat[:total] or moves; start cells and scores."""
    nb = buckets[_kind(case)].num_real
    got, want = port_walks[case]["fin"], jax_walks[case]["fin"]
    assert got[0] == want[0] == ("stream" if case == "band3-alt"
                                 or case in WIDE else "events")
    for g, w in zip(got[3:], want[3:]):
        np.testing.assert_array_equal(g[:nb], np.asarray(w)[:nb])
    if got[0] == "events":
        nev = np.asarray(got[2])[:nb]
        np.testing.assert_array_equal(nev, np.asarray(want[2])[:nb])
        total = int(nev.sum())
        np.testing.assert_array_equal(got[1][:total], want[1][:total])
    else:
        assert _seqs(got[1], got[2], nb, td.unpack_moves) == _seqs(
            want[1], want[2], nb)


RUN_BANDS = (3, 20, 32)  # K8 = 8, 40 and 64: 1, 2 and 2 words a warp lane


def _slots_and_runs(seqs, sr, sj, band):
    """Every slot a walk's cursor reads, the longest run of insertions and
    the most 16-row words one path spans."""
    deletion, insertion = 2, 3  # packed move codes
    slots, run, words = set(), 0, 0
    for moves, i, j in zip(seqs, sr, sj):
        i, j, length, top = int(i), int(j), 0, int(i)
        for mv in moves:
            slots.add(j - i + band)
            length = length + 1 if mv == insertion else 0
            run = max(run, length)
            words = max(words, (top - 1) // 16 - (i - 1) // 16 + 1)
            i -= mv != insertion
            j -= mv != deletion
    return slots, run, words


@pytest.fixture(scope="module")
def run_walks():
    """band_run_pairs through the JAX banded fill, then its dirs through
    both JAX banded walkers and the port's plain walk, at RUN_BANDS."""
    pairs = band_run_pairs()
    spec = dict(batch_pairs=len(pairs), query_multiple=128,
                ref_multiple=128)
    (b,) = jio.bucketize(jio.PairDataset.from_pairs(pairs),
                         jio.BucketSpec(**spec))
    nb = b.num_real
    out = {}
    for band in RUN_BANDS:
        params = AlignmentParams(band=band)
        fill = jb.fill_banded_bucket(_jax(params), b.ref_tokens,
                                     b.qry_tokens, b.ref_len, b.qry_len)
        sc, sr, sj, dirs = (np.asarray(x) for x in (
            fill.scores, fill.start_row, fill.start_col, fill.dirs))
        want = {}
        for walker in ("pallas", "xla"):
            packed, steps = jd.device_traceback_moves(
                JAX_BSW, _jax(params), dirs, sr, sj, sc, 32, walker=walker)
            want[walker] = _seqs(packed, steps, nb)
        t = _tensors(fill)
        walk = wk.device_walk(BSW, params, t[3], t[1], t[2], t[0], 32)
        got = _seqs(walk[0].numpy(), td.walk_steps(BSW, params,
                                                   t[3].shape), nb,
                    td.unpack_moves)
        out[band] = (got, want, sr[:nb], sj[:nb])
    return out


@pytest.mark.parametrize("band", RUN_BANDS)
def test_walk_on_long_runs_across_word_rows(run_walks, band):
    """Paths over several 16-row words with runs of band - 1 insertions
    and deletions, which take the cursor to the band's edge slots 1 and
    2*band - 1 (K8 - 1 at bands 20 and 32; slot 0 lies outside the band,
    where no live cursor goes): the port's plain walk equals both JAX
    banded walkers move for move."""
    got, want, sr, sj = run_walks[band]
    assert got == want["pallas"] == want["xla"]
    slots, run, words = _slots_and_runs(got, sr, sj, band)
    assert min(slots) == 1 and max(slots) == 2 * band - 1
    assert run >= band - 1 and words >= 5


@pytest.mark.parametrize("case", CASES)
def test_compact_events_matches_jax(buckets, jax_fills, case):
    """compact_events_reference against _compact_events on the same
    banded move stream."""
    ev_max = 256
    params = CASES[case]
    sc, sr, sj, dirs = _tensors(jax_fills[case])
    packed, slots, nev = td.device_walk_reference(
        BSW, params, dirs, sr, sj, sc, 32, ev_max=ev_max)
    flat, _, max_nev, total = wk.compact_events(slots, nev, ev_max)
    want = jd._compact_events(packed.numpy(), sr.numpy(), ev_max=ev_max)
    np.testing.assert_array_equal(nev.numpy(), np.asarray(want[1]))
    assert int(max_nev) == int(want[2]) and int(total) == int(want[3])
    upto = min(int(total), flat.shape[0])
    np.testing.assert_array_equal(flat[:upto].numpy(),
                                  np.asarray(want[0])[:upto])
    # padding lanes walk nothing
    assert int(nev[buckets[_kind(case)].num_real:].sum()) == 0


@pytest.mark.skipif(not available(), reason="native library not built")
@pytest.mark.parametrize("case", CASES)
def test_replay_matches_jax(buckets, jax_buckets, jax_walks, port_walks,
                            case, jax_replay):
    params = CASES[case]
    bucket, jax_bucket = buckets[_kind(case)], jax_buckets[_kind(case)]
    got = td.bucket_arrays_from_finalized(BSW, bucket, params,
                                          port_walks[case]["fin"])
    want = jd.bucket_arrays_from_finalized(JAX_BSW, jax_bucket, _jax(params),
                                           jax_walks[case]["fin"])
    assert_same_replay(got, want, bucket, jax_replay)


@pytest.mark.skipif(not available(), reason="native library not built")
@pytest.mark.parametrize("case", CASES)
def test_native_walk_of_port_dirs_matches_jax(buckets, jax_buckets,
                                              jax_fills, port_fills, case):
    """The native host walker reads the port's banded dirs (skew_band)."""
    params = CASES[case]
    bucket, jax_bucket = buckets[_kind(case)], jax_buckets[_kind(case)]
    got = [r.block() for r in traceback_bucket(BSW, bucket,
                                               port_fills[case], params)]
    want = [r.block() for r in jax_traceback(JAX_BSW, jax_bucket,
                                             jax_fills[case], _jax(params))]
    assert got == want


def test_fill_banded_bucket_returns_a_banded_bucketfill(bucket, port_fills):
    fill = port_fills["band16"]
    assert fill.band == 16 and fill.stagger is None
    again = fill_to_numpy(*tb.fill_banded_bucket_async(
        BSW, CASES["band16"], *bucket_to_tensors(bucket, "cpu")), band=16)
    np.testing.assert_array_equal(again.dirs, fill.dirs)


def test_cpu_wrappers_run_the_plain_versions_without_a_launch(bucket,
                                                              jax_fills):
    params = CASES["band16"]
    tensors = bucket_to_tensors(bucket, "cpu")
    before = (tb.launches, wk.walk_launches)
    got = tb.fill_banded_bucket_async(BSW, params, *tensors)
    want = tb.fill_banded_reference(BSW, params, *tensors)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    sc, sr, sj, dirs = _tensors(jax_fills["band16"])
    for g, w in zip(wk.device_walk(BSW, params, dirs, sr, sj, sc, 32),
                    td.device_walk_reference(BSW, params, dirs, sr, sj, sc,
                                             32)):
        assert torch.equal(g, w)
    assert (tb.launches, wk.walk_launches) == before


@pytest.mark.parametrize("algo", [Algorithm.LNW, Algorithm.LSW,
                                  Algorithm.ANW], ids=lambda a: a.value)
def test_banded_wrapper_refuses_other_algorithms(bucket, algo):
    with pytest.raises(ValueError, match="bsw only"):
        tb.fill_banded_bucket_async(algo, CASES["band16"],
                                    *bucket_to_tensors(bucket, "cpu"))


@pytest.mark.parametrize("bad", ["dtype", "batch"])
def test_banded_wrapper_checks_its_inputs(bucket, bad):
    ref, qry, rl, ql = bucket_to_tensors(bucket, "cpu")
    if bad == "dtype":
        qry = qry.to(torch.int32)
    else:
        rl = rl[:-1]
    with pytest.raises(ValueError):
        tb.fill_banded_bucket_async(BSW, CASES["band16"], ref, qry, rl, ql)


@pytest.mark.parametrize("bad", ["stagger-dirs", "band"])
def test_walk_checks_the_banded_layout(jax_fills, bad):
    sc, sr, sj, dirs = _tensors(jax_fills["band16"])
    params = CASES["band16"]
    if bad == "stagger-dirs":
        dirs = dirs[:, None]  # 4-D
    else:
        params = AlignmentParams(band=3)  # K8 8, the dirs have 32
    with pytest.raises(ValueError, match="K8|3-D"):
        wk.device_walk(BSW, params, dirs, sr, sj, sc, 32)


def test_walk_steps_bounds_a_banded_path():
    """2M + band - 1 rounded up to 16: a band cell's column is below
    M + band."""
    assert td.walk_steps(BSW, CASES["band16"], (8, 64, 32)) == 272
    assert td.walk_steps(BSW, CASES["band1"], (8, 64, 8)) == 256
