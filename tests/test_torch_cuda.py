"""The port's CUDA kernels against their plain PyTorch versions, on the
card: the stagger fill (LNW, LSW, ANW; band seams included) and its
last-row variant, the banded fill (BSW; bands 1-129, seams and the
main-path bucket; bands 14,528-20,000, whose slots pass one warp's shared
memory, on long pairs, and through the CLI), the row-sweep fill, a band
wavefront in every mode
(all four aligners, dirs and scores: the wavefront's seams with planted
ties, wide references, repeated launches; LNW's scores step in the
gap-offset form at its seams, on a launch of 256-row bands, at the widest
gap it admits and under weights it does not; its last rows: row seams,
widths, 1-128 problems, the split-level shape, repeated launches), the
walk over both layouts (seam, long-run and main-path buckets; the moves
mode and the Python replay against the events path; the banded walk at
bands 1-32 and on runs to the band's edge slots at bands 3-129
and 14,528-20,000), the event compaction, the Hirschberg split reduction
(also on the shapes its grid splits differently, and repeated) and the
Hirschberg path as a whole, the
DPX op layer (csrc/dpx_apply.cu, all 36 functions) and the s16x2
experiment's core (csrc/s16x2_core.cu, both variants); then the engine as
a whole: hw_parity's 14 configurations over 1,024 mixed-length pairs
against the oracle, a few seeds of each fuzzer, the all-paths goldens
through `-all-paths -device cuda`, and the engine on a 2-shard mesh of the
card (after warmup) against the one-device run, launch counts included;
the engine's pinned buckets (tokens gathered into page-locked tensors
that are the uploads' own sources, reused across back-to-back runs);
the mesh of every visible card, global_stats, and -mesh beyond them; the
fill counters against the buckets of an engine run and against
Hirschberg's fill launches; ANW scores of 16 kbp pairs on the band
wavefront against the benchmark's plain reference, with B2's counters;
LSW's local best at 16 kbp (planted in bands 0-127, tied across bands and
inside a row) and HiFi-like LSW pairs through the engine, end cells
against that reference, with the kernel's count of its scores step's
cells.

Marked `cuda`; each test skips where torch.cuda.is_available() is false.
The module imports only the port (and, inside some tests, the
benchmark's plain PyTorch reference).  The card's machine has no JAX, and
tests/conftest.py imports it, so run these there without the conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import os

import numpy as np
import pytest
import torch

from tpu_align_torch import Algorithm, AlignmentParams
from tpu_align_torch.cli import main as cli_main
from tpu_align_torch.convert import bucket_to_tensors
from tpu_align_torch.io import BucketSpec, PairDataset, bucketize
from tpu_align_torch.io.dataset import parse_pair_file
from tpu_align_torch.kernels import _build as build
from tpu_align_torch.kernels import banded as tb
from tpu_align_torch.kernels import fill as rs
from tpu_align_torch.kernels import stagger as ts
from tpu_align_torch.ops import dpx
from tpu_align_torch.oracle.api import align_pair
from tpu_align_torch.runtime.profiler import (
    count_fill,
    full_band_cells,
    launch_counts,
    reset_launch_counts,
)
from tpu_align_torch.scripts import exp_s16x2
from tpu_align_torch.traceback import device as td
from tpu_align_torch.traceback import hirschberg as th
from tpu_align_torch.traceback import walk_kernel as wk
from tpu_align_torch.utils.synthetic import (
    SPLIT_REDUCE_SHAPES,
    band_run_pairs,
    long_run_bucket,
    main_path_bucket,
    rowscan_seam_bucket,
    scores_step_bucket,
    seam_bucket,
    split_reduce_inputs,
    synthetic_dataset,
    wide_band_bucket,
)

pytestmark = pytest.mark.cuda

PARAMS = AlignmentParams()
FILL_COUNTS = ("stagger_fill", "banded_fill", "rowscan_fill",
               "rowscan_last_rows", "stagger_last_rows")
GOLDENS = os.path.join(os.path.dirname(__file__), "..", "goldens")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


def _pairs(seed: int, n: int, lo: int, hi: int, alphabet: str):
    rng = np.random.default_rng(seed)
    letters = np.array(list(alphabet))

    def seq():
        return "".join(rng.choice(letters, int(rng.integers(lo, hi + 1))))

    return [(seq(), seq()) for _ in range(n)]


def _bucket(pairs):
    (b,) = bucketize(PairDataset.from_pairs(pairs),
                     BucketSpec(batch_pairs=len(pairs), query_multiple=384,
                                ref_multiple=384))
    return b


def _assert_same(got, want, ref_len, qry_len, num_real,
                 algo=Algorithm.LNW):
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g[:num_real], w[:num_real])
    assert (got[3] is None) == (want[3] is None)
    if got[3] is not None:
        assert got[3].shape == want[3].shape
        assert torch.equal(
            ts.defined_codes(algo, got[3][..., :num_real],
                             ref_len[:num_real], qry_len[:num_real]),
            ts.defined_codes(algo, want[3][..., :num_real],
                             ref_len[:num_real], qry_len[:num_real]))


@pytest.mark.parametrize("alphabet", ["ACGT", "AC"])
@pytest.mark.parametrize("stripe_s", [32, 16, 7])
@pytest.mark.parametrize("with_traceback", [True, False])
def test_kernel_matches_plain_version(cuda_device, alphabet, stripe_s,
                                      with_traceback):
    b = _bucket(_pairs(5, 300, 1, 300, alphabet))  # 300 pairs: 3 blocks
    t = bucket_to_tensors(b, cuda_device)
    before = ts.launches
    got = ts.fill_stagger_bucket_async(Algorithm.LNW, PARAMS, *t,
                                       with_traceback=with_traceback,
                                       stripe_s=stripe_s)
    assert ts.launches == before + 1
    want = ts.fill_stagger_reference(Algorithm.LNW, PARAMS, *t,
                                     with_traceback=with_traceback,
                                     stripe_s=stripe_s)
    torch.cuda.synchronize()
    _assert_same(got, want, t[2], t[3], b.num_real)


@pytest.mark.parametrize("algo", [Algorithm.LNW, Algorithm.LSW,
                                  Algorithm.ANW], ids=lambda a: a.value)
@pytest.mark.parametrize("stripe_s", [32, 16, 7, 64])
@pytest.mark.parametrize("with_traceback", [True, False])
def test_stagger_fill_band_seams(cuda_device, algo, stripe_s,
                                 with_traceback):
    """Lengths on both sides of the lanes' rows, the 32-column chunks and
    the 128-row bands, LSW ties within a lane's rows and across a band
    seam, empty sides and padding lanes, against the plain version."""
    b, t = seam_bucket(cuda_device)
    assert b.batch > b.num_real
    before = ts.launches
    got = ts.fill_stagger_bucket_async(algo, PARAMS, *t,
                                       with_traceback=with_traceback,
                                       stripe_s=stripe_s)
    assert ts.launches == before + 1
    want = ts.fill_stagger_reference(algo, PARAMS, *t,
                                     with_traceback=with_traceback,
                                     stripe_s=stripe_s)
    torch.cuda.synchronize()
    _assert_same(got, want, t[2], t[3], b.num_real, algo)


def test_kernel_alt_params_and_padding_rows(cuda_device):
    params = AlignmentParams(match=5, mismatch=-2, gap=-3)
    b = _bucket(_pairs(9, 13, 1, 90, "ACGT"))  # 3 padding rows in 16
    t = bucket_to_tensors(b, cuda_device)
    got = ts.fill_stagger_bucket_async(Algorithm.LNW, params, *t)
    want = ts.fill_stagger_reference(Algorithm.LNW, params, *t)
    torch.cuda.synchronize()
    _assert_same(got, want, t[2], t[3], b.num_real)


def test_kernel_outputs_stay_on_the_card(cuda_device):
    b = _bucket(_pairs(3, 8, 1, 40, "ACGT"))
    outs = ts.fill_stagger_bucket_async(Algorithm.LNW, PARAMS,
                                        *bucket_to_tensors(b, cuda_device))
    assert all(o.device.type == "cuda" for o in outs)
    assert outs[3].dtype == torch.int32
    assert outs[3].shape == ts.dirs_shape(Algorithm.LNW, b.padded_qry,
                                          b.padded_ref, b.batch, ts.STRIPE_S)


def test_kernel_refuses_mixed_devices(cuda_device):
    b = _bucket(_pairs(3, 8, 1, 40, "ACGT"))
    ref, qry, rl, ql = bucket_to_tensors(b, cuda_device)
    with pytest.raises(ValueError, match="is on"):
        ts.fill_stagger_bucket_async(Algorithm.LNW, PARAMS, ref, qry,
                                     rl.cpu(), ql)


@pytest.mark.parametrize("alphabet", ["ACGT", "AC"])
@pytest.mark.parametrize("stripe_s", [32, 16, 7])
@pytest.mark.parametrize("with_traceback", [True, False])
def test_lsw_kernel_matches_plain_version(cuda_device, alphabet, stripe_s,
                                          with_traceback):
    b = _bucket(_pairs(6, 300, 1, 300, alphabet))
    t = bucket_to_tensors(b, cuda_device)
    before = ts.launches
    got = ts.fill_stagger_bucket_async(Algorithm.LSW, PARAMS, *t,
                                       with_traceback=with_traceback,
                                       stripe_s=stripe_s)
    assert ts.launches == before + 1
    want = ts.fill_stagger_reference(Algorithm.LSW, PARAMS, *t,
                                     with_traceback=with_traceback,
                                     stripe_s=stripe_s)
    torch.cuda.synchronize()
    _assert_same(got, want, t[2], t[3], b.num_real)


@pytest.mark.parametrize("algo", [Algorithm.LNW, Algorithm.LSW],
                         ids=lambda a: a.value)
@pytest.mark.parametrize("alphabet", ["ACGT", "AC"])
@pytest.mark.parametrize("stripe_s", [32, 16, 7])
def test_walk_and_compaction_match_plain_versions(cuda_device, algo,
                                                  alphabet, stripe_s):
    b = _bucket(_pairs(8, 300, 1, 300, alphabet))
    scores, srow, scol, dirs = ts.fill_stagger_bucket_async(
        algo, PARAMS, *bucket_to_tensors(b, cuda_device), stripe_s=stripe_s)
    _walk_and_compact(algo, PARAMS, dirs, srow, scol, scores, stripe_s)


def test_walk_outputs_stay_on_the_card(cuda_device):
    b = _bucket(_pairs(3, 8, 1, 40, "ACGT"))
    scores, srow, scol, dirs = ts.fill_stagger_bucket_async(
        Algorithm.LNW, PARAMS, *bucket_to_tensors(b, cuda_device))
    packed, slots, nev = wk.device_walk(Algorithm.LNW, PARAMS, dirs, srow,
                                        scol, scores, ts.STRIPE_S)
    assert all(o.device.type == "cuda" for o in (packed, slots, nev))
    assert packed.shape == (td.walk_steps(Algorithm.LNW, PARAMS, dirs.shape)
                            // 16, b.batch)
    assert slots.dtype == torch.uint16 and slots.shape == (td.EV_MAX,
                                                            b.batch)


@pytest.mark.parametrize("alphabet", ["ACGT", "AC"])
@pytest.mark.parametrize("stripe_s", [32, 16, 7])
@pytest.mark.parametrize("with_traceback", [True, False])
def test_anw_kernel_matches_plain_version(cuda_device, alphabet, stripe_s,
                                          with_traceback):
    b = _bucket(_pairs(10, 300, 1, 300, alphabet))
    t = bucket_to_tensors(b, cuda_device)
    before = ts.launches
    got = ts.fill_stagger_bucket_async(Algorithm.ANW, PARAMS, *t,
                                       with_traceback=with_traceback,
                                       stripe_s=stripe_s)
    assert ts.launches == before + 1
    want = ts.fill_stagger_reference(Algorithm.ANW, PARAMS, *t,
                                     with_traceback=with_traceback,
                                     stripe_s=stripe_s)
    torch.cuda.synchronize()
    _assert_same(got, want, t[2], t[3], b.num_real, Algorithm.ANW)


def test_anw_kernel_refuses_a_positive_gap_open(cuda_device):
    b = _bucket(_pairs(3, 8, 1, 40, "ACGT"))
    with pytest.raises(ValueError, match="gap_open"):
        ts.fill_stagger_bucket_async(Algorithm.ANW,
                                     AlignmentParams(gap_open=1),
                                     *bucket_to_tensors(b, cuda_device))


def _assert_same_banded(got, want, ref_len, qry_len, num_real, band):
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g[:num_real], w[:num_real])
    assert (got[3] is None) == (want[3] is None)
    if got[3] is not None:
        assert got[3].shape == want[3].shape
        lens = (ref_len[:num_real], qry_len[:num_real], band)
        step = 16  # word rows a decode: a wide frame's codes fit memory
        for w0 in range(0, got[3].shape[0], step):
            g, w = (d[w0:w0 + step, :num_real] for d in (got[3], want[3]))
            assert torch.equal(tb.defined_codes(g, *lens, first_word=w0),
                               tb.defined_codes(w, *lens, first_word=w0))


BANDS = [1, 3, 16, 20, 32]  # K8 = 8, 8, 32, 40 (two slots a lane), 64


@pytest.mark.parametrize("alphabet", ["ACGT", "AC"])
@pytest.mark.parametrize("band", BANDS)
@pytest.mark.parametrize("with_traceback", [True, False])
def test_banded_kernel_matches_plain_version(cuda_device, alphabet, band,
                                             with_traceback):
    params = AlignmentParams(band=band)
    b = _bucket(_pairs(11, 300, 1, 300, alphabet))
    t = bucket_to_tensors(b, cuda_device)
    before = tb.launches
    got = tb.fill_banded_bucket_async(Algorithm.BSW, params, *t,
                                      with_traceback=with_traceback)
    assert tb.launches == before + 1
    want = tb.fill_banded_reference(Algorithm.BSW, params, *t,
                                    with_traceback=with_traceback)
    torch.cuda.synchronize()
    _assert_same_banded(got, want, t[2], t[3], b.num_real, band)


def test_banded_kernel_edge_slot_with_alt_weights(cuda_device):
    """Weights under which a deletion can win at the band's edge slot: the
    K8 == 2*band rule (band 4) and K8 > 2*band (band 3) both hold."""
    b = _bucket(_pairs(12, 300, 1, 300, "ACGT"))
    t = bucket_to_tensors(b, cuda_device)
    for band in (3, 4):
        params = AlignmentParams(mismatch=-3, gap=-1, band=band)
        got = tb.fill_banded_bucket_async(Algorithm.BSW, params, *t)
        want = tb.fill_banded_reference(Algorithm.BSW, params, *t)
        torch.cuda.synchronize()
        _assert_same_banded(got, want, t[2], t[3], b.num_real, band)


def _main_path(device):
    b = main_path_bucket()
    return b, bucket_to_tensors(b, device)


BANDED_BUCKETS = {"seams": seam_bucket, "main-path": _main_path}


@pytest.mark.parametrize("band", BANDS + [64, 129])
@pytest.mark.parametrize("bucket", list(BANDED_BUCKETS))
@pytest.mark.parametrize("with_traceback", [True, False])
def test_banded_kernel_on_seams_and_the_main_path(cuda_device, bucket, band,
                                                  with_traceback):
    """The seam bucket (lengths 1-257 around the 16-row word and the 32
    lanes, tie-rich "AC" pairs, a qlen = 0 and an rlen = 0 lane, padding
    lanes) and the main path's 2048-pair 250-bp bucket, one launch each;
    bands 64 and 129 take four slots a lane and the shared-memory slots."""
    params = AlignmentParams(band=band)
    b, t = BANDED_BUCKETS[bucket](cuda_device)
    before = tb.launches
    got = tb.fill_banded_bucket_async(Algorithm.BSW, params, *t,
                                      with_traceback=with_traceback)
    assert tb.launches == before + 1
    want = tb.fill_banded_reference(Algorithm.BSW, params, *t,
                                    with_traceback=with_traceback)
    torch.cuda.synchronize()
    _assert_same_banded(got, want, t[2], t[3], b.num_real, band)


# K8 = 29,056, the widest frame whose slots fit one warp's shared memory,
# then 29,064 and 40,000, whose slots live in the fill's global scratch
WIDE_BANDS = [14528, 14529, 20000]


@pytest.mark.parametrize("band", WIDE_BANDS)
@pytest.mark.parametrize("with_traceback", [True, False])
def test_banded_kernel_at_wide_bands(cuda_device, band, with_traceback):
    """Two long pairs whose sides reach band + 64 bp or more (runs of band
    - 1 indels between long flanks, wide_band_bucket), so both edge slots
    1 and 2*band - 1 hold valid cells: one launch, equal to the plain
    version at every valid cell."""
    params = AlignmentParams(band=band)
    b, t = wide_band_bucket(band, cuda_device)
    assert min(b.qry_len[:b.num_real].min(),
               b.ref_len[:b.num_real].min()) >= band + 64
    before = tb.launches
    got = tb.fill_banded_bucket_async(Algorithm.BSW, params, *t,
                                      with_traceback=with_traceback)
    assert tb.launches == before + 1
    want = tb.fill_banded_reference(Algorithm.BSW, params, *t,
                                    with_traceback=with_traceback)
    torch.cuda.synchronize()
    _assert_same_banded(got, want, t[2], t[3], b.num_real, band)


@pytest.mark.parametrize("band", WIDE_BANDS)
def test_banded_walk_at_wide_bands(cuda_device, band):
    """The banded walk on the wide fills: each pair's path runs band - 1
    insertions or deletions, so the cursor reaches slots 1 and 2*band - 1
    (its 128-slot window at the frame's edges); equal to the plain walk
    word for word."""
    params = AlignmentParams(band=band)
    b, t = wide_band_bucket(band, cuda_device)
    scores, srow, scol, dirs = tb.fill_banded_bucket_async(
        Algorithm.BSW, params, *t)
    _walk_and_compact(Algorithm.BSW, params, dirs, srow, scol, scores,
                      ts.STRIPE_S)
    packed, _, _ = wk.device_walk(Algorithm.BSW, params, dirs, srow, scol,
                                  scores, ts.STRIPE_S)
    moves = td.unpack_moves(packed.cpu().numpy(),
                            td.walk_steps(Algorithm.BSW, params, dirs.shape))
    slots = set()
    for lane in range(b.num_real):
        i, j = int(srow[lane]), int(scol[lane])
        for mv in moves[:, lane]:
            if not mv:
                break
            slots.add(j - i + band)
            i -= int(mv) != 3  # 3: insertion, 2: deletion
            j -= int(mv) != 2
    assert min(slots) == 1 and max(slots) == 2 * band - 1


@pytest.mark.parametrize("traceback", ["host", "device"])
def test_cli_at_a_wide_band_matches_the_oracle(cuda_device, tmp_path,
                                               traceback):
    """`tpu-align-torch -device cuda -algorithm bsw -band 14529`: the fill
    with its slots in the global scratch, then either walk; blocks equal
    to the oracle's."""
    src = os.path.join(GOLDENS, "bsw", "input-data.txt")
    out = tmp_path / "out.txt"
    before = tb.launches
    assert cli_main(["-pairs", src, "-algorithm", "bsw", "-band", "14529",
                     "-traceback", traceback, "-device", "cuda",
                     "-out", str(out)]) == 0
    assert tb.launches > before
    ds = parse_pair_file(src)
    params = AlignmentParams(band=14529)
    want = "".join(align_pair(Algorithm.BSW, params, *ds.pair(k),
                              pair_num=k).block() for k in range(len(ds)))
    assert out.read_text() == want


def _walk_and_compact(algo, params, dirs, srow, scol, scores, stripe_s,
                      ev_max=td.EV_MAX):
    before = (wk.walk_launches, wk.compact_launches)
    got = wk.device_walk(algo, params, dirs, srow, scol, scores, stripe_s,
                         ev_max=ev_max)
    flat, nev, max_nev, total = wk.compact_events(got[1], got[2], ev_max)
    assert (wk.walk_launches, wk.compact_launches) == (before[0] + 1,
                                                       before[1] + 1)
    want = td.device_walk_reference(algo, params, dirs, srow, scol, scores,
                                    stripe_s, ev_max=ev_max)
    want_c = td.compact_events_reference(want[1], want[2], ev_max)
    torch.cuda.synchronize()
    assert td.same_walk(got, want)  # packed, nev, the kept slots
    assert int(max_nev) == int(want_c[2]) and int(total) == int(want_c[3])
    assert torch.equal(flat, want_c[0])
    return int(max_nev), int(total), flat.numel()


@pytest.mark.parametrize("alphabet", ["ACGT", "AC"])
@pytest.mark.parametrize("stripe_s", [32, 16, 7])
def test_affine_walk_and_compaction_match_plain_versions(cuda_device,
                                                         alphabet, stripe_s):
    b = _bucket(_pairs(13, 300, 1, 300, alphabet))
    scores, srow, scol, dirs = ts.fill_stagger_bucket_async(
        Algorithm.ANW, PARAMS, *bucket_to_tensors(b, cuda_device),
        stripe_s=stripe_s)
    _walk_and_compact(Algorithm.ANW, PARAMS, dirs, srow, scol, scores,
                      stripe_s)


@pytest.mark.parametrize("alphabet", ["ACGT", "AC"])
@pytest.mark.parametrize("band", [1, 3, 16, 20, 32])
def test_banded_walk_and_compaction_match_plain_versions(cuda_device,
                                                         alphabet, band):
    params = AlignmentParams(band=band)
    b = _bucket(_pairs(14, 300, 1, 300, alphabet))
    scores, srow, scol, dirs = tb.fill_banded_bucket_async(
        Algorithm.BSW, params, *bucket_to_tensors(b, cuda_device))
    _walk_and_compact(Algorithm.BSW, params, dirs, srow, scol, scores,
                      ts.STRIPE_S)


@pytest.mark.parametrize("band", [3, 20, 32, 64, 129])
def test_banded_walk_on_long_runs(cuda_device, band):
    """Paths over several 16-row words with runs of up to 128 insertions
    and deletions, to the band's edge slots (band_run_pairs; the 150-bp
    flanks make the runs of 63 and 128 worth taking): one word a lane
    (band 3), two (20, 32), four (64), and past K8 = 128 (band 129) a
    window of 128 slots around the cursor, loaded again when it leaves."""
    params = AlignmentParams(band=band)
    pairs = (band_run_pairs(runs=(2, 19, 31, 63, 128))
             + band_run_pairs(runs=(63, 128), flanks=(150, 150)))
    (b,) = bucketize(PairDataset.from_pairs(pairs),
                     BucketSpec(batch_pairs=len(pairs), query_multiple=512,
                                ref_multiple=512))
    scores, srow, scol, dirs = tb.fill_banded_bucket_async(
        Algorithm.BSW, params, *bucket_to_tensors(b, cuda_device))
    _walk_and_compact(Algorithm.BSW, params, dirs, srow, scol, scores,
                      ts.STRIPE_S)


WALK_BUCKETS = {"seams": seam_bucket, "long-runs": long_run_bucket}
STAGGER = [Algorithm.LNW, Algorithm.LSW, Algorithm.ANW]


@pytest.mark.parametrize("stripe_s", [7, 16, 32, 64])
@pytest.mark.parametrize("algo", STAGGER, ids=lambda a: a.value)
@pytest.mark.parametrize("bucket", list(WALK_BUCKETS))
def test_walk_on_seam_and_long_run_buckets(cuda_device, bucket, algo,
                                           stripe_s):
    """The seam bucket (lengths 1-257 on both sides, empty sides, padding
    lanes) and the long-run bucket (257 bp against 1-8 bp both ways:
    long insertion and deletion runs), from the CUDA fill; the seam
    bucket's unrelated pairs overflow ev_max and the cap as well."""
    b, t = WALK_BUCKETS[bucket](cuda_device)
    scores, srow, scol, dirs = ts.fill_stagger_bucket_async(
        algo, PARAMS, *t, stripe_s=stripe_s)
    _walk_and_compact(algo, PARAMS, dirs, srow, scol, scores, stripe_s)


@pytest.mark.parametrize("algo", STAGGER, ids=lambda a: a.value)
def test_walk_overflows_ev_max_and_the_cap(cuda_device, algo):
    """ev_max = 2: lanes keep 2 slots of many events, and the total
    passes the 2-a-lane cap, so a caller would replay packed."""
    b, t = seam_bucket(cuda_device)
    scores, srow, scol, dirs = ts.fill_stagger_bucket_async(algo, PARAMS,
                                                            *t)
    max_nev, total, cap = _walk_and_compact(algo, PARAMS, dirs, srow, scol,
                                            scores, ts.STRIPE_S, ev_max=2)
    assert max_nev > 2 and total > cap


@pytest.mark.parametrize("algo", STAGGER, ids=lambda a: a.value)
def test_walk_on_the_main_path_bucket(cuda_device, algo):
    """A full 2048-pair 250-bp bucket, as the main path fills (seed 42)."""
    b = main_path_bucket()
    scores, srow, scol, dirs = ts.fill_stagger_bucket_async(
        algo, PARAMS, *bucket_to_tensors(b, cuda_device))
    max_nev, total, cap = _walk_and_compact(algo, PARAMS, dirs, srow, scol,
                                            scores, ts.STRIPE_S)
    assert max_nev <= td.EV_MAX and total <= cap  # the event form


@pytest.mark.parametrize("algo", list(Algorithm), ids=lambda a: a.value)
def test_moves_mode_and_python_replay_on_the_card(cuda_device, algo):
    """From a card fill of 300 mixed pairs (the stagger fill, BSW's banded
    fill at band 16): the moves mode's stream equals the plain walk's
    packed moves word for word, with one walk launch; the one-call
    traceback in moves mode, with the native and the Python replay,
    equals the events path's alignments."""
    params = AlignmentParams(band=16) if algo.is_banded else PARAMS
    b = _bucket(_pairs(21, 300, 1, 300, "ACGT"))
    t = bucket_to_tensors(b, cuda_device)
    if algo.is_banded:
        scores, srow, scol, dirs = tb.fill_banded_bucket_async(algo, params,
                                                               *t)
    else:
        scores, srow, scol, dirs = ts.fill_stagger_bucket_async(algo,
                                                                params, *t)
    args = (algo, params, dirs, srow, scol, scores, ts.STRIPE_S)
    before = wk.walk_launches
    packed, steps = td.device_traceback_moves(*args)
    assert wk.walk_launches == before + 1
    want = td.device_walk_reference(*args)
    np.testing.assert_array_equal(packed, want[0].cpu().numpy())
    assert steps == packed.shape[0] * td.MOVES_PER_WORD

    def lines(results):
        return [(r.pair_num, r.score, r.ref_aligned, r.relation,
                 r.query_aligned) for r in results]

    events = td.device_traceback_bucket(
        algo, b, scores, srow, scol, dirs, params, ts.STRIPE_S,
        handle=td.device_walk_dispatch_events(*args,
                                              extras=(scores, srow, scol)))
    assert len(events) == b.num_real
    for use_native in (True, False):
        got = td.device_traceback_bucket(algo, b, scores, srow, scol, dirs,
                                         params, ts.STRIPE_S,
                                         use_native=use_native)
        assert lines(got) == lines(events)


@pytest.mark.parametrize("hi", [3, 20, 50])
@pytest.mark.parametrize("ev_max", [32, 40])
@pytest.mark.parametrize("batch", [1, 33, 1025, 4096, 10000])
def test_compaction_matches_plain_version(cuda_device, batch, ev_max, hi):
    """Random counts (a third of the lanes empty, up to hi - 1 events)
    and slots: events past ev_max, totals below and above the cap.  At
    10,000 lanes (313 tiles) blocks take more than one tile each."""
    rng = np.random.default_rng(batch + 7 * ev_max + hi)
    nev = rng.integers(0, hi, batch).astype(np.int32)
    nev[rng.random(batch) < 0.3] = 0
    slots = rng.integers(1, 1 << 15, (ev_max, batch)).astype(np.int16)
    nev = torch.from_numpy(nev).to(cuda_device)
    slots = torch.from_numpy(slots).view(torch.uint16).to(cuda_device)
    before = wk.compact_launches
    got = wk.compact_events(slots, nev, ev_max)
    assert wk.compact_launches == before + 1
    want = td.compact_events_reference(slots, nev, ev_max)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    assert int(got[2]) == int(want[2]) and int(got[3]) == int(want[3])


def _assert_same_rowscan(algo, got, want, ref_len, qry_len, num_real):
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g[:num_real], w[:num_real])
    assert (got[3] is None) == (want[3] is None)
    if got[3] is not None:
        assert got[3].shape == want[3].shape
        lens = (ref_len[:num_real], qry_len[:num_real])
        assert torch.equal(rs.defined_codes(algo, got[3][:, :num_real], *lens),
                           rs.defined_codes(algo, want[3][:, :num_real],
                                            *lens))


def _assert_same_last_rows(got, want, ref_len, num_real):
    """Scores, then hlast (and flast) at every defined entry j <= rlen."""
    assert torch.equal(got[0][:num_real], want[0][:num_real])
    assert (got[2] is None) == (want[2] is None)
    n = got[1].shape[0]
    defined = (torch.arange(1, n + 1, device=got[1].device)[:, None]
               <= ref_len[None, :num_real].to(got[1].device))
    for g, w in zip(got[1:], want[1:]):
        if g is not None:
            assert g.shape == w.shape
            assert torch.equal(torch.where(defined, g[:, :num_real], 0),
                               torch.where(defined, w[:, :num_real], 0))


ALGOS4 = [Algorithm.LNW, Algorithm.LSW, Algorithm.ANW, Algorithm.BSW]


@pytest.mark.parametrize("algo", ALGOS4, ids=lambda a: a.value)
@pytest.mark.parametrize("alphabet", ["ACGT", "AC"])
@pytest.mark.parametrize("with_traceback", [True, False])
def test_rowscan_kernel_matches_plain_version(cuda_device, algo, alphabet,
                                              with_traceback):
    params = AlignmentParams(band=5)
    b = _bucket(_pairs(21, 300, 1, 300, alphabet))
    t = bucket_to_tensors(b, cuda_device)
    before = rs.launches
    got = rs.fill_bucket_async(algo, params, *t,
                               with_traceback=with_traceback)
    assert rs.launches == before + 1
    want = rs.fill_rowscan_reference(algo, params, *t,
                                     with_traceback=with_traceback)
    torch.cuda.synchronize()
    _assert_same_rowscan(algo, got, want, t[2], t[3], b.num_real)


@pytest.mark.parametrize("algo", ALGOS4, ids=lambda a: a.value)
@pytest.mark.parametrize("with_traceback", [True, False])
def test_rowscan_kernel_on_band_seams(cuda_device, algo, with_traceback):
    """The band wavefront's seams (rowscan_seam_bucket: qlen 1, 127-129,
    255-257, rlen 1, 31-33, 65, the planted LSW and BSW ties in and across
    bands 0 and 1, a qlen = 0 lane, rlen = 0 lanes of qlen 5 and 257,
    padding lanes), one launch, against the plain version.  The kernel's
    dirs also hold 0 in the bits of rows past qlen in each pair's last
    word row (it computes those rows and clears them when it stores the
    word; the plain version leaves them undefined)."""
    params = AlignmentParams(band=5)
    b, t = rowscan_seam_bucket(cuda_device)
    assert b.batch > b.num_real
    before = rs.launches
    got = rs.fill_bucket_async(algo, params, *t,
                               with_traceback=with_traceback)
    assert rs.launches == before + 1
    want = rs.fill_rowscan_reference(algo, params, *t,
                                     with_traceback=with_traceback)
    torch.cuda.synchronize()
    _assert_same_rowscan(algo, got, want, t[2], t[3], b.num_real)
    if with_traceback:
        bits, rpw = 4 if algo.is_affine else 2, rs.rows_per_word(algo)
        for k in range(b.num_real):
            q, r = int(t[3][k]), int(t[2][k])
            used = bits * ((q - 1) % rpw + 1)
            if q > 0 and r > 0 and used < 32:
                words = got[3][(q - 1) // rpw, k, :r].long() & 0xFFFFFFFF
                assert not torch.any(words >> used), (k, q, r)


# every rows-a-lane the scores instantiations are built with: 4, and 8
# for LNW and ANW
WIDE_BUILT = (Algorithm.LNW, Algorithm.ANW)
SCORES_STEP_ROWS = [(a, r) for a in ALGOS4
                    for r in ((4, 8) if a in WIDE_BUILT else (4,))]


@pytest.mark.parametrize("algo,lane_rows", SCORES_STEP_ROWS,
                         ids=[f"{a.value}-{r}" for a, r in SCORES_STEP_ROWS])
@pytest.mark.parametrize("alt", [False, True], ids=["3-1-2", "alt"])
def test_rowscan_scores_step_on_its_seams(cuda_device, monkeypatch, algo,
                                          lane_rows, alt):
    """The scores step (fill_band_scores) and the general step beside it
    at each rows-a-lane built, one launch of the ragged scores_step_bucket
    (qlen 0, 1, 31-33, 127-129, 255-257, 384, 511-513 x rlen 0, 1, 31-33,
    63-65, 96, 97, 160: ramps alone, steady chunks, full bands, a partial
    bottom band at 128 and 256 rows; N, lowercase and pad codes in both
    sequences; LSW and BSW ties in row-major order at 128- and 256-row
    seams) against the plain version: scores, rows and columns bit for
    bit.  alt: other weights (match 5, mismatch -4, gaps -3, -5, -2), and
    a match past a byte, where every band takes the general step."""
    # the launch's shape picks 8 rows a lane where they are built: force
    # each either way
    monkeypatch.setattr(rs, "WIDE_BANDS_A_WARP",
                        0 if 32 * lane_rows == rs.WIDE_BAND_ROWS else 10**9)
    b, t = scores_step_bucket(cuda_device)
    weights = [AlignmentParams(match=5, mismatch=-4, gap=-3, gap_open=-5,
                               gap_extend=-2, band=7),
               AlignmentParams(match=200, mismatch=-1, band=7)] if alt \
        else [AlignmentParams(band=5)]
    for params in weights:
        before = rs.launches
        got = rs.fill_bucket_async(algo, params, *t, with_traceback=False)
        assert rs.launches == before + 1
        assert rs.launch_band_rows == 32 * lane_rows
        assert rs.launch_scores_step == (params.match < 128)
        want = rs.fill_rowscan_reference(algo, params, *t,
                                         with_traceback=False)
        torch.cuda.synchronize()
        _assert_same_rowscan(algo, got, want, t[2], t[3], b.num_real)


def test_rowscan_wide_bands_only_where_built(cuda_device, monkeypatch):
    """The entry point tells which band sizes it is built for: 128 rows in
    every mode, 256 only for LNW's and ANW's scores mode (-1 elsewhere),
    so band_rows keeps 128 for LSW and BSW even where a launch's shape
    asks for wide bands, and their launch runs as before."""
    for algo in ALGOS4:
        code = rs._ALGO_CODE[algo]
        for mode in (0, 1):
            assert build.library().ta_torch_rowscan_resident_warps(
                code, mode, 128) > 0
            wide = build.library().ta_torch_rowscan_resident_warps(
                code, mode, 256)
            assert (wide > 0) == (mode == 0 and algo in WIDE_BUILT), \
                (algo, mode, wide)
    monkeypatch.setattr(rs, "WIDE_BANDS_A_WARP", 0)
    b, t = scores_step_bucket(cuda_device)
    params = AlignmentParams(band=5)
    for algo in ALGOS4:
        got = rs.fill_bucket_async(algo, params, *t, with_traceback=False)
        assert rs.launch_band_rows == (256 if algo in WIDE_BUILT else 128)
        want = rs.fill_rowscan_reference(algo, params, *t,
                                         with_traceback=False)
        torch.cuda.synchronize()
        _assert_same_rowscan(algo, got, want, t[2], t[3], b.num_real)


def _offset_pairs(case: str, rng) -> list[tuple[bytes, bytes]]:
    """Pairs that put LNW's gap-offset scores step (fill_band_scores) at
    one of its seams, a query a copy of its reference with 2 % of it
    substituted (so the diagonal wins and H' climbs), each length as named:
    (reference, query) bytes."""
    def pair(rlen: int, qlen: int) -> tuple[bytes, bytes]:
        ref = rng.choice(np.frombuffer(b"ACGT", np.uint8), rlen)
        qry = rng.choice(np.frombuffer(b"ACGT", np.uint8), qlen)
        n = min(rlen, qlen)
        qry[:n] = np.where(rng.random(n) < 0.02, qry[:n], ref[:n])
        return ref, qry

    def n_at(seq, at: int):
        seq[at] = ord("N")

    out = []
    if case == "partial-bottom":  # 2 or 4 full bands, then 88 or 1 rows
        out = [pair(500, 600), pair(700, 513), pair(64, 257)]
    elif case == "n-in-middle":  # offset bands above and below a general one
        for rlen, qlen, at in ((700, 768, 300), (400, 1024, 520)):
            ref, qry = pair(rlen, qlen)
            n_at(qry, at)
            out.append((ref, qry))
        ref, qry = pair(600, 768)  # an N in the reference: the mismatch word
        n_at(ref, 77)
        n_at(ref, 599)
        out.append((ref, qry))
    elif case == "short-refs":  # ramps alone, and no column at all
        out = [pair(r, q) for r in (0, 1, 17, 31) for q in (256, 512, 700)]
    elif case == "exact-bands":  # qlen a multiple of either band
        out = [pair(r, q) for r, q in ((300, 256), (300, 512), (512, 768),
                                       (33, 1024))]
    return [(r.tobytes(), q.tobytes()) for r, q in out]


def _offset_tensors(pairs, device):
    """pairs as one bucket on device, padded to whole 256-row bands."""
    qm = 256 * -(-max(len(q) for _, q in pairs) // 256)
    rm = 128 * -(-max(max(len(r) for r, _ in pairs), 1) // 128)
    (b,) = bucketize(PairDataset.from_pairs(pairs),
                     BucketSpec(batch_pairs=len(pairs), query_multiple=qm,
                                ref_multiple=rm))
    t = list(bucket_to_tensors(b, device))
    # bucketize pads an empty reference; give it no column again
    t[2][:b.num_real] = torch.tensor([len(r) for r, _ in pairs],
                                     dtype=torch.int32)
    return b, t


def _lnw_scores_against_plain(params, b, t, offset: bool):
    """One LNW scores launch of bucket b against the plain version, score
    for score; the launch took the gap-offset form where `offset`, and the
    counters hold its full bands' cells."""
    reset_launch_counts()
    before = rs.launches
    got = rs.fill_bucket_async(Algorithm.LNW, params, *t,
                               with_traceback=False)
    assert rs.launches == before + 1
    assert rs.launch_scores_step == rs.launch_offset_form == offset
    want = rs.fill_rowscan_reference(Algorithm.LNW, params, *t,
                                     with_traceback=False)
    torch.cuda.synchronize()
    _assert_same_rowscan(Algorithm.LNW, got, want, t[2], t[3], b.num_real)
    rlen = t[2][:b.num_real].cpu().numpy()
    qlen = t[3][:b.num_real].cpu().numpy()
    count_fill("rowscan", rlen, qlen)
    assert launch_counts()["fill_band_offset_cells"] == (
        full_band_cells(rlen, qlen, rs.launch_band_rows) if offset else 0)


@pytest.mark.parametrize("lane_rows", [4, 8])
@pytest.mark.parametrize("case", ["partial-bottom", "n-in-middle",
                                  "short-refs", "exact-bands"])
def test_lnw_offset_form_on_its_seams(cuda_device, monkeypatch, case,
                                      lane_rows):
    """LNW's scores step in the gap-offset form at each rows-a-lane, with
    the general step beside it on the boundary rows it converts back to H:
    a partial bottom band, an N in a middle band of the query and in the
    reference, references of 0-31 columns, queries a whole number of
    bands; under 3/-1/-2 and under 3/-150/-20, whose mismatch fits the
    profile's byte only shifted (before the offset form every band took
    the general step)."""
    monkeypatch.setattr(rs, "WIDE_BANDS_A_WARP",
                        0 if 32 * lane_rows == rs.WIDE_BAND_ROWS else 10**9)
    b, t = _offset_tensors(_offset_pairs(case, np.random.default_rng(61)),
                           cuda_device)
    for params in (AlignmentParams(), AlignmentParams(mismatch=-150,
                                                      gap=-20)):
        _lnw_scores_against_plain(params, b, t, offset=True)
        assert rs.launch_band_rows == 32 * lane_rows


def test_lnw_offset_form_on_a_wide_launch(cuda_device):
    """A launch of enough 4 kbp pairs that band_rows takes 256-row bands
    on its own (WIDE_BANDS_A_WARP such bands a resident warp), as the
    benchmark's buckets do: the offset form against the plain version."""
    warps = rs._resident_warps(cuda_device, Algorithm.LNW, 0,
                               rs.WIDE_BAND_ROWS)
    bands = -(-4096 // rs.WIDE_BAND_ROWS)
    count = -(-rs.WIDE_BANDS_A_WARP * warps // bands)
    ds = synthetic_dataset(count, uniform_len=4000, seed=62, sub_rate=0.01,
                           indel_rate=0.005)
    (b,) = bucketize(ds, BucketSpec(batch_pairs=count, query_multiple=4096,
                                    ref_multiple=4096))
    t = bucket_to_tensors(b, cuda_device)
    _lnw_scores_against_plain(AlignmentParams(), b, t, offset=True)
    assert rs.launch_band_rows == rs.WIDE_BAND_ROWS


@pytest.mark.parametrize("gap,offset", [(-62, True), (-63, False)])
def test_lnw_offset_form_at_the_widest_gap(cuda_device, gap, offset):
    """16 kbp pairs under 3/-1 and the widest gap whose shifted weights
    fit a byte (-62: 127 and 123) take the offset form; one more (-63:
    129) takes the general step for every band."""
    ds = synthetic_dataset(2, uniform_len=16_384, seed=63, sub_rate=0.004,
                           indel_rate=0.003)
    (b,) = bucketize(ds, BucketSpec(batch_pairs=2, query_multiple=16_640,
                                    ref_multiple=16_640))
    t = bucket_to_tensors(b, cuda_device)
    _lnw_scores_against_plain(AlignmentParams(gap=gap), b, t, offset)


@pytest.mark.parametrize("weights", [dict(match=120, gap=-10),
                                     dict(match=3, mismatch=-1, gap=-70)],
                         ids=["match-120", "gap-70"])
def test_lnw_without_the_offset_form(cuda_device, weights):
    """Weights whose shifted bytes do not fit (120 + 20, 3 + 140): every
    LNW band takes the general step, scores equal the plain version's,
    and ANW's scores step still runs (its profile unshifted)."""
    pairs = (_offset_pairs("partial-bottom", np.random.default_rng(64))
             + _offset_pairs("n-in-middle", np.random.default_rng(65)))
    b, t = _offset_tensors(pairs, cuda_device)
    params = AlignmentParams(**weights)
    _lnw_scores_against_plain(params, b, t, offset=False)
    got = rs.fill_bucket_async(Algorithm.ANW, params, *t,
                               with_traceback=False)
    assert rs.launch_scores_step and not rs.launch_offset_form
    want = rs.fill_rowscan_reference(Algorithm.ANW, params, *t,
                                     with_traceback=False)
    torch.cuda.synchronize()
    _assert_same_rowscan(Algorithm.ANW, got, want, t[2], t[3], b.num_real)


@pytest.mark.parametrize("algo,with_traceback", [(Algorithm.LSW, False),
                                                 (Algorithm.BSW, True),
                                                 (Algorithm.ANW, True)],
                         ids=["lsw-scores", "bsw-dirs", "anw-dirs"])
def test_rowscan_bucket_modes_repeat_bit_identical(cuda_device, algo,
                                                   with_traceback):
    """The main path's 2048-pair bucket (two bands a pair) 10 times: the
    same bits each time, equal to the plain version (the bands' hand-off
    and the local bests' chain would race here)."""
    b = main_path_bucket()
    t = bucket_to_tensors(b, cuda_device)
    want = rs.fill_rowscan_reference(algo, PARAMS, *t,
                                     with_traceback=with_traceback)
    for _ in range(10):
        got = rs.fill_bucket_async(algo, PARAMS, *t,
                                   with_traceback=with_traceback)
        torch.cuda.synchronize()
        _assert_same_rowscan(algo, got, want, t[2], t[3], b.num_real)


def _open_top(kind: str, n: int, device):
    if kind == "none":
        return None
    go = PARAMS.gap_open
    if kind == "zero":
        v = np.zeros(n, np.int32)
    elif kind == "go":
        v = np.full(n, go, np.int32)
    else:
        v = np.where(np.random.default_rng(4).random(n) < 0.5, 0,
                     go).astype(np.int32)
    return torch.from_numpy(v).to(device)


@pytest.mark.parametrize("algo,tb", [(Algorithm.LNW, "none"),
                                     (Algorithm.ANW, "none"),
                                     (Algorithm.ANW, "go"),
                                     (Algorithm.ANW, "zero"),
                                     (Algorithm.ANW, "mixed")],
                         ids=lambda v: getattr(v, "value", v))
def test_last_row_kernels_match_plain_version(cuda_device, algo, tb):
    """Both last-row kernels (rowscan and the stagger variant) against the
    plain version and each other, with qlen = 1 and qlen = M edges."""
    pairs = _pairs(22, 300, 1, 300, "ACGT")
    pairs[0] = (pairs[0][0], "A")
    b = _bucket(pairs)
    t = list(bucket_to_tensors(b, cuda_device))
    t[3][1] = b.padded_qry
    open_top = _open_top(tb, b.batch, cuda_device)
    before = (rs.last_rows_launches, ts.last_rows_launches)
    got_r = rs.fill_last_rows_async(algo, PARAMS, *t, open_top=open_top)
    got_s = ts.fill_stagger_last_rows_async(algo, PARAMS, *t,
                                            open_top=open_top)
    assert (rs.last_rows_launches, ts.last_rows_launches) == (
        before[0] + 1, before[1] + 1)
    want = rs.last_rows_reference(algo, PARAMS, *t, open_top=open_top)
    torch.cuda.synchronize()
    _assert_same_last_rows(got_r, want, t[2], b.num_real)
    _assert_same_last_rows(got_s, want, t[2], b.num_real)


@pytest.mark.parametrize("algo,tb", [(Algorithm.LNW, "none"),
                                     (Algorithm.ANW, "none"),
                                     (Algorithm.ANW, "go"),
                                     (Algorithm.ANW, "zero"),
                                     (Algorithm.ANW, "mixed")],
                         ids=lambda v: getattr(v, "value", v))
@pytest.mark.parametrize("qlen", ["0", "1", "32", "33", "M"])
def test_stagger_last_rows_band_seams(cuda_device, algo, tb, qlen):
    """The stagger last rows with every lane at one query length (and one
    lane with rlen = 0): row qlen of the scratch, equal to the plain last
    rows and to the row sweep's."""
    b = _bucket(_pairs(26, 40, 1, 300, "ACGT"))
    t = list(bucket_to_tensors(b, cuda_device))
    t[3].fill_(b.padded_qry if qlen == "M" else int(qlen))
    t[2][3] = 0
    open_top = _open_top(tb, b.batch, cuda_device)
    before = ts.last_rows_launches
    got = ts.fill_stagger_last_rows_async(algo, PARAMS, *t,
                                          open_top=open_top)
    assert ts.last_rows_launches == before + 1
    want = rs.last_rows_reference(algo, PARAMS, *t, open_top=open_top)
    rows = rs.fill_last_rows_async(algo, PARAMS, *t, open_top=open_top)
    torch.cuda.synchronize()
    _assert_same_last_rows(got, want, t[2], b.num_real)
    _assert_same_last_rows(got, rows, t[2], b.num_real)


LAST_ROWS_TOPS = [(Algorithm.LNW, "none"), (Algorithm.ANW, "go"),
                  (Algorithm.ANW, "zero"), (Algorithm.ANW, "mixed")]
R = 128  # rows of a band of the last-row wavefront (csrc/rowscan_fill.cu)


def _last_rows_problems(lens, device, seed):
    """Random ACGT problems of the given (qlen, rlen), padded to the
    longest of each, as the fill's (ref, qry, ref_len, qry_len)."""
    rng = np.random.default_rng(seed)
    m = max(max(q for q, _ in lens), 1)
    n = max(max(r for _, r in lens), 1)
    refs = rng.integers(0, 4, (len(lens), n)).astype(np.uint8)
    qrys = rng.integers(0, 4, (len(lens), m)).astype(np.uint8)
    # mutated copies keep the path near the diagonal, so scores vary
    qrys[:, :min(m, n)] = np.where(rng.random((len(lens), min(m, n))) < 0.8,
                                   refs[:, :min(m, n)],
                                   qrys[:, :min(m, n)])
    letters = np.frombuffer(b"ACGT", np.uint8)
    rl = np.array([r for _, r in lens], np.int32)
    ql = np.array([q for q, _ in lens], np.int32)
    return [torch.from_numpy(x).to(device)
            for x in (letters[refs], letters[qrys], rl, ql)]


def _check_last_rows(algo, tb_kind, t, device):
    open_top = _open_top(tb_kind, t[0].shape[0], device)
    before = rs.last_rows_launches
    got = rs.fill_last_rows_async(algo, PARAMS, *t, open_top=open_top)
    assert rs.last_rows_launches == before + 1
    want = rs.last_rows_reference(algo, PARAMS, *t, open_top=open_top)
    torch.cuda.synchronize()
    _assert_same_last_rows(got, want, t[2], t[0].shape[0])
    return got


@pytest.mark.parametrize("n", [8, 4096, 16384])
@pytest.mark.parametrize("qlen", [1, R - 1, R, R + 1, 4095, 8192])
@pytest.mark.parametrize("algo,tb", LAST_ROWS_TOPS,
                         ids=lambda v: getattr(v, "value", v))
def test_last_rows_band_wavefront(cuda_device, algo, tb, qlen, n):
    """The band wavefront at its row seams (a band of R rows: qlen 1,
    R-1, R, R+1) and at Hirschberg's depths, three problems of mixed
    lengths in one launch: (qlen, n), (qlen, n/3) and (qlen/2, n)."""
    lens = [(qlen, n), (qlen, max(1, n // 3)), (max(1, qlen // 2), n)]
    _check_last_rows(algo, tb, _last_rows_problems(lens, cuda_device,
                                                   qlen + n), cuda_device)


@pytest.mark.parametrize("batch", [1, 2, 128])
@pytest.mark.parametrize("algo,tb", LAST_ROWS_TOPS,
                         ids=lambda v: getattr(v, "value", v))
def test_last_rows_many_problems(cuda_device, algo, tb, batch):
    """1, 2 and 128 problems of random lengths in one launch, with a
    qlen = 0 and an rlen = 0 problem among the 128."""
    rng = np.random.default_rng(batch)
    lens = [(int(rng.integers(1, 700)), int(rng.integers(1, 900)))
            for _ in range(batch)]
    if batch == 128:
        lens[5] = (0, 300)
        lens[9] = (400, 0)
    _check_last_rows(algo, tb, _last_rows_problems(lens, cuda_device, batch),
                     cuda_device)


@pytest.mark.parametrize("algo,tb", LAST_ROWS_TOPS,
                         ids=lambda v: getattr(v, "value", v))
def test_last_rows_split_level_shape(cuda_device, algo, tb):
    """A top split level of a 16,384 x 4,096 pair: 2 problems of 8,192
    rows x 4,096 columns."""
    lens = [(8192, 4096), (8192, 4096)]
    _check_last_rows(algo, tb, _last_rows_problems(lens, cuda_device, 7),
                     cuda_device)


@pytest.mark.parametrize("algo,tb", [(Algorithm.LNW, "none"),
                                     (Algorithm.ANW, "mixed")],
                         ids=lambda v: getattr(v, "value", v))
def test_last_rows_repeat_bit_identical(cuda_device, algo, tb):
    """One launch repeated 20 times gives the same bits each time (the
    bands' hand-off races would show here), equal to the plain version."""
    lens = [(8192, 4096), (5000, 4000), (300, 4096), (8000, 17)]
    t = _last_rows_problems(lens, cuda_device, 11)
    first = _check_last_rows(algo, tb, t, cuda_device)
    open_top = _open_top(tb, len(lens), cuda_device)
    for _ in range(20):
        again = rs.fill_last_rows_async(algo, PARAMS, *t, open_top=open_top)
        torch.cuda.synchronize()
        _assert_same_last_rows(again, first, t[2], len(lens))


@pytest.mark.parametrize("algo,mode", [(Algorithm.LNW, "last"),
                                       (Algorithm.ANW, "last"),
                                       (Algorithm.LSW, "scores"),
                                       (Algorithm.ANW, "dirs"),
                                       (Algorithm.BSW, "dirs")],
                         ids=lambda v: getattr(v, "value", v))
def test_rowscan_kernel_wide_references(cuda_device, algo, mode):
    """Wide references through the band wavefront, one band a problem:
    60,000 columns (scores, LNW's last rows), 30,000 (ANW's last rows)
    and 20,000 (dirs), with a qlen = 1 problem and a short one."""
    rng = np.random.default_rng(23)
    n = {"last": 60000 if algo is Algorithm.LNW else 30000,
         "scores": 60000, "dirs": 20000}[mode]
    b, m = 3, 24
    refs = torch.from_numpy(rng.integers(65, 69, (b, n)).astype(np.uint8))
    qrys = torch.from_numpy(rng.integers(65, 69, (b, m)).astype(np.uint8))
    rl = torch.tensor([n, n - 7, n // 3], dtype=torch.int32)
    ql = torch.tensor([m, 1, m - 5], dtype=torch.int32)
    t = [x.to(cuda_device) for x in (refs, qrys, rl, ql)]
    if mode == "last":
        got = rs.fill_last_rows_async(algo, PARAMS, *t)
        want = rs.last_rows_reference(algo, PARAMS, *t)
        torch.cuda.synchronize()
        _assert_same_last_rows(got, want, t[2], b)
    else:
        tb_on = mode == "dirs"
        got = rs.fill_bucket_async(algo, PARAMS, *t, with_traceback=tb_on)
        want = rs.fill_rowscan_reference(algo, PARAMS, *t,
                                         with_traceback=tb_on)
        torch.cuda.synchronize()
        _assert_same_rowscan(algo, got, want, t[2], t[3], b)


@pytest.mark.parametrize("affine", [False, True])
def test_split_reduce_kernel_matches_plain_version(cuda_device, affine):
    """Random last rows with ties (values from a small set), sentinel
    entries, an all-sentinel sub and subs of every width up to n."""
    rng = np.random.default_rng(24)
    k, n = 300, 700
    last = rng.integers(-6, 3, (n, 2 * k)).astype(np.int32)
    last[rng.random((n, 2 * k)) < 0.1] = -(2**30)
    last[:, 4:6] = -(2**30)
    flast = np.where(rng.random((n, 2 * k)) < 0.5, -(2**30), last - 2)
    nn = rng.integers(0, n + 1, k).astype(np.int32)
    fhb, bhb = (rng.integers(-5, 1, k).astype(np.int32) for _ in range(2))
    go = np.full(k, PARAMS.gap_open, np.int32)
    args = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda_device)
            for x in (last, flast.astype(np.int32), fhb, bhb, nn, go)]
    if not affine:
        args[1] = None
    before = th.launches
    got = th.split_reduce(*args)
    assert th.launches == before + 1
    want = th.split_reduce_reference(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("k,n,kind", SPLIT_REDUCE_SHAPES)
def test_split_reduce_kernel_on_grid_shapes(cuda_device, k, n, kind, affine):
    """The shapes the kernel's grid splits differently (one subproblem,
    K no multiple of 32, a part-full last chunk, maxima tied across
    chunks): one launch, equal to the plain version."""
    last, flast, fhb, bhb, nn, go = (
        torch.from_numpy(x).to(cuda_device)
        for x in split_reduce_inputs(k, n, kind))
    before = th.launches
    got = th.split_reduce(last, flast if affine else None, fhb, bhb, nn, go)
    assert th.launches == before + 1
    want = th.split_reduce_reference(last, flast if affine else None, fhb,
                                     bhb, nn, go)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_split_reduce_kernel_repeats_bit_identical(cuda_device):
    """Back-to-back launches of every shape share the ticket counters:
    each leaves them at 0 for the next."""
    args = []
    for k, n, kind in SPLIT_REDUCE_SHAPES:
        x = [torch.from_numpy(v).to(cuda_device)
             for v in split_reduce_inputs(k, n, kind, seed=k)]
        args += [x, [x[0], None, *x[2:]]]
    first = [th.split_reduce(*a) for a in args]
    for _ in range(3):
        again = [th.split_reduce(*a) for a in args]
        torch.cuda.synchronize()
        assert all(torch.equal(f, g) for f, g in zip(first, again))


@pytest.mark.parametrize("algo", [Algorithm.LNW, Algorithm.LSW,
                                  Algorithm.ANW], ids=lambda a: a.value)
@pytest.mark.parametrize("last_rows", ["rowscan", "stagger"])
def test_hirschberg_on_the_card_matches_the_plain_run(cuda_device, algo,
                                                      last_rows, monkeypatch):
    """Every kernel of the path on the card gives the same bytes as the
    plain versions on CPU: 6 pairs of 150-400 bp, one flipped, leaf_q 32."""
    pairs = [(a, q) for a, q in _pairs(25, 6, 150, 400, "ACGT")]
    pairs[1] = (pairs[1][0] * 2, pairs[1][1][:90])
    monkeypatch.setattr(th, "LAST_ROWS_KERNEL", last_rows)
    reset_launch_counts()
    got = th.hirschberg_align_batch(algo, PARAMS, pairs, leaf_q=32,
                                    device=cuda_device)
    counts = launch_counts()
    want = th.hirschberg_align_batch(algo, PARAMS, pairs, leaf_q=32,
                                     device="cpu")
    assert [r.block() for r in got] == [r.block() for r in want]
    # the fill counters count every fill launch: the split levels' last
    # rows, LSW's end points and the leaves
    assert counts[f"{last_rows}_last_rows"] > 0
    assert counts["fill_counted"] == sum(counts[k] for k in FILL_COUNTS)
    assert counts["fill_warps"] >= counts["fill_pairs"] > 0


def test_fill_counters_equal_the_buckets(cuda_device):
    """After a scores-only LNW engine run the fill counters hold, a
    launch a bucket, each bucket's real pairs (a warp each), its cells
    and its largest pair's cells."""
    from tpu_align_torch.runtime.engine import AlignmentEngine

    ds = synthetic_dataset(5000, min_len=20, max_len=400, seed=7)
    engine = AlignmentEngine(Algorithm.LNW, device="cuda",
                             with_traceback=False, output="blocks")
    buckets = engine._buckets_of(ds)
    engine.warmup(ds)
    reset_launch_counts()
    engine.run(ds)
    counts = launch_counts()
    cells = [b.ref_len[:b.num_real].astype(np.int64) * b.qry_len[:b.num_real]
             for b in buckets]
    assert counts["fill_counted"] == counts["stagger_fill"] == len(buckets)
    assert counts["fill_pairs"] == counts["fill_warps"] == len(ds)
    assert counts["fill_cells"] == sum(int(c.sum()) for c in cells) \
        == ds.num_cells
    assert counts["fill_chain_cells"] == sum(int(c.max()) for c in cells)


def test_auto_puts_few_long_pairs_on_the_band_wavefront(cuda_device):
    """kernel="auto", scores only: 8 pairs of about 16 kbp (HiFi-like, a
    bucket or a few, each far from filling the card one warp a pair) go
    to the band wavefront, and their scores equal kernel="stagger"'s; a
    2,048 x 250 bp bucket stays on the stagger fill."""
    from tpu_align_torch.runtime.engine import AlignmentEngine

    def run(ds, kernel):
        engine = AlignmentEngine(Algorithm.LNW, device="cuda",
                                 with_traceback=False, output="blocks",
                                 kernel=kernel)
        engine.warmup(ds)
        reset_launch_counts()
        out = engine.run(ds)
        torch.cuda.synchronize()
        return out.scores(), launch_counts(), len(engine._buckets_of(ds))

    long = synthetic_dataset(8, uniform_len=16_384, seed=18,
                             sub_rate=0.004, indel_rate=0.003)
    scores, counts, buckets = run(long, "auto")
    assert counts["rowscan_fill"] == buckets > 0
    assert counts["stagger_fill"] == 0
    want, counts, _ = run(long, "stagger")
    assert counts["stagger_fill"] == buckets and counts["rowscan_fill"] == 0
    np.testing.assert_array_equal(scores, want)
    reads = synthetic_dataset(2048, uniform_len=250, seed=18, sub_rate=0.05,
                              indel_rate=0.0)
    _, counts, buckets = run(reads, "auto")
    assert counts["stagger_fill"] == buckets == 1
    assert counts["rowscan_fill"] == 0


def _benchmark_reference():
    """benchmarks/reference.py, the benchmark's plain PyTorch reference,
    imported inside the tests that compare with it."""
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from benchmarks import reference

    return reference


def test_anw_long_pairs_on_the_band_wavefront(cuda_device):
    """The card twin of tests/test_torch_anw_long.py: ANW, scores only,
    kernel="auto", 8 HiFi-like pairs of 16,384 bp go to the band
    wavefront alone, and each score is the benchmark's plain reference's
    (benchmarks/reference.py, on the card).  The B2 counters count each
    launch with its persistent warps."""
    from tpu_align_torch.runtime.engine import AlignmentEngine

    reference = _benchmark_reference()
    params = AlignmentParams(match=3, mismatch=-1, gap_open=-4,
                             gap_extend=-1)
    ds = synthetic_dataset(8, uniform_len=16_384, seed=19, sub_rate=0.004,
                           indel_rate=0.003)
    engine = AlignmentEngine(Algorithm.ANW, params, device="cuda",
                             with_traceback=False, output="blocks")
    buckets = engine._buckets_of(ds)
    engine.warmup(ds)
    reset_launch_counts()
    scores = engine.run(ds).scores()
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["rowscan_fill"] == len(buckets) > 0
    assert counts["stagger_fill"] == 0
    assert counts["fill_band_counted"] == counts["rowscan_fill"]
    # at most a warp a (128-row band, row) item, in whole blocks of 4
    items = max(-(-b.qry_tokens.shape[1] // 128) * b.qry_tokens.shape[0]
                for b in buckets)
    warps = counts["fill_band_warps_max"]
    assert 0 < warps <= 4 * -(-items // 4)
    cells = sum(int(b.ref_len[:b.num_real].astype(np.int64)
                    @ b.qry_len[:b.num_real]) for b in buckets)
    assert counts["fill_band_warp_cells"] >= cells / warps * (1 - 1e-12)
    if len(buckets) == 1:
        assert counts["fill_band_warp_cells"] == pytest.approx(cells / warps)
    pairs = [(ds.reference_bytes(i).tobytes(), ds.query_bytes(i).tobytes())
             for i in range(len(ds))]
    scoring = dict(match=3, mismatch=-1, gap=-2, gap_open=-4, gap_extend=-1,
                   band=16)
    want = reference.scores("anw", scoring, pairs, "cuda")
    np.testing.assert_array_equal(scores, want)


# (reference length, query length, plants, reference copies) of
# utils/synthetic.py planted_local_pair at the published length, 128
# bands of 128 rows: the best in band 0, band 40, band 100 (a query of
# 16,421 rows, a partial bottom band below it), tied across bands 30 and
# 90 (one reference window ends both rows), tied inside row 8,000 (the
# window twice in the reference), and in a partial bottom band
LSW_LONG_PLANTS = [
    (16_384, 16_384, [(100, 9000, 100)], ()),
    (16_384, 16_384, [(40 * 128 + 64, 12_000, 3000)], ()),
    (16_384, 16_421, [(100 * 128 + 5, 14_000, 5000)], ()),
    (16_384, 16_384, [(30 * 128 + 100, 8000, 2000),
                      (90 * 128 + 17, 8000, 2000)], ()),
    (16_384, 16_384, [(8000, 5000, 3000)], ((5000, 15_000, 3000),)),
    (16_384, 16_300, [(16_290, 16_384, 4000)], ()),
]
LSW_SCORING = dict(match=3, mismatch=-1, gap=-2, gap_open=-4, gap_extend=-1,
                   band=16)


def _lsw_long_pairs():
    from tpu_align_torch.utils.synthetic import planted_local_pair

    return [planted_local_pair(r, q, p, seed=90 + k, ref_copies=c)
            for k, (r, q, p, c) in enumerate(LSW_LONG_PLANTS)]


def _end_cells(filled, n):
    return [tuple(int(x) for x in cell) for cell in
            zip(*(filled[k][:n].tolist() for k in range(3)))]


def test_lsw_local_best_at_the_published_length(cuda_device):
    """LSW scores at 16,384 x ~16,384 bp, one B2 launch in the wrapper's
    own band size (128 rows: LSW has no 8-row build), so the best crosses
    up to 128 bands through the (bands, B, 3) scratch: score, srow and scol
    bit for bit the benchmark's plain reference's on the card, for bests
    planted in bands 0, 40 and 100, tied across bands 30 and 90 (the first
    band wins) and inside a row (the first column wins), and in a partial
    bottom band.  The kernel's own count of the scores step's cells
    (fill_band_scores_cells) is every full band's cells: the bucket holds
    bases alone."""
    reference = _benchmark_reference()
    pairs = _lsw_long_pairs()
    filled = reference.fill("lsw", LSW_SCORING,
                            *reference.tokens(pairs, "cuda"),
                            with_dirs=False)
    want = _end_cells([filled[k] for k in ("score", "srow", "scol")],
                      len(pairs))
    bands = [(srow - 1) // 128 for _, srow, _ in want]
    assert bands == [0, 40, 100, 30, 62, 127]
    # the ties are ties: past the first cell's plant, the later cell
    # scores the best too
    (ref, qry), (ref2, qry2) = pairs[3], pairs[4]
    cut = reference.fill("lsw", LSW_SCORING, *reference.tokens(
        [(ref, qry[4000:90 * 128 + 17]), (ref2[5000:], qry2[:8000])],
        "cuda"), with_dirs=False)
    assert _end_cells([cut[k] for k in ("score", "srow", "scol")], 2) == [
        (want[3][0], 90 * 128 + 17 - 4000, 8000),
        (want[4][0], 8000, 10_000)]
    b, t = _offset_tensors(pairs, cuda_device)
    params = AlignmentParams(**{k: LSW_SCORING[k]
                                for k in ("match", "mismatch", "gap")})
    reset_launch_counts()
    before = rs.launches
    got = rs.fill_bucket_async(Algorithm.LSW, params, *t,
                               with_traceback=False)
    assert rs.launches == before + 1
    assert rs.launch_band_rows == 128 and rs.launch_scores_step
    torch.cuda.synchronize()
    assert _end_cells(got, b.num_real) == want
    rlen = t[2][:b.num_real].cpu().numpy()
    qlen = t[3][:b.num_real].cpu().numpy()
    full = full_band_cells(rlen, qlen, 128)
    assert launch_counts()["fill_band_scores_cells"] == full
    # the plain version agrees, and adds nothing to the count
    plain = rs.fill_rowscan_reference(Algorithm.LSW, params, *t,
                                      with_traceback=False)
    assert _end_cells(plain, b.num_real) == want
    assert launch_counts()["fill_band_scores_cells"] == full


def test_scores_step_cells_count_none_where_every_band_holds_an_n(
        cuda_device):
    """The kernel counts only the band items that take the scores step: a
    bucket whose every band holds an N takes the general step throughout
    and counts 0, with its end cells the reference's still; the same
    bucket of bases alone counts every full band's cells, launch after
    launch, and reset_launch_counts zeroes the count."""
    reference = _benchmark_reference()
    pairs = []
    for ref, qry in _lsw_long_pairs()[:3]:
        q = bytearray(qry)
        q[64::128] = b"N" * len(q[64::128])  # row 65 of every band
        pairs.append((ref, bytes(q)))
    filled = reference.fill("lsw", LSW_SCORING,
                            *reference.tokens(pairs, "cuda"),
                            with_dirs=False)
    want = _end_cells([filled[k] for k in ("score", "srow", "scol")],
                      len(pairs))
    params = AlignmentParams()
    b, t = _offset_tensors(pairs, cuda_device)
    reset_launch_counts()
    got = rs.fill_bucket_async(Algorithm.LSW, params, *t,
                               with_traceback=False)
    torch.cuda.synchronize()
    assert _end_cells(got, b.num_real) == want
    assert launch_counts()["fill_band_scores_cells"] == 0
    b, t = _offset_tensors(_lsw_long_pairs()[:3], cuda_device)
    rlen = t[2][:b.num_real].cpu().numpy()
    qlen = t[3][:b.num_real].cpu().numpy()
    full = 0
    for algo in (Algorithm.LSW, Algorithm.LNW, Algorithm.ANW):
        rs.fill_bucket_async(algo, params, *t, with_traceback=False)
        assert rs.launch_scores_step
        full += full_band_cells(rlen, qlen, rs.launch_band_rows)
    assert launch_counts()["fill_band_scores_cells"] == full > 0
    reset_launch_counts()
    assert launch_counts()["fill_band_scores_cells"] == 0


def test_lsw_long_pairs_on_the_band_wavefront(cuda_device):
    """The card twin of tests/test_torch_lsw_long.py: LSW, scores only,
    kernel="auto", 8 HiFi-like pairs of 16,384 bp go to the band
    wavefront alone, each score is the benchmark's plain reference's, and
    through the fill the engine gives each bucket (fill_sharded) so is
    each end cell; the kernel counted the scores step's cells, every full
    band's, which hold over 99 % of the cells."""
    from tpu_align_torch.distributed import fill_sharded
    from tpu_align_torch.runtime.engine import AlignmentEngine

    reference = _benchmark_reference()
    params = AlignmentParams(match=3, mismatch=-1, gap=-2)
    ds = synthetic_dataset(8, uniform_len=16_384, seed=24, sub_rate=0.004,
                           indel_rate=0.003)
    engine = AlignmentEngine(Algorithm.LSW, params, device="cuda",
                             with_traceback=False, output="blocks")
    buckets = engine._buckets_of(ds)
    engine.warmup(ds)
    reset_launch_counts()
    scores = engine.run(ds).scores()
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["rowscan_fill"] == counts["fill_band_counted"] == \
        len(buckets) > 0
    assert counts["stagger_fill"] == 0
    full = sum(full_band_cells(b.ref_len[:b.num_real], b.qry_len[:b.num_real],
                               128) for b in buckets)
    assert counts["fill_band_scores_cells"] == full
    assert full > 0.99 * counts["fill_cells"]
    pairs = [(ds.reference_bytes(i).tobytes(), ds.query_bytes(i).tobytes())
             for i in range(len(ds))]
    filled = reference.fill("lsw", LSW_SCORING,
                            *reference.tokens(pairs, "cuda"),
                            with_dirs=False)
    want = _end_cells([filled[k] for k in ("score", "srow", "scol")],
                      len(pairs))
    np.testing.assert_array_equal(scores, [w[0] for w in want])
    got = {}
    for b in buckets:
        outs = fill_sharded(engine.mesh, Algorithm.LSW, params,
                            b.ref_tokens, b.qry_tokens, b.ref_len,
                            b.qry_len, with_traceback=False, kernel="auto")
        cells = _end_cells([torch.cat(o).cpu() for o in outs[:3]],
                           b.num_real)
        got.update(zip(b.pair_ids[:b.num_real].tolist(), cells))
    assert [got[i] for i in range(len(pairs))] == want


def test_cuda_engine_gathers_buckets_into_pinned_memory(cuda_device):
    """A CUDA engine's buckets hold their tokens in page-locked torch
    tensors, whose numpy views are the bucket's token arrays; a CPU
    engine's are plain numpy."""
    from tpu_align_torch.runtime.engine import AlignmentEngine

    ds = synthetic_dataset(64, min_len=20, max_len=300, seed=21)
    spec = BucketSpec(batch_pairs=16)
    buckets = AlignmentEngine(Algorithm.LNW, bucket_spec=spec,
                              device="cuda")._buckets_of(ds)
    plain = AlignmentEngine(Algorithm.LNW, bucket_spec=spec,
                            device="cpu")._buckets_of(ds)
    assert len(buckets) == len(plain) > 1
    for b, p in zip(buckets, plain):
        assert p.pinned is None
        for t, arr, want in zip(b.pinned, (b.ref_tokens, b.qry_tokens),
                                (p.ref_tokens, p.qry_tokens)):
            assert t.is_pinned() and t.dtype == torch.uint8
            assert arr.ctypes.data == t.data_ptr() and arr.shape == t.shape
            np.testing.assert_array_equal(arr, want)


def test_pinned_bucket_uploads_without_a_staging_copy(cuda_device,
                                                      monkeypatch):
    """Every bucket a CUDA engine run gathers crosses the bus from the
    tensors it was gathered into: each H2D copy of tokens has the
    gathered tensor's data_ptr for its source, and no token array takes a
    pin_memory staging copy.  The scores are the plain run's."""
    from tpu_align_torch.runtime.engine import AlignmentEngine

    ds = synthetic_dataset(96, min_len=20, max_len=300, seed=22)
    kwargs = dict(bucket_spec=BucketSpec(batch_pairs=16),
                  with_traceback=False, output="blocks")
    engine = AlignmentEngine(Algorithm.LNW, device="cuda", **kwargs)
    engine.warmup(ds)
    gathered, sources, staged = [], [], []
    gather, to, pin = engine._gather, torch.Tensor.to, torch.Tensor.pin_memory

    def spy_gather(*args):
        gathered.append(gather(*args))  # kept: no block is reused
        return gathered[-1]

    def spy_to(self, *args, **kw):
        out = to(self, *args, **kw)
        if (self.device.type, out.device.type, self.dtype) == (
                "cpu", "cuda", torch.uint8):
            sources.append(self.data_ptr())
        return out

    def spy_pin(self, *args, **kw):
        staged.append(self.dtype)
        return pin(self, *args, **kw)

    monkeypatch.setattr(engine, "_gather", spy_gather)
    monkeypatch.setattr(torch.Tensor, "to", spy_to)
    monkeypatch.setattr(torch.Tensor, "pin_memory", spy_pin)
    scores = engine.run(ds).scores()
    torch.cuda.synchronize()
    monkeypatch.undo()
    assert len(gathered) > 1
    assert {t.data_ptr() for b in gathered for t in b.pinned} <= set(sources)
    assert torch.uint8 not in staged
    want = AlignmentEngine(Algorithm.LNW, device="cpu", **kwargs).run(ds)
    np.testing.assert_array_equal(scores, want.scores())


@pytest.mark.parametrize("max_inflight", [1, 4])
def test_back_to_back_runs_reuse_pinned_blocks(cuda_device, max_inflight):
    """Two runs of one CUDA engine on two datasets, back to back: the
    second gathers into the pinned blocks the first gave back.  Blocks
    and scores of each equal the plain version's."""
    from tpu_align_torch.runtime.engine import AlignmentEngine

    kwargs = dict(bucket_spec=BucketSpec(batch_pairs=32), output="blocks")
    engine = AlignmentEngine(Algorithm.LNW, device="cuda",
                             max_inflight=max_inflight, **kwargs)
    plain = AlignmentEngine(Algorithm.LNW, device="cpu", **kwargs)
    runs = [synthetic_dataset(160, min_len=20, max_len=300, seed=seed)
            for seed in (23, 24)]
    got = [engine.run(ds) for ds in runs]
    torch.cuda.synchronize()
    for ds, out in zip(runs, got):
        want = plain.run(ds)
        assert out.output_bytes() == want.output_bytes()
        np.testing.assert_array_equal(out.scores(), want.scores())


@pytest.mark.parametrize("name", dpx.OPS)
def test_dpx_kernel_matches_plain_version(cuda_device, name):
    """Random words and every triple of edge words through the kernel
    and the plain version on the card: equal bits and predicates."""
    rng = np.random.default_rng(0)
    edges = np.array([0, 1, 0xFFFFFFFF, 0x7FFFFFFF, 0x80000000, 0x7FFF,
                      0x8000, 0xFFFF, 0x7FFF7FFF, 0x80008000], np.uint64)
    grid = np.stack(np.meshgrid(edges, edges, edges)).reshape(3, -1)
    words = np.concatenate(
        [rng.integers(0, 2**32, (3, 1 << 16), dtype=np.uint64), grid],
        axis=1).astype(np.uint32).view(np.int32)
    nargs = dpx._TABLE[name][1]
    args = [torch.from_numpy(w.copy()).to(cuda_device)
            for w in words[:nargs]]
    if dpx._TABLE[name][0] != "s32":
        args = [a.view(torch.uint32) for a in args]
    before = dpx.launches
    got = dpx.apply(name, *args)
    assert dpx.launches == before + 1
    want = dpx.reference(name, *args)
    torch.cuda.synchronize()
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    assert got[0].dtype == want[0].dtype
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("steps", [1, 7, 70])
@pytest.mark.parametrize("packed", [False, True], ids=["int32", "s16x2"])
@pytest.mark.parametrize("kind", ["small", "full"])
def test_s16x2_core_kernel_matches_plain_version(cuda_device, packed, kind,
                                                 steps):
    """Both variants at an odd width (a ragged last block), on the
    script's inputs and on whole-range int32 words (halves and int32 adds
    wrap): after 1 and 7 steps, before the script's inputs reach their
    fixed point, and after 70, past it."""
    rng = np.random.default_rng(1)
    b = 1000
    x = (exp_s16x2.inputs(b) if kind == "small" else
         rng.integers(-2**31, 2**31, (exp_s16x2.S, b)).astype(np.int32))
    x = torch.from_numpy(x).to(cuda_device)
    before = exp_s16x2.packed_launches + exp_s16x2.int32_launches
    got = exp_s16x2.run_core(x, packed, steps)
    assert exp_s16x2.packed_launches + exp_s16x2.int32_launches == before + 1
    want = exp_s16x2.run_core_reference(x, packed, steps)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("tree,algo", [("lnw-all", "lnw"), ("lsw-all", "lsw")])
def test_all_paths_goldens_through_the_cli_on_the_card(cuda_device, tmp_path,
                                                       tree, algo):
    """-all-paths fills and walks on the host; -device cuda must still give
    the goldens byte for byte."""
    d = os.path.join(GOLDENS, tree)
    out = tmp_path / "out.txt"
    assert cli_main(["-pairs", os.path.join(d, "input-data.txt"),
                     "-algorithm", algo, "-all-paths", "-device", "cuda",
                     "-out", str(out)]) == 0
    with open(os.path.join(d, "align-output.txt"), "rb") as f:
        assert out.read_bytes() == f.read()


def test_hw_parity_on_the_card(cuda_device):
    """All 14 configurations over 1,024 mixed-length pairs (one bucket a
    length class), full text equal to the oracle, each through its
    kernels (hw_parity fails a configuration whose launches fall short)."""
    from tpu_align_torch.scripts import hw_parity

    rec = hw_parity.run(1024, device="cuda", log=lambda s: None)
    assert [r["ok"] for r in rec["configs"]] == [True] * 14
    assert rec["card"]["name"] and rec["card"]["power_limit"]


@pytest.mark.parametrize("fuzzer,seeds", [("fuzz_engine", (5000, 5002)),
                                          ("fuzz_sweep", (100, 104))])
def test_fuzzers_on_the_card(cuda_device, fuzzer, seeds):
    import importlib

    mod = importlib.import_module(f"tpu_align_torch.scripts.{fuzzer}")
    rec = mod.run(seeds, "cuda", log=lambda s: None)
    assert rec["failures"] == []
    assert all(rec["launches"][k] for k in ("stagger_fill", "banded_fill",
                                            "rowscan_fill", "walk",
                                            "compact"))


@pytest.mark.parametrize("algo,traceback", [
    (Algorithm.LNW, "device"), (Algorithm.ANW, "device"),
    (Algorithm.BSW, "device"), (Algorithm.LNW, "host"),
], ids=lambda c: getattr(c, "value", c))
def test_mesh_engine_on_the_card_matches_one_device(cuda_device, algo,
                                                    traceback):
    """A 2-shard mesh of the one card, after warmup: 4,096 pairs in
    buckets of up to 2,048 (the mutations' length spread makes three),
    each shard's fill (and walk and compaction) launched once a bucket,
    the blocks byte-identical to the one-device run."""
    from tpu_align_torch.distributed import make_pairs_mesh
    from tpu_align_torch.runtime.engine import AlignmentEngine

    ds = synthetic_dataset(4096, uniform_len=250, seed=42)
    one = AlignmentEngine(algo, device="cuda", traceback=traceback,
                          output="blocks").run(ds)
    mesh = make_pairs_mesh([cuda_device, cuda_device])
    assert mesh.devices == (torch.device("cuda", 0),) * 2
    engine = AlignmentEngine(algo, device="cuda", traceback=traceback,
                             output="blocks", mesh=mesh)
    buckets = engine._buckets_of(ds)
    assert buckets[0].batch == 2048
    assert all(b.batch % 16 == 0 for b in buckets)
    engine.warmup(ds)
    reset_launch_counts()
    out = engine.run(ds)
    counts = launch_counts()
    fill = "banded_fill" if algo.is_banded else "stagger_fill"
    walks = 2 * len(buckets) if traceback == "device" else 0
    assert (counts[fill], counts["walk"], counts["compact"]) == (
        2 * len(buckets), walks, walks)
    assert out.output_bytes() == one.output_bytes()


def test_mesh_of_every_card_and_global_stats(cuda_device, tmp_path,
                                             capsys):
    from tpu_align_torch.distributed import (
        fill_sharded,
        global_stats,
        make_pairs_mesh,
    )

    mesh = make_pairs_mesh()
    assert mesh.size == torch.cuda.device_count()
    b = main_path_bucket()
    scores = fill_sharded(make_pairs_mesh(["cuda", "cuda"]), Algorithm.LSW,
                          PARAMS, b.ref_tokens, b.qry_tokens, b.ref_len,
                          b.qry_len, with_traceback=False)[0]
    assert all(s.device.type == "cuda" for s in scores)
    host = torch.cat([s.cpu() for s in scores]).numpy()
    cells = b.ref_len.astype(np.int64) * b.qry_len
    assert global_stats(make_pairs_mesh(["cuda", "cuda"]), scores,
                        cells) == (int(host.max()), int(cells.sum()))
    n = torch.cuda.device_count() + 1
    path = tmp_path / "pairs.txt"
    path.write_text("0\nACGT\nAGT\n")
    assert cli_main(["-pairs", str(path), "-mesh", str(n)]) == 2
    assert f"-mesh {n}: only {n - 1} devices visible" in \
        capsys.readouterr().err
