"""The port's Python traceback paths against the JAX package's.

The same pairs (drawn from a numpy seed: mixed lengths up to 96 bp within
a bucket, tie-rich "AC" pairs, local lanes that score 0, mutated copies)
are filled by the port's plain fills in all three dirs layouts: the
stagger fill (LNW, LSW, ANW at S = 32 and 7), the banded fill (BSW at
bands 1, 3 and 16) and the row-sweep fill (all four aligners).  Those
words go to both packages, as numpy arrays, and every comparison is
exact:
  * the three decoders' (main, e, f) direction matrices;
  * the NumPy host walk (traceback_bucket(use_native=False)) against the
    JAX package's and against the port's native walk;
  * the moves mode's lane sequences (no-move codes dropped), the Python
    replay's pieces (moves_to_result, _events_to_codes), and the one-call
    device_traceback_bucket with the native and the Python replay, in
    moves form (dispatched by the call or handed to it), events and
    forced stream form, against the JAX package's;
  * with the native library made unloadable, the native paths raise and
    only use_native=False runs.
"""

import dataclasses

import numpy as np
import pytest
import torch

import tpu_align.core.params as jp
import tpu_align.io as jio
from tpu_align.kernels.fill import BucketFill as JaxFill
from tpu_align.traceback import device as jd
from tpu_align.traceback import host as jh
from tpu_align_torch import Algorithm, AlignmentParams
from tpu_align_torch.convert import bucket_to_tensors, fill_to_numpy
from tpu_align_torch.io import BucketSpec, PairDataset, bucketize
from tpu_align_torch.kernels import banded as tb
from tpu_align_torch.kernels import fill as tf
from tpu_align_torch.kernels import stagger as ts
from tpu_align_torch.native import binding
from tpu_align_torch.traceback import device as td
from tpu_align_torch.traceback import host as th
from tpu_align_torch.utils.synthetic import synthetic_dataset

PARAMS = AlignmentParams()
ALGOS = list(Algorithm)
STRIPE = 32


def _pairs(seed: int = 0x9A17):
    rng = np.random.default_rng(seed)

    def dna(n, alphabet="ACGT"):
        return "".join(rng.choice(list(alphabet), n))

    pairs = [(dna(int(rng.integers(1, 97))), dna(int(rng.integers(1, 97))))
             for _ in range(30)]
    pairs += [(dna(int(rng.integers(2, 41)), "AC"),
               dna(int(rng.integers(2, 41)), "AC")) for _ in range(8)]
    # local lanes that score 0 (no common letter), and long exact runs
    pairs += [("AAAA", "TTTT"), ("A", "C"), ("GGGGGG", "CC"),
              ("T" * 96, "G" * 40), ("ACGT" * 24, "ACGT" * 24),
              ("A" * 96, "A" * 50), ("ACGTACGTACGT", "ACG"),
              ("ACG", "ACGTACGTACGT")]
    return pairs


_mutated = synthetic_dataset(24, min_len=20, max_len=90, seed=5)
BUCKETS = {
    "mixed": _pairs(),
    # mutated copies: few indels a lane, so every aligner's walk stays in
    # events mode
    "mutated": [_mutated.pair(k) for k in range(len(_mutated))],
}
SPEC = dict(batch_pairs=64, query_multiple=128, ref_multiple=128)

# (algorithm, layout) of every fill whose words are decoded and walked
LAYOUTS = ([(a, {"stripe_s": s})
            for a in (Algorithm.LNW, Algorithm.LSW, Algorithm.ANW)
            for s in (STRIPE, 7)]
           + [(Algorithm.BSW, {"band": band}) for band in (1, 3, 16)]
           + [(a, {"rowscan": True}) for a in ALGOS])
CASES = [(a, layout, name) for a, layout in LAYOUTS for name in BUCKETS]


def _case_id(case):
    algo, layout, name = case
    (key, value), = layout.items()
    tag = {"stripe_s": f"S{value}", "band": f"band{value}",
           "rowscan": "rowscan"}[key]
    return f"{algo.value}-{tag}-{name}"


def _params(algo, layout):
    return AlignmentParams(band=layout["band"]) if "band" in layout \
        else PARAMS


def _jax(algo):
    return jp.Algorithm(algo.value)


def _jax_params(params):
    return jp.AlignmentParams(**dataclasses.asdict(params))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain fills' many small torch ops gain nothing from intra-op
    threads, which would only contend with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def buckets():
    out = {}
    for name, pairs in BUCKETS.items():
        (b,) = bucketize(PairDataset.from_pairs(pairs), BucketSpec(**SPEC))
        assert b.num_real == len(pairs)
        out[name] = b
    return out


@pytest.fixture(scope="module")
def jax_buckets():
    """The same pairs through the JAX package's own bucketize."""
    return {name: jio.bucketize(jio.PairDataset.from_pairs(pairs),
                                jio.BucketSpec(**SPEC))[0]
            for name, pairs in BUCKETS.items()}


def _plain_fill(algo, params, tensors, layout):
    if "band" in layout:
        return tb.fill_banded_reference(algo, params, *tensors)
    if "rowscan" in layout:
        return tf.fill_rowscan_reference(algo, params, *tensors)
    return ts.fill_stagger_reference(algo, params, *tensors,
                                     stripe_s=layout["stripe_s"])


@pytest.fixture(scope="module")
def fills(buckets):
    """case -> the port's host BucketFill of its plain fill."""
    tensors = {name: bucket_to_tensors(b, "cpu")
               for name, b in buckets.items()}
    return {(a, tuple(layout.items()), name): fill_to_numpy(
        *_plain_fill(a, _params(a, layout), tensors[name], layout),
        **layout) for a, layout, name in CASES}


def _fill_of(fills, case):
    algo, layout, name = case
    return fills[(algo, tuple(layout.items()), name)]


def _jax_fill(fill):
    return JaxFill(fill.scores, fill.start_row, fill.start_col, fill.dirs,
                   band=fill.band, stagger=fill.stagger)


def _same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.pair_num, g.score, g.ref_aligned, g.relation,
                g.query_aligned) == (w.pair_num, w.score, w.ref_aligned,
                                     w.relation, w.query_aligned)


# --- the decoders and the host walk ---


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_decoders_match_jax(buckets, fills, case):
    """Each real pair's words through both packages' decoder of the
    layout: main, e and f matrices equal (e and f None for the linear
    aligners in both)."""
    algo, layout, name = case
    b, fill = buckets[name], _fill_of(fills, case)
    for row in range(b.num_real):
        q, r = int(b.qry_len[row]), int(b.ref_len[row])
        if fill.band:
            args = (fill.dirs[:, row, :], q, r, fill.band)
            got = th.unpack_banded_pair_dirs(*args)
            want = jh.unpack_banded_pair_dirs(*args)
        elif fill.stagger:
            words = fill.dirs[:, :, :, row]
            got = th.unpack_stagger_pair_dirs(words, q, r, algo,
                                              fill.stagger)
            want = jh.unpack_stagger_pair_dirs(words, q, r, _jax(algo),
                                               fill.stagger)
        else:
            got = th.unpack_pair_dirs(fill.dirs[:, row, :], q, r, algo)
            want = jh.unpack_pair_dirs(fill.dirs[:, row, :], q, r,
                                       _jax(algo))
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if w is not None:
                assert g.shape == (q + 1, r + 1)
                np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_numpy_host_walk_matches_jax_and_native(buckets, jax_buckets, fills,
                                                case):
    algo, layout, name = case
    params = _params(algo, layout)
    fill = _fill_of(fills, case)
    got = th.traceback_bucket(algo, buckets[name], fill, params,
                              use_native=False)
    want = jh.traceback_bucket(_jax(algo), jax_buckets[name],
                               _jax_fill(fill), _jax_params(params),
                               use_native=False)
    _same_results(got, want)
    _same_results(got, th.traceback_bucket(algo, buckets[name], fill,
                                           params))
    if algo.is_local and name == "mixed":  # score-0 lanes: empty blocks
        assert any(r.score <= 0 and r.ref_aligned == "" for r in got)


def test_host_walk_refuses_an_untagged_fill(buckets, fills):
    fill = _fill_of(fills, (Algorithm.LNW, {"rowscan": True}, "mutated"))
    bare = dataclasses.replace(fill, rowscan=False)
    for use_native in (True, False):
        with pytest.raises(ValueError, match="layout tag"):
            th.traceback_bucket(Algorithm.LNW, buckets["mutated"], bare,
                                use_native=use_native)


# --- the moves mode and the Python replay ---

WALK_LAYOUT = {a: ({"band": 16} if a.is_banded else {"stripe_s": STRIPE})
               for a in ALGOS}
WALK_CASES = [(a, name) for a in ALGOS for name in BUCKETS]


def _walk_id(case):
    return f"{case[0].value}-{case[1]}"


def _walk_inputs(fills, algo, name):
    """(params, scores, srow, scol, dirs) tensors of the walk's fill."""
    layout = WALK_LAYOUT[algo]
    fill = _fill_of(fills, (algo, layout, name))
    return (_params(algo, layout), *(torch.from_numpy(np.array(x, np.int32))
                                     for x in (fill.scores, fill.start_row,
                                               fill.start_col, fill.dirs)))


def _seqs(packed, steps, nb, unpack):
    codes = unpack(np.asarray(packed), steps)
    return [tuple(int(c) for c in codes[:, k] if c) for k in range(nb)]


@pytest.mark.parametrize("case", WALK_CASES, ids=_walk_id)
def test_moves_mode_matches_jax(buckets, fills, case):
    """device_traceback_moves: each lane's moves, no-move codes dropped,
    equal the JAX XLA walker's; steps is the stream's length; extras ride
    the stream's copies."""
    algo, name = case
    nb = buckets[name].num_real
    params, sc, sr, sj, dirs = _walk_inputs(fills, algo, name)
    packed, steps = td.device_traceback_moves(algo, params, dirs, sr, sj,
                                              sc, STRIPE)
    assert packed.dtype == np.int32 and steps == packed.shape[0] * 16
    assert steps == td.walk_steps(algo, params, dirs.shape)
    want, want_steps = jd.device_traceback_moves(
        _jax(algo), _jax_params(params), dirs.numpy(), sr.numpy(),
        sj.numpy(), sc.numpy(), STRIPE, walker="xla")
    got_seqs = _seqs(packed, steps, nb, td.unpack_moves)
    assert got_seqs == _seqs(want, want_steps, nb, jd.unpack_moves)
    handle = td.device_walk_dispatch(algo, params, dirs, sr, sj, sc, STRIPE,
                                     extras=(sc, sr))
    p2, s2, sc2, sr2 = td.device_walk_finalize(handle)
    np.testing.assert_array_equal(p2, packed)
    assert s2 == steps
    np.testing.assert_array_equal(sc2, sc.numpy())
    np.testing.assert_array_equal(sr2, sr.numpy())


def test_moves_finalize_refuses_an_events_walk(fills):
    params, sc, sr, sj, dirs = _walk_inputs(fills, Algorithm.LNW, "mutated")
    handle = td.device_walk_dispatch_events(Algorithm.LNW, params, dirs, sr,
                                            sj, sc, STRIPE)
    with pytest.raises(ValueError, match="moves-mode"):
        td.device_walk_finalize(handle)


@pytest.mark.parametrize("algo", ALGOS, ids=lambda a: a.value)
def test_a_mesh_joins_moves_mode_walks(buckets, fills, algo):
    """A ShardedWalk of two moves-mode walks finalizes as one stream: the
    shards' lanes side by side, each shard's moves its own walk's."""
    from tpu_align_torch.distributed.sharding import ShardedWalk

    nb = buckets["mutated"].num_real
    params, sc, sr, sj, dirs = _walk_inputs(fills, algo, "mutated")
    packed, steps = td.device_traceback_moves(algo, params, dirs, sr, sj,
                                              sc, STRIPE)
    mesh_walk = ShardedWalk([td.device_walk_dispatch(
        algo, params, dirs, sr, sj, sc, STRIPE, extras=(sc, sr, sj))
        for _ in range(2)])
    kind, joined, jsteps, jsc, jsr, jsj = td.finalize_any(mesh_walk)
    assert kind == "stream" and joined.shape[1] == 2 * packed.shape[1]
    one = _seqs(packed, steps, nb, td.unpack_moves)
    codes = td.unpack_moves(joined, jsteps)
    b = packed.shape[1]
    for shard in range(2):
        assert [tuple(int(c) for c in codes[:, shard * b + k] if c)
                for k in range(nb)] == one
    np.testing.assert_array_equal(jsc, np.concatenate([sc.numpy()] * 2))
    np.testing.assert_array_equal(jsj, np.concatenate([sj.numpy()] * 2))


def _events_fin(fills, algo, name, ev_max=td.EV_MAX):
    params, sc, sr, sj, dirs = _walk_inputs(fills, algo, name)
    return td.finalize_any(td.device_walk_dispatch_events(
        algo, params, dirs, sr, sj, sc, STRIPE, extras=(sc, sr, sj),
        ev_max=ev_max))


@pytest.mark.parametrize("algo", ALGOS, ids=lambda a: a.value)
def test_events_to_codes_matches_jax(buckets, jax_buckets, fills, algo):
    """The Python expansion of the mutated bucket's events (every lane in
    events mode) equals the JAX package's, and its lanes' moves equal the
    walk's."""
    params = _params(algo, WALK_LAYOUT[algo])
    fin = _events_fin(fills, algo, "mutated")
    assert fin[0] == "events"
    _, flat, nev, fsc, fsr, fsj = fin
    ev_off = np.zeros(nev.shape[0] + 1, np.int64)
    np.cumsum(nev, out=ev_off[1:])
    got = td._events_to_codes(flat, ev_off, fsr, fsj, fsc,
                              buckets["mutated"], algo, params)
    want = jd._events_to_codes(flat, ev_off, fsr, fsj, fsc,
                               jax_buckets["mutated"], _jax(algo),
                               _jax_params(params))
    np.testing.assert_array_equal(got, want)
    nb = buckets["mutated"].num_real
    _, sc, sr, sj, dirs = _walk_inputs(fills, algo, "mutated")
    packed, steps = td.device_traceback_moves(algo, params, dirs, sr, sj, sc,
                                              STRIPE)
    assert [tuple(int(c) for c in got[:, k] if c) for k in range(nb)] == \
        _seqs(packed, steps, nb, td.unpack_moves)


@pytest.mark.parametrize("case", WALK_CASES, ids=_walk_id)
def test_moves_to_result_matches_jax(buckets, fills, case):
    algo, name = case
    b = buckets[name]
    params, sc, sr, sj, dirs = _walk_inputs(fills, algo, name)
    packed, steps = td.device_traceback_moves(algo, params, dirs, sr, sj,
                                              sc, STRIPE)
    codes = td.unpack_moves(packed, steps)
    for row in range(b.num_real):
        ref = b.ref_tokens[row, :b.ref_len[row]].tobytes().decode()
        qry = b.qry_tokens[row, :b.qry_len[row]].tobytes().decode()
        args = (int(b.pair_ids[row]), int(sc[row]), codes[:, row], ref, qry,
                int(sr[row]), int(sj[row]))
        _same_results([td.moves_to_result(algo, *args)],
                      [jd.moves_to_result(_jax(algo), *args)])


FORMS = ["moves", "moves-handle", "events", "stream"]


def _port_handle(form, algo, params, sc, sr, sj, dirs):
    if form == "moves":
        return None  # device_traceback_bucket dispatches the moves mode
    if form == "moves-handle":
        return td.device_walk_dispatch(algo, params, dirs, sr, sj, sc,
                                       STRIPE, extras=(sc, sr, sj))
    return td.device_walk_dispatch_events(
        algo, params, dirs, sr, sj, sc, STRIPE, extras=(sc, sr, sj),
        ev_max=2 if form == "stream" else td.EV_MAX)


def _jax_handle(form, algo, params, sc, sr, sj, dirs):
    if form == "moves":
        return None
    if form == "moves-handle":
        return jd.device_walk_dispatch(
            _jax(algo), _jax_params(params), dirs, sr, sj, sc, STRIPE,
            walker="xla", extras=(sc, sr, sj))
    return jd.device_walk_dispatch_events(
        _jax(algo), _jax_params(params), dirs, sr, sj, sc, STRIPE,
        walker="xla", extras=(sc, sr, sj),
        ev_max=2 if form == "stream" else jd.EV_MAX)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("case", WALK_CASES, ids=_walk_id)
def test_device_traceback_bucket_matches_jax(buckets, jax_buckets, fills,
                                             case, form):
    """The one-call API with the native and the Python replay, each from
    a walk of its own, against the JAX package's device_traceback_bucket
    in the same form (stream forced by ev_max = 2)."""
    algo, name = case
    params, sc, sr, sj, dirs = _walk_inputs(fills, algo, name)
    np_in = tuple(x.numpy() for x in (sc, sr, sj, dirs))
    want = jd.device_traceback_bucket(
        _jax(algo), jax_buckets[name], *np_in, _jax_params(params), STRIPE,
        walker="xla", handle=_jax_handle(form, algo, params, *np_in))
    for use_native in (True, False):
        got = td.device_traceback_bucket(
            algo, buckets[name], sc, sr, sj, dirs, params, STRIPE,
            handle=_port_handle(form, algo, params, sc, sr, sj, dirs),
            use_native=use_native)
        _same_results(got, want)
    arrays = td.device_traceback_bucket_arrays(
        algo, buckets[name], sc, sr, sj, dirs, params, STRIPE,
        use_native=False)
    assert isinstance(arrays, list)
    _same_results(arrays, want)


@pytest.mark.parametrize("algo", ALGOS, ids=lambda a: a.value)
def test_forms_take_their_mode(fills, algo):
    """The mutated bucket stays in events mode; ev_max = 2 overflows it
    into the stream form; the moves mode finalizes as a stream."""
    assert _events_fin(fills, algo, "mutated")[0] == "events"
    assert _events_fin(fills, algo, "mutated", ev_max=2)[0] == "stream"
    params, sc, sr, sj, dirs = _walk_inputs(fills, algo, "mutated")
    fin = td.finalize_any(td.device_walk_dispatch(
        algo, params, dirs, sr, sj, sc, STRIPE, extras=(sc, sr, sj)))
    assert fin[0] == "stream" and fin[2] == fin[1].shape[0] * 16


# --- no fallback ---


@pytest.fixture
def no_native(monkeypatch):
    """The binding's loader fails as when the library cannot build."""
    monkeypatch.setattr(binding, "_lib", None)
    monkeypatch.setattr(binding, "_error", "forced failure")
    assert not binding.available()


@pytest.mark.parametrize("algo", ALGOS, ids=lambda a: a.value)
def test_host_walk_raises_without_the_library(buckets, fills, no_native,
                                              algo):
    layout = WALK_LAYOUT[algo]
    fill = _fill_of(fills, (algo, layout, "mutated"))
    params = _params(algo, layout)
    b = buckets["mutated"]
    with pytest.raises(RuntimeError, match="forced failure"):
        th.traceback_bucket(algo, b, fill, params)
    with pytest.raises(RuntimeError, match="forced failure"):
        th.traceback_bucket_arrays(algo, b, fill, params)
    got = th.traceback_bucket(algo, b, fill, params, use_native=False)
    assert len(got) == b.num_real


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("algo", ALGOS, ids=lambda a: a.value)
def test_device_traceback_raises_without_the_library(buckets, fills,
                                                     no_native, algo, form):
    params, sc, sr, sj, dirs = _walk_inputs(fills, algo, "mutated")
    b = buckets["mutated"]
    with pytest.raises(RuntimeError, match="forced failure"):
        td.device_traceback_bucket(
            algo, b, sc, sr, sj, dirs, params, STRIPE,
            handle=_port_handle(form, algo, params, sc, sr, sj, dirs))
    got = td.device_traceback_bucket(
        algo, b, sc, sr, sj, dirs, params, STRIPE,
        handle=_port_handle(form, algo, params, sc, sr, sj, dirs),
        use_native=False)
    assert len(got) == b.num_real


# --- the small pieces ---


def test_native_gather_spans_matches_jax():
    import tpu_align.native as jn
    from tpu_align_torch import native

    rng = np.random.default_rng(0x6A7)
    src = rng.integers(0, 256, 4096).astype(np.uint8)
    starts = rng.integers(0, 4000, 200)
    spans = np.stack([starts, rng.integers(0, 96, 200)], axis=1)
    order = rng.permutation(200)
    got = native.native_gather_spans(src, spans, order)
    want = np.concatenate([src[s:s + n] for s, n in spans[order]])
    np.testing.assert_array_equal(got, want)
    jax_got = jn.native_gather_spans(src, spans, order)
    if jax_got is not None:  # None where the JAX package's build lost
        np.testing.assert_array_equal(got, jax_got)
    assert native.native_gather_spans(src, spans[:0], order[:0]).size == 0
    with pytest.raises(ValueError):
        native.native_gather_spans(src, spans, order + 1)


def test_native_gather_spans_raises_without_the_library(no_native):
    from tpu_align_torch import native

    with pytest.raises(RuntimeError, match="forced failure"):
        native.native_gather_spans(np.zeros(4, np.uint8),
                                   np.zeros((1, 2), np.int64),
                                   np.zeros(1, np.int64))


def test_phase_timer_add_accumulates():
    from tpu_align_torch.runtime.profiler import PhaseTimer

    t = PhaseTimer()
    t.add("kernel", 0.25)
    t.add("kernel", 0.5)
    with t.phase("printing"):
        pass
    t.add("printing", 1.0)
    assert t.seconds["kernel"] == 0.75
    assert t.seconds["printing"] >= 1.0
    assert t.total == pytest.approx(t.seconds["kernel"]
                                    + t.seconds["printing"])


def test_the_new_exports_import():
    import tpu_align_torch
    from tpu_align_torch import kernels, ops, traceback
    from tpu_align_torch.kernels.fill import bits_per_cell, rows_per_word

    assert tpu_align_torch.__version__ == "0.1.0"
    assert "__version__" in tpu_align_torch.__all__
    assert kernels.fill_bucket is tf.fill_bucket
    assert kernels.fill_bucket_async is tf.fill_bucket_async
    assert kernels.fill_banded_bucket is tb.fill_banded_bucket
    assert kernels.fill_banded_bucket_async is tb.fill_banded_bucket_async
    assert kernels.BucketFill is th.BucketFill
    assert traceback.traceback_bucket is th.traceback_bucket
    assert traceback.unpack_pair_dirs is th.unpack_pair_dirs
    assert int(ops.dpx.vimax3_s32(1, 5, 3)) == 5
    assert (rows_per_word(algo=Algorithm.ANW), bits_per_cell(
        Algorithm.ANW)) == (8, 4)
