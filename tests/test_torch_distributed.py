"""The port's distributed layer against the JAX package, on a mesh of 4 CPU
shards (each runs the kernels' plain versions).

The JAX side runs its single-device path: its own sharded tests are
marked slow and hold that path equal to the sharded one.  On 64 pairs of
16-48 bp (seed 11): the sharded fill, joined in shard order and sliced to
the real pairs, against the JAX fills in interpret mode (all four
aligners, and LNW's row sweep) -- scores, start cells, every defined
direction code -- and exactly equal to the port's one-device fill; the
sharded walk's per-lane moves against the JAX XLA walker; the shards'
events and streams joined; global_stats against numpy; the mesh engine
and `-mesh N -device cpu` byte for byte against the JAX one-device engine
and the goldens; warmup; the refusals, with the JAX package's messages;
host_shard, renumber and the merge against the JAX functions; and a
two-process run through a real gloo rendezvous, merged to the
one-process text.  Each package builds its own objects from the same
values; only numpy arrays and text pass between them.
"""

import dataclasses
import datetime
import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import tpu_align.core.params as jp
import tpu_align.distributed.multihost as jmh
import tpu_align.io as jio
import tpu_align.utils.synthetic as jsynth
from tpu_align.cli import main as jax_cli
from tpu_align.kernels import banded as jax_banded
from tpu_align.kernels import fill as jax_rowscan
from tpu_align.kernels import stagger as jax_stagger
from tpu_align.oracle.api import align_batch as jax_align_batch
from tpu_align.runtime.engine import AlignmentEngine as _JaxEngine
from tpu_align.traceback import device as jd
from tpu_align_torch import Algorithm, AlignmentParams
from tpu_align_torch.cli import main as torch_cli
from tpu_align_torch.convert import bucket_to_tensors
from tpu_align_torch.distributed import (
    fill_sharded,
    global_stats,
    host_shard,
    initialize,
    iter_output_blocks,
    make_pairs_mesh,
    merge_output_files,
    renumber,
    shard_bucket_spec,
    walk_sharded,
    walk_sharded_dispatch,
)
from tpu_align_torch.distributed.sharding import (
    PairsMesh,
    dirs_batch_axis,
    gather,
)
from tpu_align_torch.io import BucketSpec, PairDataset, bucketize
from tpu_align_torch.io.dataset import write_pair_file
from tpu_align_torch.kernels import banded as tb
from tpu_align_torch.kernels import fill as rs
from tpu_align_torch.kernels import stagger as ts
from tpu_align_torch.native import available
from tpu_align_torch.oracle.api import align_batch
from tpu_align_torch.runtime.engine import AlignmentEngine
from tpu_align_torch.traceback import device as td
from tpu_align_torch.utils.synthetic import synthetic_dataset

pytestmark = pytest.mark.skipif(
    not available(), reason="native library not built"
)

REPO = Path(__file__).resolve().parent.parent
GOLDENS = REPO / "goldens"
PARAMS = AlignmentParams()
MESH = make_pairs_mesh(["cpu"] * 4)
# the JAX fills' stripe: its interpret-mode stagger fill compiles in
# about a third of the time at 16 rows as at the default 32
STRIPE = 16
# one 64-pair bucket (4 shards of 16) for the kernel-level tests
FILL_SPEC = shard_bucket_spec(MESH, BucketSpec(batch_pairs=64,
                                               query_multiple=64))
# the mesh engine's buckets: 40 + 26 pairs, padded to 64 and 32 rows, so
# shards hold 16, 16, 8 and 0 real pairs, then 8, 8, 8 and 2
MESH_SPEC = BucketSpec(batch_pairs=40, query_multiple=64)
# the JAX engine's: the one bucket of the kernel-level tests, so its
# interpret-mode fills compile once
JAX_SPEC = BucketSpec(batch_pairs=64, query_multiple=64)
FILL_CASES = [(Algorithm.LNW, "stagger"), (Algorithm.LSW, "stagger"),
              (Algorithm.ANW, "stagger"), (Algorithm.BSW, "banded"),
              (Algorithm.LNW, "rowscan")]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain versions' many small torch ops gain nothing from
    intra-op threads, which would only contend with the other test
    workers for the CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax(algo, params=PARAMS):
    return (jp.Algorithm(algo.value),
            jp.AlignmentParams(**dataclasses.asdict(params)))


def _dataset() -> PairDataset:
    return synthetic_dataset(64, min_len=16, max_len=48, seed=11)


def _engine_dataset() -> PairDataset:
    """The 64 pairs, then two with an empty side (the oracle's path)."""
    ds = _dataset()
    pairs = list(ds.pairs()) + [("", "ACGT"), ("GATTACA", "")]
    return PairDataset.from_pairs(pairs)


@functools.cache
def _bucket():
    (b,) = bucketize(_dataset(), FILL_SPEC)
    assert b.batch == 64 and b.num_real == 64
    return b


@functools.cache
def _jax_fill(algo, kernel):
    """The JAX fill of the same bucket, interpret mode, as numpy: the
    wrappers the JAX engine calls (and its sharded path's shards reach),
    so the JAX engine runs below reuse their compiled programs."""
    b = _bucket()
    args = (b.ref_tokens, b.qry_tokens, b.ref_len, b.qry_len)
    if kernel == "banded":
        out = jax_banded.fill_banded_bucket_async(_jax(algo)[1], *args,
                                                  interpret=True)
    elif kernel == "stagger":
        out = jax_stagger.fill_stagger_bucket_async(
            *_jax(algo), *args, interpret=True, stripe_s=STRIPE)
    else:
        out = jax_rowscan.fill_bucket_async(*_jax(algo), *args,
                                            interpret=True)
    return tuple(np.asarray(x) for x in out)


@functools.cache
def _sharded_fill(algo, kernel, stripe_s=STRIPE):
    b = _bucket()
    return fill_sharded(MESH, algo, PARAMS, b.ref_tokens, b.qry_tokens,
                        b.ref_len, b.qry_len, kernel=kernel,
                        stripe_s=stripe_s)


def _joined(outs, kernel):
    scores, srow, scol, dirs = outs
    return (gather(scores), gather(srow), gather(scol),
            gather(dirs, dirs_batch_axis(kernel)))


def _codes(kernel, algo, dirs, b):
    """Every defined direction code of the bucket's real pairs."""
    nr = b.num_real
    rl = torch.from_numpy(b.ref_len[:nr])
    ql = torch.from_numpy(b.qry_len[:nr])
    dirs = torch.from_numpy(np.array(dirs))
    if kernel == "stagger":
        return ts.defined_codes(algo, dirs[..., :nr].contiguous(), rl, ql)
    if kernel == "banded":
        return tb.defined_codes(dirs[:, :nr].contiguous(), rl, ql,
                                PARAMS.band)
    return rs.defined_codes(algo, dirs[:, :nr].contiguous(), rl, ql)


@pytest.mark.parametrize("algo,kernel", FILL_CASES,
                         ids=lambda c: getattr(c, "value", c))
def test_fill_sharded_matches_jax_and_one_device(algo, kernel):
    b = _bucket()
    outs = _sharded_fill(algo, kernel)
    for field in outs:
        assert len(field) == MESH.size
        assert all(t.device.type == "cpu" for t in field)
    assert [t.shape[0] for t in outs[0]] == [16] * 4
    got = _joined(outs, kernel)
    want = _jax_fill(algo, kernel)
    nr = b.num_real
    for k, name in enumerate(("scores", "start_row", "start_col")):
        np.testing.assert_array_equal(got[k].numpy()[:nr], want[k][:nr],
                                      err_msg=name)
    assert torch.equal(_codes(kernel, algo, got[3], b),
                       _codes(kernel, algo, want[3], b))
    # the shards joined are the one-device fill, word for word
    t = bucket_to_tensors(b, "cpu")
    if kernel == "banded":
        one = tb.fill_banded_bucket_async(algo, PARAMS, *t)
    elif kernel == "stagger":
        one = ts.fill_stagger_bucket_async(algo, PARAMS, *t,
                                           stripe_s=STRIPE)
    else:
        one = rs.fill_bucket_async(algo, PARAMS, *t)
    for g, w in zip(got, one):
        assert torch.equal(g, w)


def test_fill_sharded_scores_only_and_stripe_s():
    b = _bucket()
    args = (b.ref_tokens, b.qry_tokens, b.ref_len, b.qry_len)
    scores, srow, scol, dirs = fill_sharded(
        MESH, Algorithm.LNW, PARAMS, *args, with_traceback=False)
    assert dirs is None
    np.testing.assert_array_equal(gather(scores).numpy(),
                                  _jax_fill(Algorithm.LNW, "stagger")[0])
    outs = _sharded_fill(Algorithm.LNW, "stagger", stripe_s=64)
    assert all(d.shape[2] == 64 and d.shape[3] == 16 for d in outs[3])
    one = ts.fill_stagger_bucket_async(Algorithm.LNW, PARAMS,
                                       *bucket_to_tensors(b, "cpu"),
                                       stripe_s=64)
    assert torch.equal(gather(outs[3], 3), one[3])


def test_fill_sharded_refuses_a_batch_the_mesh_cannot_split():
    b = _bucket()
    with pytest.raises(ValueError, match="not divisible by 8"):
        fill_sharded(make_pairs_mesh(["cpu"] * 3), Algorithm.LNW, PARAMS,
                     b.ref_tokens, b.qry_tokens, b.ref_len, b.qry_len)
    with pytest.raises(ValueError, match="unknown kernel"):
        fill_sharded(MESH, Algorithm.LNW, PARAMS, b.ref_tokens,
                     b.qry_tokens, b.ref_len, b.qry_len, kernel="nope")


def _seqs(packed, steps, nb):
    codes = jd.unpack_moves(np.asarray(packed), steps)
    return [tuple(int(c) for c in codes[:, k] if c) for k in range(nb)]


@pytest.mark.parametrize("algo", list(Algorithm), ids=lambda a: a.value)
def test_walk_sharded_moves_match_the_jax_walk(algo):
    kernel = "banded" if algo.is_banded else "stagger"
    scores, srow, scol, dirs = _sharded_fill(algo, kernel)
    packed, steps = walk_sharded(MESH, algo, PARAMS, dirs, srow, scol,
                                 scores, STRIPE)
    assert packed.shape[1] == 64
    wsc, wsr, wsj, wdirs = _jax_fill(algo, kernel)
    want = jd.device_traceback_moves(*_jax(algo), wdirs, wsr, wsj, wsc,
                                     STRIPE, walker="xla")
    nr = _bucket().num_real
    assert _seqs(packed, steps, nr) == _seqs(*want, nr)


@pytest.mark.parametrize("algo", [Algorithm.LNW, Algorithm.LSW],
                         ids=lambda a: a.value)
def test_sharded_walk_joins_events_and_streams(algo):
    """All shards in events mode join to the one-device events; a shard in
    the stream form turns the join into streams, which replay to the same
    blocks."""
    b = _bucket()
    scores, srow, scol, dirs = _sharded_fill(algo, "stagger")
    extras = (scores, srow, scol)
    joined = walk_sharded_dispatch(MESH, algo, PARAMS, dirs, srow, scol,
                                   scores, STRIPE, extras=extras)
    t = bucket_to_tensors(b, "cpu")
    one = ts.fill_stagger_bucket_async(algo, PARAMS, *t, stripe_s=STRIPE)
    single = td.finalize_any(td.device_walk_dispatch_events(
        algo, PARAMS, one[3], one[1], one[2], one[0], STRIPE,
        extras=(one[0], one[1], one[2])))
    fin = td.finalize_any(joined)
    assert fin[0] == single[0] == "events"
    total = int(single[2].sum())
    np.testing.assert_array_equal(fin[1], single[1][:total])
    for g, w in zip(fin[2:], single[2:]):
        np.testing.assert_array_equal(g, w)
    mixed = walk_sharded_dispatch(MESH, algo, PARAMS, dirs, srow, scol,
                                  scores, STRIPE, extras=extras)
    mixed.handles[2].ev_max = -1  # as if a lane of this shard overflowed
    before = td.stream_finalized
    fin = td.finalize_any(mixed)
    assert fin[0] == "stream" and td.stream_finalized == before + 4
    got = td.bucket_arrays_from_finalized(algo, b, PARAMS, fin)
    want = td.bucket_arrays_from_finalized(algo, b, PARAMS, single)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_global_stats_match_numpy():
    b = _bucket()
    scores = _sharded_fill(Algorithm.LSW, "stagger")[0]
    cells = b.ref_len.astype(np.int64) * b.qry_len
    want = (int(gather(scores).max()), int(cells.sum()))
    per_shard = [torch.from_numpy(c) for c in np.split(cells, 4)]
    assert global_stats(MESH, scores, per_shard) == want
    assert global_stats(MESH, gather(scores).numpy(), cells) == want
    assert global_stats(make_pairs_mesh(["cpu"] * 3), np.arange(5),
                        np.full(5, 7)) == (4, 35)
    with pytest.raises(ValueError, match="3 shards"):
        global_stats(MESH, scores[:3], cells)


def test_mesh_constructor_refusals():
    assert make_pairs_mesh(["cpu", "cpu"]).size == 2
    assert shard_bucket_spec(MESH) == BucketSpec(pair_multiple=32)
    assert shard_bucket_spec(MESH, BucketSpec(batch_pairs=8)).batch_pairs \
        == 32
    with pytest.raises(ValueError, match="one type"):
        make_pairs_mesh(["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="at least one"):
        make_pairs_mesh([])
    with pytest.raises(ValueError, match="not of the engine's device"):
        AlignmentEngine(Algorithm.LNW, device="cpu",
                        mesh=PairsMesh((torch.device("cuda", 0),)))


def test_make_pairs_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_pairs_mesh()
    with pytest.raises(ValueError, match="only 0 devices visible"):
        make_pairs_mesh(["cuda:0"])


class JaxEngine:
    """The JAX package's one-device engine on the same values."""

    def __init__(self, algorithm, **kwargs):
        self._engine = _JaxEngine(
            jp.Algorithm(algorithm.value),
            bucket_spec=jio.BucketSpec(**dataclasses.asdict(JAX_SPEC)),
            stripe_s=STRIPE, **kwargs)

    def run(self, ds):
        return self._engine.run(jio.PairDataset(
            ds.buffer.copy(), ds.ref_off, ds.ref_len, ds.qry_off,
            ds.qry_len))


@functools.cache
def _jax_text(algo, kernel, traceback):
    out = JaxEngine(algo, kernel=kernel, traceback=traceback,
                    output="blocks").run(_engine_dataset())
    return out.output_bytes(), out.scores()


@pytest.mark.parametrize("algo,kernel,traceback,output,stripe", [
    (Algorithm.LNW, "auto", "device", "blocks", None),
    (Algorithm.LNW, "auto", "device", "records", None),
    (Algorithm.LSW, "auto", "device", "blocks", None),
    (Algorithm.LSW, "auto", "device", "records", 16),
    (Algorithm.ANW, "auto", "host", "blocks", None),
    (Algorithm.ANW, "auto", "host", "records", None),
    (Algorithm.BSW, "auto", "device", "blocks", None),
    (Algorithm.LNW, "rowscan", "host", "blocks", None),
], ids=lambda c: getattr(c, "value", c))
def test_mesh_engine_matches_jax_engine(algo, kernel, traceback, output,
                                        stripe):
    engine = AlignmentEngine(algo, bucket_spec=MESH_SPEC, device="cpu",
                             mesh=MESH, kernel=kernel, traceback=traceback,
                             output=output, stripe_s=stripe)
    assert engine.bucket_spec.pair_multiple == 32
    ds = _engine_dataset()
    assert [(b.batch, b.num_real) for b in engine._buckets_of(ds)] == [
        (64, 40), (32, 24)]
    out = engine.run(ds)
    text, scores = _jax_text(algo, kernel, traceback)
    assert out.output_bytes() == text
    np.testing.assert_array_equal(out.scores(), scores)


def test_warmup_then_run_matches_jax():
    engine = AlignmentEngine(Algorithm.LNW, bucket_spec=MESH_SPEC,
                             device="cpu", mesh=MESH, traceback="device",
                             output="blocks")
    ds = _engine_dataset()
    assert engine.warmup(ds) is None
    assert engine.run(ds).output_bytes() == _jax_text(
        Algorithm.LNW, "auto", "device")[0]
    one = AlignmentEngine(Algorithm.ANW, bucket_spec=MESH_SPEC,
                          device="cpu", traceback="host")
    one.warmup(ds)
    assert one.run(ds).output_bytes() == _jax_text(
        Algorithm.ANW, "auto", "host")[0]


@pytest.mark.parametrize("kwargs,flags", [
    ({"traceback": "hirschberg"}, ["-traceback", "hirschberg"]),
    ({"local_mode": "all"}, ["-all-paths"]),
], ids=["hirschberg", "all-paths"])
def test_mesh_refuses_hirschberg_and_all_paths(tmp_path, capsys, kwargs,
                                               flags):
    with pytest.raises(ValueError) as want:
        _JaxEngine(jp.Algorithm.LNW, mesh=object(), **kwargs)
    with pytest.raises(ValueError) as got:
        AlignmentEngine(Algorithm.LNW, device="cpu", mesh=MESH, **kwargs)
    assert str(got.value) == str(want.value)
    path = tmp_path / "pairs.txt"
    write_pair_file(path, [("ACGT", "AGT")])
    assert jax_cli(["-pairs", str(path), "-mesh", "2", *flags]) == 2
    jax_err = capsys.readouterr().err
    assert torch_cli(["-pairs", str(path), "-device", "cpu", "-mesh", "2",
                      *flags]) == 2
    assert capsys.readouterr().err == jax_err


def test_cli_mesh_beyond_the_visible_cards_exits_2(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    path = tmp_path / "pairs.txt"
    write_pair_file(path, [("ACGT", "AGT")])
    assert torch_cli(["-pairs", str(path), "-mesh", "2",
                      "-device", "cuda"]) == 2
    assert "-mesh 2: only 0 devices visible" in capsys.readouterr().err


@pytest.mark.parametrize("mesh", ["4", "-1"])
def test_cli_mesh_on_cpu_prints_the_golden(tmp_path, mesh):
    pairs = GOLDENS / "lnw" / "input-data.txt"
    golden = (GOLDENS / "lnw" / "align-output.txt").read_bytes()
    sharded, single = tmp_path / "mesh.txt", tmp_path / "one.txt"
    assert torch_cli(["-pairs", str(pairs), "-device", "cpu", "-mesh", mesh,
                      "-traceback", "device", "-out", str(sharded)]) == 0
    assert torch_cli(["-pairs", str(pairs), "-device", "cpu",
                      "-traceback", "device", "-out", str(single)]) == 0
    assert sharded.read_bytes() == single.read_bytes() == golden


def _jax_dataset(ds):
    return jio.PairDataset(ds.buffer.copy(), ds.ref_off, ds.ref_len,
                           ds.qry_off, ds.qry_len)


def test_host_shard_renumber_and_merge_match_jax(tmp_path):
    ds = synthetic_dataset(20, min_len=5, max_len=20, seed=21)
    jds = jsynth.synthetic_dataset(20, min_len=5, max_len=20, seed=21)
    np.testing.assert_array_equal(ds.buffer, jds.buffer)
    ours, theirs = [], []
    for pi in range(3):  # three hosts
        shard, ids = host_shard(ds, process_index=pi, process_count=3)
        jshard, jids = jmh.host_shard(jds, process_index=pi,
                                      process_count=3)
        np.testing.assert_array_equal(ids, jids)
        assert list(shard.pairs()) == list(jshard.pairs())
        got = renumber(align_batch(Algorithm.LNW, PARAMS,
                                   list(shard.pairs())), ids)
        want = jmh.renumber(jax_align_batch(
            jp.Algorithm.LNW, jp.AlignmentParams(), list(jshard.pairs())),
            jids)
        assert [r.block() for r in got] == [r.block() for r in want]
        for paths, results in ((ours, got), (theirs, want)):
            p = tmp_path / f"{'port' if paths is ours else 'jax'}_{pi}.txt"
            p.write_text("".join(r.block() for r in results))
            paths.append(p)
        assert list(iter_output_blocks(ours[-1])) == list(
            jmh.iter_output_blocks(theirs[-1]))
    merge_output_files(ours, tmp_path / "port.txt")
    jmh.merge_output_files(theirs, tmp_path / "jax.txt")
    full = "".join(r.block() for r in align_batch(Algorithm.LNW, PARAMS,
                                                  list(ds.pairs())))
    assert (tmp_path / "port.txt").read_text() == \
        (tmp_path / "jax.txt").read_text() == full
    # defaults with no process group: one process holds every pair
    shard, ids = host_shard(ds)
    np.testing.assert_array_equal(ids, np.arange(len(ds)))


def test_merge_refuses_an_unsorted_file(tmp_path):
    bad = tmp_path / "bad.txt"
    bad.write_text("3 | 1\nA\n*\nA\n1 | 1\nC\n*\nC\n")
    good = tmp_path / "good.txt"
    good.write_text("2 | 1\nG\n*\nG\n")
    for merge in (merge_output_files, jmh.merge_output_files):
        with pytest.raises(ValueError, match="not sorted by pair id"):
            merge([good, bad], tmp_path / "out.txt")


def test_initialize_single_process_and_refusals(tmp_path, monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    assert initialize() == (0, 1)
    assert initialize(num_processes=1) == (0, 1)
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="not a rank"):
        initialize(f"file://{tmp_path}/rdv", 2, 2)
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        initialize()
    # a rendezvous whose peer never arrives raises at its timeout
    with pytest.raises(RuntimeError):
        initialize(f"file://{tmp_path}/alone", 2, 0,
                   timeout=datetime.timedelta(seconds=1))
    assert not dist.is_initialized()


_CHILD = """
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["tpu_align"] = None
import numpy as np
import torch
import torch.distributed as dist
from tpu_align_torch import Algorithm
from tpu_align_torch.distributed import (
    global_stats, host_shard, initialize, make_pairs_mesh, renumber)
from tpu_align_torch.io import BucketSpec, parse_pair_file
from tpu_align_torch.runtime.engine import AlignmentEngine

torch.set_num_threads(1)
rdv, rank, pairs, out, want_max, want_cells = sys.argv[1:]
assert initialize(rdv, 2, int(rank)) == (int(rank), 2)
shard, ids = host_shard(parse_pair_file(pairs))
mesh = make_pairs_mesh(["cpu", "cpu"])
res = AlignmentEngine(Algorithm.LNW, device="cpu", traceback="device",
                      mesh=mesh, bucket_spec=BucketSpec(batch_pairs=16),
                      output="records").run(shard)
renumber(res.results, ids)
with open(out, "w") as f:
    f.write("".join(r.block() for r in res.results))
cells = shard.ref_len.astype(np.int64) * shard.qry_len
got = global_stats(mesh, res.scores(), cells)
assert got == (int(want_max), int(want_cells)), got
dist.destroy_process_group()
"""


def test_two_processes_through_a_gloo_rendezvous_merge_to_one(tmp_path):
    ds = _engine_dataset()
    pairs = tmp_path / "pairs.txt"
    write_pair_file(pairs, list(ds.pairs()))
    text, scores = _jax_text(Algorithm.LNW, "auto", "device")
    cells = int((ds.ref_len.astype(np.int64) * ds.qry_len).sum())
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    outs = [tmp_path / f"host{r}.txt" for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD, f"file://{tmp_path}/rdv", str(r),
         str(pairs), str(outs[r]), str(int(scores.max())), str(cells)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    try:
        errs = [p.communicate(timeout=180)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    assert [p.returncode for p in procs] == [0, 0], errs
    merged = tmp_path / "merged.txt"
    merge_output_files(outs, merged)
    assert merged.read_bytes() == text
