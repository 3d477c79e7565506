"""The port's Hirschberg path and rowscan engine path against the JAX
package's, byte for byte.

The port runs on CPU tensors (the plain versions of the row-sweep fill, the
last-row fills and the split reduction); the JAX package runs its Pallas
fills in interpret mode.  Equal last rows plus the first-max argmax give
equal splits, and the leaves go through byte-identical engines, so
hirschberg_align_batch, the engine's traceback="hirschberg" and the CLI
give the JAX package's bytes for LNW, LSW and ANW.  The JAX side is slow
here (5-30 s an aligner), so it runs once per module.  Also: the split
reduction against _split_reduce_jit (ties, sentinel rows, the affine
extra), `-kernel rowscan` on the goldens, and the refusals both packages
share.  The JAX side gets its own Algorithm, AlignmentParams and
PairDataset of the same values; only numpy arrays and strings pass
between the packages.
"""

import dataclasses
import os
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_align.core.params as jp
import tpu_align.io as jio
from tpu_align.runtime.engine import AlignmentEngine as _JaxEngine
from tpu_align.traceback import hirschberg as jh
from tpu_align_torch import Algorithm, AlignmentParams
from tpu_align_torch.cli import main as torch_cli
from tpu_align_torch.io import PairDataset
from tpu_align_torch.io.dataset import write_pair_file
from tpu_align_torch.native import available
from tpu_align_torch.oracle.api import align_pair
from tpu_align_torch.kernels.common import NEG
from tpu_align_torch.runtime.engine import AlignmentEngine
from tpu_align_torch.traceback import hirschberg as th
from tpu_align_torch.utils.synthetic import (
    SPLIT_REDUCE_SHAPES,
    split_reduce_inputs,
)
from tests.conftest import random_dna

pytestmark = pytest.mark.skipif(
    not available(), reason="native library not built"
)

PARAMS = AlignmentParams()
GOLDENS_ROOT = os.path.join(os.path.dirname(__file__), "..", "goldens")
ALGOS = [Algorithm.LNW, Algorithm.LSW, Algorithm.ANW]
LEAF_Q = 16
_rng = random.Random(0x41B)
# the first pair flips (ref longer than query), one side is empty, and
# the last has an LSW score of 0
PAIRS = [(random_dna(_rng, 140, 140), random_dna(_rng, 120, 120)),
         (random_dna(_rng, 60, 60), random_dna(_rng, 150, 150)),
         (random_dna(_rng, 100, 100), random_dna(_rng, 100, 100)),
         ("", "ACGTAC"),
         ("AAAA", "TTTT")]
# the engine's pairs: one split level at the default leaf_q of 128
ENGINE_PAIRS = [(random_dna(_rng, 150, 190), random_dna(_rng, 130, 190))
                for _ in range(3)] + [("GATTACA", "")]


def _jax(algo, params=PARAMS):
    """The JAX package's Algorithm and AlignmentParams of the same values."""
    return (jp.Algorithm(algo.value),
            jp.AlignmentParams(**dataclasses.asdict(params)))


class JaxEngine:
    """The JAX package's engine, built from the JAX package's own objects
    of the same values as the port's arguments."""

    def __init__(self, algorithm, params=PARAMS, **kwargs):
        self._engine = _JaxEngine(*_jax(algorithm, params), **kwargs)

    def run(self, ds, **kwargs):
        return self._engine.run(jio.PairDataset.from_pairs(list(ds.pairs())),
                                **kwargs)


@pytest.fixture(scope="module")
def jax_batch():
    """JAX's hirschberg_align_batch blocks, per aligner, computed once."""
    return {a: [r.block() for r in jh.hirschberg_align_batch(
        *_jax(a), PAIRS, leaf_q=LEAF_Q, interpret=True)] for a in ALGOS}


@pytest.fixture(scope="module")
def jax_engine():
    ds = PairDataset.from_pairs(ENGINE_PAIRS)
    return {a: JaxEngine(a, PARAMS, output="blocks",
                         traceback="hirschberg").run(ds).output_bytes()
            for a in ALGOS}


@pytest.mark.parametrize("algo", ALGOS, ids=lambda a: a.value)
def test_hirschberg_batch_matches_jax(jax_batch, algo):
    got = th.hirschberg_align_batch(algo, PARAMS, PAIRS, leaf_q=LEAF_Q,
                                    device="cpu")
    assert [r.block() for r in got] == jax_batch[algo]
    if algo is Algorithm.LSW:
        assert got[-1].score == 0 and got[3].score == 0
    for r, (ref, qry) in zip(got, PAIRS):
        if algo is not Algorithm.LSW:  # the lines hold both sequences
            assert r.ref_aligned.replace("_", "") == ref
            assert r.query_aligned.replace("_", "") == qry
        assert r.score == align_pair(algo, PARAMS, ref, qry).score


@pytest.mark.parametrize("algo", [Algorithm.LNW, Algorithm.ANW],
                         ids=lambda a: a.value)
def test_stagger_last_rows_give_the_same_bytes(jax_batch, algo, monkeypatch):
    """LAST_ROWS_KERNEL = "stagger" takes the stagger fill's last-row
    variant: bit-identical rows, so the same output."""
    monkeypatch.setattr(th, "LAST_ROWS_KERNEL", "stagger")
    got = th.hirschberg_align_batch(algo, PARAMS, PAIRS, leaf_q=LEAF_Q,
                                    device="cpu")
    assert [r.block() for r in got] == jax_batch[algo]


def test_hirschberg_align_one_pair(jax_batch):
    r = th.hirschberg_align(Algorithm.ANW, PARAMS, *PAIRS[2], pair_num=2,
                            leaf_q=LEAF_Q, device="cpu")
    assert r.block() == jax_batch[Algorithm.ANW][2]


def test_phase_seconds_accumulate():
    secs = {}
    th.hirschberg_align_batch(Algorithm.LSW, PARAMS, PAIRS[:3], leaf_q=LEAF_Q,
                              device="cpu", phase_seconds=secs)
    assert set(secs) == {"endpoints", "fill", "reduce", "leaves"}
    assert all(v >= 0 for v in secs.values())


@pytest.mark.parametrize("algo", ALGOS, ids=lambda a: a.value)
def test_engine_hirschberg_matches_jax_engine(jax_engine, algo):
    ds = PairDataset.from_pairs(ENGINE_PAIRS)
    out = AlignmentEngine(algo, PARAMS, device="cpu", output="blocks",
                          traceback="hirschberg").run(ds)
    assert out.output_bytes() == jax_engine[algo]
    recs = AlignmentEngine(algo, PARAMS, device="cpu", output="records",
                           traceback="hirschberg").run(ds)
    assert recs.output_bytes() == jax_engine[algo]


@pytest.mark.parametrize("algo", ALGOS, ids=lambda a: a.value)
def test_cli_traceback_hirschberg(jax_engine, algo, tmp_path):
    path = tmp_path / "pairs.txt"
    write_pair_file(path, ENGINE_PAIRS)
    out = tmp_path / "out.txt"
    assert torch_cli(["-pairs", str(path), "-algorithm", algo.value,
                      "-traceback", "hirschberg", "-device", "cpu",
                      "-out", str(out)]) == 0
    assert out.read_bytes() == jax_engine[algo]


@pytest.mark.parametrize("algo", ALGOS, ids=lambda a: a.value)
def test_cli_kernel_rowscan_reproduces_goldens(algo, tmp_path):
    d = os.path.join(GOLDENS_ROOT, algo.value)
    out = tmp_path / "out.txt"
    assert torch_cli(["-pairs", os.path.join(d, "input-data.txt"),
                      "-algorithm", algo.value, "-kernel", "rowscan",
                      "-traceback", "host", "-device", "cpu",
                      "-out", str(out)]) == 0
    with open(os.path.join(d, "align-output.txt"), "rb") as f:
        assert out.read_bytes() == f.read()


def _split_inputs(seed: int, n: int, k: int, affine: bool):
    """Last rows from a small value set (ties), NEG entries, one sub whose
    rows are all NEG, widths 0..n."""
    rng = np.random.default_rng(seed)
    last = rng.integers(-6, 3, (n, 2 * k)).astype(np.int32)
    last[rng.random((n, 2 * k)) < 0.1] = NEG
    last[:, 2:4] = NEG
    flast = (np.where(rng.random((n, 2 * k)) < 0.5, NEG, last - 2)
             .astype(np.int32) if affine else None)
    nn = rng.integers(0, n + 1, k).astype(np.int32)
    nn[0], nn[-1] = 0, n
    fhb, bhb = (rng.integers(-5, 1, k).astype(np.int32) for _ in range(2))
    go = np.full(k, PARAMS.gap_open, np.int32)
    return last, flast, fhb, bhb, nn, go


@pytest.mark.parametrize("affine", [False, True], ids=["linear", "affine"])
@pytest.mark.parametrize("n,k,kind", [
    pytest.param(1, 1, "random", id="1-1"),
    pytest.param(40, 9, "random", id="40-9"),
    pytest.param(300, 17, "random", id="300-17"),
    # the shapes the CUDA kernel's grid splits differently
    # (utils/synthetic.py SPLIT_REDUCE_SHAPES): one subproblem over long
    # rows, a K that is no multiple of its 32-lane groups, rows that leave
    # the last chunk part full, maxima tied across chunks, widths past the
    # rows
    *(pytest.param(n, k, kind, id=f"{n}-{k}" + ("" if kind == "random"
                                                 else f"-{kind}"))
      for k, n, kind in SPLIT_REDUCE_SHAPES),
])
def test_split_reduce_matches_jax(affine, n, k, kind):
    if kind != "random":
        last, flast, fhb, bhb, nn, go = split_reduce_inputs(k, n, kind)
        flast = flast if affine else None
    else:
        last, flast, fhb, bhb, nn, go = _split_inputs(n + k, n, k, affine)
    want = jh._split_reduce_jit(
        jnp.asarray(last), jnp.asarray(flast if affine else last),
        jnp.asarray(fhb), jnp.asarray(bhb), jnp.asarray(nn), jnp.asarray(go),
        affine=affine)
    args = [None if x is None else torch.from_numpy(x)
            for x in (last, flast, fhb, bhb, nn, go)]
    before = th.launches
    got = th.split_reduce(*args)  # CPU tensors: the plain version
    assert th.launches == before
    assert got.dtype == torch.int32 and got.shape == (4, k)
    np.testing.assert_array_equal(got.numpy(),
                                  np.stack([np.asarray(w) for w in want]))


def test_split_reduce_all_sentinel_sums_wrap_as_jax():
    """Every operand NEG: each sum is 2*NEG = INT32_MIN, as XLA adds, so
    the first masked entry (NEG, at nn + 1) wins where nn < n and index 0
    where nn == n."""
    n, k = 12, 3
    last = np.full((n, 2 * k), NEG, np.int32)
    fhb = bhb = np.full(k, NEG, np.int32)
    nn = np.array([0, 5, n], np.int32)
    go = np.full(k, -10, np.int32)
    want = jh._split_reduce_jit(*(jnp.asarray(x) for x in (
        last, last, fhb, bhb, nn, go)), affine=True)
    t = [torch.from_numpy(x) for x in (last, last.copy(), fhb, bhb, nn, go)]
    got = th.split_reduce_reference(*t)
    np.testing.assert_array_equal(got.numpy(),
                                  np.stack([np.asarray(w) for w in want]))
    assert got[0].tolist() == [1, 6, 0]
    assert got[1].tolist() == [NEG, NEG, -2**31]


def test_split_reduce_refuses_mixed_types():
    x = torch.zeros((4, 2), dtype=torch.int32)
    v = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        th.split_reduce(x.long(), None, v, v, v, v)
    with pytest.raises(ValueError):
        th.split_reduce(x[:, :1].contiguous(), None, v, v, v, v)


@pytest.mark.parametrize("seed", range(3))
def test_rescores_match_jax(seed):
    rng = random.Random(seed)
    ref, qry = random_dna(rng, 20, 60), random_dna(rng, 20, 60)
    for algo, fn in ((Algorithm.LNW, "_rescore"),
                     (Algorithm.ANW, "_rescore_affine")):
        r = align_pair(algo, PARAMS, ref, qry)
        got = getattr(th, fn)(PARAMS, r.ref_aligned, r.query_aligned)
        assert got == getattr(jh, fn)(_jax(algo)[1], r.ref_aligned,
                                      r.query_aligned) == r.score


def _refusals():
    ds = PairDataset.from_pairs([("ACGT", "AGT")])
    return {
        "bsw engine": (ValueError, lambda eng: eng(
            Algorithm.BSW, traceback="hirschberg")),
        "rowscan device traceback": (ValueError, lambda eng: eng(
            Algorithm.LNW, kernel="rowscan", traceback="device")),
        "checkpoint_dir": (ValueError, lambda eng: eng(
            Algorithm.LNW, traceback="hirschberg").run(
                ds, checkpoint_dir="unused-ckpt")),
    }


@pytest.mark.parametrize("case", sorted(_refusals()))
def test_engine_refusals_match_jax(case):
    exc, make = _refusals()[case]
    for eng in (JaxEngine,
                lambda *a, **kw: AlignmentEngine(*a, device="cpu", **kw)):
        with pytest.raises(exc, match="hirschberg|stagger"):
            make(eng)
    assert not os.path.exists("unused-ckpt")


@pytest.mark.parametrize("algo,params,exc", [
    (Algorithm.BSW, PARAMS, NotImplementedError),
    (Algorithm.ANW, AlignmentParams(gap_open=1), ValueError),
], ids=["bsw", "anw gap_open > 0"])
def test_hirschberg_batch_refusals_match_jax(algo, params, exc):
    with pytest.raises(exc):
        jh.hirschberg_align_batch(*_jax(algo, params), PAIRS[:1],
                                  interpret=True)
    with pytest.raises(exc):
        th.hirschberg_align_batch(algo, params, PAIRS[:1], device="cpu")
