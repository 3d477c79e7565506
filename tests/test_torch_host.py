"""The port's copies of the JAX package's host layers against their
originals, on the same inputs.

Each side builds its objects with its own constructors from the same
strings and values; only numpy arrays and strings are compared:
parse_pair_file / parse_pair_text and bucketize field by field, the
oracle's fills and align_pair blocks for the four aligners, synthetic_dataset(seed=
42), results_from_arrays, the direction codes and parameters, and the
port's own native binding, which builds native/tpualign.cpp into build/
with an atomic rename.  The modules the port copies whole (the oracle,
verify/, utils/reorder.py, io/fasta.py, oracle/lcs.py, utils/pretty.py and
utils/timing_analysis.py) must be their originals' code, docstrings aside;
tests/test_torch_oracle.py and test_torch_verify.py run the oracle and
verify/ against the originals, and the tests at the end of this file the
other four.
"""

import ast
import concurrent.futures
import ctypes
import dataclasses
import json
import random
from pathlib import Path

import numpy as np
import pytest

import tpu_align.core.directions as jdirs
import tpu_align.core.params as jp
import tpu_align.core.result as jresult
import tpu_align.io as jio
import tpu_align.io.fasta as jfasta
import tpu_align.oracle as joracle_pkg
import tpu_align.oracle.api as joracle
import tpu_align.oracle.scalar as jscalar
import tpu_align.oracle.vectorized as jvectorized
import tpu_align.utils as jutils
import tpu_align.utils.pretty as jpretty
import tpu_align.utils.synthetic as jsynth
import tpu_align.utils.timing_analysis as jtiming
import tpu_align_torch.core.directions as pdirs
import tpu_align_torch.io as pio
import tpu_align_torch.oracle as poracle_pkg
import tpu_align_torch.oracle.scalar as pscalar
import tpu_align_torch.oracle.vectorized as pvectorized
import tpu_align_torch.utils as putils
from tpu_align_torch import Algorithm, AlignmentParams, native
from tpu_align_torch.core.result import results_from_arrays
from tpu_align_torch.io import (
    BucketSpec,
    PairDataset,
    bucketize,
    fasta,
    parse_pair_file,
    parse_pair_text,
    write_pair_file,
)
from tpu_align_torch.io.bucketing import gather_bucket, plan_buckets
from tpu_align_torch.native import binding
from tpu_align_torch.oracle.api import align_pair
from tpu_align_torch.utils import pretty, timing_analysis
from tpu_align_torch.utils.hostmem import tune_malloc_for_large_buffers
from tpu_align_torch.utils.synthetic import random_dna as synthetic_random_dna
from tpu_align_torch.utils.synthetic import synthetic_dataset
from tests.conftest import random_dna

_rng = random.Random(0x4057)
PAIRS = ([(random_dna(_rng, 1, 90), random_dna(_rng, 1, 90))
          for _ in range(24)]
         + [(random_dna(_rng, 2, 40, "AC"), random_dna(_rng, 2, 40, "AC"))
            for _ in range(8)]
         + [("A", "A"), ("AAAA", "TTTT"), ("", "ACGT"), ("GATTACA", ""),
            ("", ""), ("A" * 129, "A" * 70)])
DS_FIELDS = ("buffer", "ref_off", "ref_len", "qry_off", "qry_len")
BUCKET_FIELDS = ("ref_tokens", "qry_tokens", "ref_len", "qry_len",
                 "pair_ids")

def _same_dataset(got, want):
    for f in DS_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert dataclasses.asdict(got.stats()) == dataclasses.asdict(want.stats())


@pytest.mark.parametrize("text", [
    "0\nACGT\nAGT\n1\n\nGG\n2\nTTAC\n\n",
    "7\r\n0123\r\nACGT\r\n8\r\nAC\r\nA",  # CRLF, digits, no final newline
    "",
])
@pytest.mark.parametrize("native_parse", [True, False],
                         ids=["native", "numpy"])
def test_parse_pair_text_matches_jax(text, native_parse):
    data = text.encode()
    _same_dataset(parse_pair_text(data, use_native=native_parse),
                  jio.parse_pair_text(data, use_native=native_parse))


def test_parse_pair_text_refuses_what_jax_refuses():
    for mod in (jio, pio):
        with pytest.raises(ValueError):
            mod.parse_pair_text(b"0\nACGT\n", use_native=False)


def test_parse_and_write_pair_file_match_jax(tmp_path):
    ours, theirs = tmp_path / "port.txt", tmp_path / "jax.txt"
    write_pair_file(ours, PAIRS)
    jio.write_pair_file(theirs, PAIRS)
    assert ours.read_bytes() == theirs.read_bytes()
    _same_dataset(parse_pair_file(ours), jio.parse_pair_file(theirs))


@pytest.mark.parametrize("spec", [
    {}, {"batch_pairs": 5}, {"query_multiple": 8, "ref_multiple": 16,
                             "pair_multiple": 1},
], ids=["defaults", "batch5", "fine"])
def test_bucketize_matches_jax(spec):
    got = bucketize(PairDataset.from_pairs(PAIRS), BucketSpec(**spec))
    want = jio.bucketize(jio.PairDataset.from_pairs(PAIRS),
                         jio.BucketSpec(**spec))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for f in BUCKET_FIELDS:
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f),
                                          err_msg=f)
        assert (g.num_real, g.batch, g.padded_qry, g.padded_ref,
                g.real_cells, g.padded_cells) == (
            w.num_real, w.batch, w.padded_qry, w.padded_ref, w.real_cells,
            w.padded_cells)
    assert BucketSpec(**spec).padded_shape(37, 200) == \
        jio.BucketSpec(**spec).padded_shape(37, 200)


# test_bucketize_matches_jax's specs and ids
_BUCKET_SPECS = next(m for m in test_bucketize_matches_jax.pytestmark
                     if m.name == "parametrize")


@pytest.mark.parametrize("gather", ["native", "numpy"])
@pytest.mark.parametrize(*_BUCKET_SPECS.args, **_BUCKET_SPECS.kwargs)
def test_plan_then_gather_is_bucketize(spec, gather, monkeypatch):
    """The engine's route, a plan and then each plan's gather, builds
    bucketize's buckets field for field, through the native gather or
    its numpy fallback, each writing into the rows it is handed."""
    ds = PairDataset.from_pairs(PAIRS)
    want = bucketize(ds, BucketSpec(**spec))
    if gather == "numpy":
        monkeypatch.setattr(native, "native_gather_padded",
                            lambda *a, **k: None)
    plans = plan_buckets(ds, BucketSpec(**spec))
    got = [gather_bucket(ds, p, BucketSpec(**spec)) for p in plans]
    assert len(got) == len(want) > 0
    for p, g, w in zip(plans, got, want):
        assert (len(p.idx), p.padded_qry, p.padded_ref) == (
            w.num_real, w.padded_qry, w.padded_ref)
        for f in BUCKET_FIELDS:
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f),
                                          err_msg=f)
        assert (g.num_real, g.batch, g.pinned) == (w.num_real, w.batch,
                                                  None)


def test_native_gather_refuses_rows_of_another_shape():
    buf = np.frombuffer(b"ACGTACGT", np.uint8)
    off, lens = np.array([0, 4]), np.array([4, 3])
    out = np.empty((2, 8), np.uint8)
    assert native.native_gather_padded(buf, off, lens, 2, 8, 1,
                                       out=out) is out
    np.testing.assert_array_equal(out[1], [65, 67, 71, 1, 1, 1, 1, 1])
    for bad in (np.empty((2, 7), np.uint8), np.empty((2, 8), np.int8),
                np.empty((8, 2), np.uint8).T):
        with pytest.raises(ValueError):
            native.native_gather_padded(buf, off, lens, 2, 8, 1, out=bad)


@pytest.mark.parametrize("engine", ["vectorized", "scalar"])
@pytest.mark.parametrize("algo", list(Algorithm), ids=lambda a: a.value)
def test_align_pair_matches_jax(algo, engine):
    params = AlignmentParams(band=5)
    jalgo = jp.Algorithm(algo.value)
    jparams = jp.AlignmentParams(**dataclasses.asdict(params))
    for k, (ref, qry) in enumerate(PAIRS):
        got = align_pair(algo, params, ref, qry, pair_num=k, engine=engine)
        want = joracle.align_pair(jalgo, jparams, ref, qry, pair_num=k,
                                  engine=engine)
        assert got.block() == want.block(), (k, ref, qry)


@pytest.mark.parametrize("ours, theirs", [
    (pvectorized.fill_vectorized, jvectorized.fill_vectorized),
    (pscalar.fill_scalar, jscalar.fill_scalar),
], ids=["vectorized", "scalar"])
@pytest.mark.parametrize("algo", list(Algorithm), ids=lambda a: a.value)
def test_fills_match_jax_under_the_cuda_tie_rule(algo, ours, theirs):
    """Every score and direction matrix of the port's oracle fills equals
    the JAX oracle's under its default (CUDA) tie rule, on tie-rich
    two-letter pairs as well as the rest."""
    params = AlignmentParams(band=5)
    jalgo = jp.Algorithm(algo.value)
    jparams = jp.AlignmentParams(**dataclasses.asdict(params))
    for k, (ref, qry) in enumerate(PAIRS):
        got, want = ours(algo, params, ref, qry), theirs(jalgo, jparams,
                                                          ref, qry)
        for f in ("h", "main_dirs", "e", "f", "e_dirs", "f_dirs"):
            g, w = getattr(got, f), getattr(want, f)
            assert (g is None) == (w is None), (k, f)
            if g is not None:
                np.testing.assert_array_equal(g, w, err_msg=f"{k} {f}")


def test_synthetic_dataset_matches_jax():
    got = synthetic_dataset(300, uniform_len=250, seed=42)
    want = jsynth.synthetic_dataset(300, uniform_len=250, seed=42)
    _same_dataset(got, want)
    _same_dataset(synthetic_dataset(40, min_len=2, max_len=70, seed=7,
                                    alphabet="AC"),
                  jsynth.synthetic_dataset(40, min_len=2, max_len=70,
                                           seed=7, alphabet="AC"))


def test_results_from_arrays_matches_jax():
    rng = np.random.default_rng(3)
    b, stride = 6, 12
    ids = np.arange(10, 10 + b)
    scores = rng.integers(-50, 50, b).astype(np.int32)
    out_buf = rng.integers(32, 256, (b, 3, stride)).astype(np.uint8)
    out_lens = rng.integers(0, stride + 1, b).astype(np.int32)
    got = results_from_arrays(ids, scores, out_buf, out_lens, b - 1)
    want = jresult.results_from_arrays(ids, scores, out_buf, out_lens, b - 1)
    assert [dataclasses.astuple(r) for r in got] == \
        [dataclasses.astuple(r) for r in want]
    assert [r.block() for r in got] == [r.block() for r in want]


def test_direction_codes_and_params_match_jax():
    names = [n for n in dir(jdirs) if n.isupper()]
    assert names and all(getattr(pdirs, n) == getattr(jdirs, n)
                         for n in names)
    assert [a.value for a in Algorithm] == [a.value for a in jp.Algorithm]
    for a in Algorithm:
        j = jp.Algorithm(a.value)
        assert (a.is_local, a.is_affine, a.is_banded) == (
            j.is_local, j.is_affine, j.is_banded)
    assert dataclasses.asdict(AlignmentParams()) == \
        dataclasses.asdict(jp.AlignmentParams())
    assert AlignmentParams().max_abs_score(250, 300) == \
        jp.AlignmentParams().max_abs_score(250, 300)
    with pytest.raises(ValueError):
        AlignmentParams(band=0)


def test_hostmem_tuning_is_idempotent():
    assert tune_malloc_for_large_buffers() == tune_malloc_for_large_buffers()


def test_native_library_is_the_ports_own_build():
    assert native.available()
    path = binding.library_path()
    assert path.exists()
    assert path.parent.parent == binding.BUILD_ROOT
    assert path.parent.name.startswith("native-")


def test_native_formatter_matches_the_python_blocks():
    rng = np.random.default_rng(4)
    b, stride = 5, 9
    ids = np.arange(b, dtype=np.int64) * 3
    scores = rng.integers(-20, 20, b).astype(np.int32)
    out_buf = rng.integers(65, 91, (b, 3, stride)).astype(np.uint8)
    out_lens = rng.integers(0, stride + 1, b).astype(np.int32)
    chunk, spans = native.native_format_blocks(ids, scores, out_buf,
                                               out_lens)
    want = results_from_arrays(ids, scores, out_buf, out_lens, b)
    for (off, n), r in zip(spans, want):
        assert chunk[off:off + n].tobytes() == r.block().encode()


def test_concurrent_builds_never_expose_a_partial_library(tmp_path,
                                                          monkeypatch):
    """Two builds racing to one path: each compiles in its own temporary
    directory and renames, so the path only ever holds a whole library."""
    so = tmp_path / "native-test" / "libtpualign.so"
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        list(pool.map(lambda _: binding._compile(so), range(2)))
    assert so.exists()
    assert [p.name for p in so.parent.iterdir()] == ["libtpualign.so"]
    binding._configure(ctypes.CDLL(str(so)))


def _code(path: Path, package: str) -> str:
    """A module's code without its docstrings, its package's name
    written as "PKG"."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree).replace(package, "PKG")


# modules the port copies whole from the JAX package, under the same path
COPIES = ["oracle/scalar.py", "oracle/vectorized.py", "oracle/traceback.py",
          "oracle/api.py", "verify/__init__.py", "verify/independent.py",
          "utils/reorder.py", "io/fasta.py", "oracle/lcs.py",
          "utils/pretty.py", "utils/timing_analysis.py"]


@pytest.mark.parametrize("rel", COPIES)
def test_copied_modules_are_their_originals(rel):
    """Code for code, docstrings aside: the oracle (tie policies, batched
    fills, every-path enumeration, align_batch, lcs), verify/, reorder,
    FASTA ingestion, the matrix printer and the phase analysis (whose
    usage line names its own package, which _code writes as PKG)."""
    repo = Path(__file__).resolve().parent.parent
    assert _code(repo / "tpu_align_torch" / rel, "tpu_align_torch") == \
        _code(repo / "tpu_align" / rel, "tpu_align")


def test_golden_module_is_its_original_but_for_its_program_name():
    repo = Path(__file__).resolve().parent.parent
    ours = (repo / "tpu_align_torch/verify/golden.py").read_text().replace(
        'prog="python -m tpu_align_torch.verify.golden"',
        'prog="tpu-align-verify"')
    tmp = ast.parse(ours)
    theirs = ast.parse((repo / "tpu_align/verify/golden.py").read_text())
    for t in (tmp, theirs):
        t.body = t.body[1:]  # the module docstring
    assert ast.dump(tmp).replace("tpu_align_torch", "PKG") == \
        ast.dump(theirs).replace("tpu_align", "PKG")


def test_random_dna_draws_the_tests_sequences():
    a, b = random.Random(9), random.Random(9)
    for lo, hi, alphabet in ((1, 300, "AT"), (1, 40, "ATCG"), (0, 3, "A")):
        assert [synthetic_random_dna(a, lo, hi, alphabet)
                for _ in range(20)] == [random_dna(b, lo, hi, alphabet)
                                        for _ in range(20)]


def test_package_exports_match_jax():
    """oracle/ and utils/ export what the JAX package's __init__s do
    (utils also synthetic_dataset's neighbours mutate and
    reorder_output)."""
    assert set(jutils.__all__) <= set(putils.__all__)
    assert set(joracle_pkg.__all__) <= set(poracle_pkg.__all__)
    for name in jutils.__all__:
        assert callable(getattr(putils, name)), name
    for name in joracle_pkg.__all__:
        assert callable(getattr(poracle_pkg, name)), name


FASTA = (b">r1 first read\nACGT\nacg\r\n>q1\r\nAGT\n\n>r2\rGGCA\n"
         b">q2\n0123\n>unpaired\nT\n")


def test_fasta_ingestion_matches_jax(tmp_path):
    reads = tmp_path / "reads.fa"
    reads.write_bytes(FASTA)
    assert fasta.read_fasta(str(reads)) == jfasta.read_fasta(str(reads))
    ours, theirs = tmp_path / "port.txt", tmp_path / "jax.txt"
    assert fasta.fasta_to_pairfile(str(reads), str(ours)) == \
        jfasta.fasta_to_pairfile(str(reads), str(theirs)) == 2
    assert ours.read_bytes() == theirs.read_bytes()
    # the pair parser translates the digit alphabet
    assert list(parse_pair_file(ours).pairs()) == [("ACGTACG", "AGT"),
                                                   ("GGCA", "ATCG")]
    queries = tmp_path / "queries.fa"
    queries.write_bytes(b">a\nAC\n>b\nGT\n>c\nTT\n>d\nA\n>e\nC\n")
    assert fasta.fasta_to_pairfile(str(reads), str(ours), str(queries)) \
        == jfasta.fasta_to_pairfile(str(reads), str(theirs),
                                    str(queries)) == 5
    assert ours.read_bytes() == theirs.read_bytes()
    short = tmp_path / "short.fa"
    short.write_bytes(b">a\nAC\n")
    bad = {"before": b"ACGT\n>a\nA\n", "empty": b">a\n>b\nAC\n"}
    for mod in (fasta, jfasta):
        with pytest.raises(ValueError, match="counts differ"):
            mod.fasta_to_pairfile(str(reads), str(ours), str(short))
        for name, data in bad.items():
            path = tmp_path / f"{name}.fa"
            path.write_bytes(data)
            with pytest.raises(ValueError):
                mod.read_fasta(str(path))
    scores = np.array([5, -1, 3, 3, 0])
    assert fasta.score_checksum(scores) == \
        jfasta.score_checksum(scores[::-1]) == \
        fasta.score_checksum(list(scores[::-1]))


def test_lcs_matches_jax():
    rng = random.Random(0x1C5)
    pairs = ([(random_dna(rng, 0, 9, "AC"), random_dna(rng, 0, 9, "AC"))
              for _ in range(30)]
             + [(random_dna(rng, 1, 60), random_dna(rng, 1, 60))
                for _ in range(10)])
    for ref, qry in pairs:
        np.testing.assert_array_equal(poracle_pkg.lcs_matrix(ref, qry),
                                      joracle_pkg.lcs_matrix(ref, qry))
        for kw in ({"all_paths": False}, {"dedup": True}, {}):
            if len(ref) > 9 and "all_paths" not in kw:
                continue  # every co-optimal path of long pairs: too many
            assert poracle_pkg.lcs(ref, qry, **kw) == \
                joracle_pkg.lcs(ref, qry, **kw), \
                (ref, qry, kw)


@pytest.mark.parametrize("algo", [Algorithm.LNW, Algorithm.ANW],
                         ids=lambda a: a.value)
def test_matrix_printer_matches_jax(algo, capsys):
    ref, qry = "GATTACA", "GCATGCT"
    fill = pvectorized.fill_vectorized(algo, AlignmentParams(), ref, qry)
    jfill = jvectorized.fill_vectorized(jp.Algorithm(algo.value),
                                        jp.AlignmentParams(), ref, qry)
    for color in (True, False):
        assert pretty.format_matrix(fill.h, ref, qry, color=color) == \
            jpretty.format_matrix(jfill.h, ref, qry, color=color)
        pretty.print_fill(fill, ref, qry, color=color)
        ours = capsys.readouterr().out
        jpretty.print_fill(jfill, ref, qry, color=color)
        assert ours == capsys.readouterr().out
        assert ("(E)" in ours) == algo.is_affine


def test_timing_analysis_matches_jax(tmp_path, capsys):
    runs = tmp_path / "runs.jsonl"
    rows = [{"label": "lnw-device", "phases": {"kernel": 0.0125,
                                               "backtrack": 0.5}},
            {"label": "fill-only", "gcups": 3.5},
            {"phases": {"memmgmt": 0.001, "printing": 0.02, "extra": 1.0}}]
    runs.write_text("\n".join(json.dumps(r) for r in rows) + "\n\n")
    loaded = timing_analysis.load_runs(str(runs))
    assert loaded == jtiming.load_runs(str(runs)) == rows
    assert timing_analysis.analyze(loaded) == jtiming.analyze(loaded)
    assert timing_analysis.plot(loaded[1:2], str(tmp_path / "a.png")) is \
        jtiming.plot(loaded[1:2], str(tmp_path / "b.png")) is False
    assert timing_analysis.main([str(runs)]) == 0
    assert capsys.readouterr().out == timing_analysis.analyze(loaded) + "\n"
    assert timing_analysis.main([]) == 2
    assert "python -m tpu_align_torch.utils.timing_analysis" in \
        capsys.readouterr().err
