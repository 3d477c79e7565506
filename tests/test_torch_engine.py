"""The port's engine and CLI against the JAX package's, byte for byte.

The port runs on CPU tensors (the plain PyTorch versions of its kernels);
the JAX engine runs its Pallas kernels in interpret mode.  Host traceback
walks with the native host walker in both; device traceback walks on the
device (the port's plain walk here) and replays natively.  Every
combination formats with the native block formatter, so the blocks must be
identical bytes -- and equal the committed goldens of all four aligners.
The JAX engine gets its own Algorithm, AlignmentParams, BucketSpec and
PairDataset of the same values (`JaxEngine` below); only numpy arrays
pass between the packages.
"""

import dataclasses
import os
import random

import numpy as np
import pytest

import tpu_align.core.params as jp
import tpu_align.io as jio
from tpu_align.cli import main as jax_cli
from tpu_align.runtime.engine import AlignmentEngine as _JaxEngine
from tpu_align_torch import Algorithm, AlignmentParams
from tpu_align_torch.cli import main as torch_cli
from tpu_align_torch.io import BucketSpec, PairDataset
from tpu_align_torch.io.dataset import write_pair_file
from tpu_align_torch.native import available
from tpu_align_torch.runtime.engine import AlignmentEngine, align_file
from tpu_align_torch.runtime.profiler import PhaseTimer
from tests.conftest import random_dna

pytestmark = pytest.mark.skipif(
    not available(), reason="native library not built"
)

GOLDENS_ROOT = os.path.join(os.path.dirname(__file__), "..", "goldens")
GOLDENS = os.path.join(GOLDENS_ROOT, "lnw")
# one bucket shape, so the JAX side compiles once
SPEC = BucketSpec(batch_pairs=64, query_multiple=128, ref_multiple=128)


class JaxEngine:
    """The JAX package's engine, built from the JAX package's own objects
    of the same values as the port's arguments."""

    def __init__(self, algorithm, params=None, bucket_spec=None, **kwargs):
        self._engine = _JaxEngine(
            jp.Algorithm(algorithm.value),
            params and jp.AlignmentParams(**dataclasses.asdict(params)),
            bucket_spec=bucket_spec and jio.BucketSpec(
                **dataclasses.asdict(bucket_spec)),
            **kwargs)

    def run(self, ds):
        return self._engine.run(jio.PairDataset(
            ds.buffer.copy(), ds.ref_off, ds.ref_len, ds.qry_off,
            ds.qry_len))


def _dataset() -> PairDataset:
    rng = random.Random(0xE6)
    pairs = [(random_dna(rng, 1, 70), random_dna(rng, 1, 70))
             for _ in range(30)]
    pairs += [(random_dna(rng, 2, 40, "AC"), random_dna(rng, 2, 40, "AC"))
              for _ in range(6)]
    # empty sides go to the scalar oracle in both engines
    pairs[3:3] = [("", "ACGT")]
    pairs[17:17] = [("GATTACA", "")]
    pairs += [("", "")]
    return PairDataset.from_pairs(pairs)


@pytest.fixture(scope="module")
def ds():
    return _dataset()


@pytest.fixture(scope="module")
def jax_blocks(ds):
    out = JaxEngine(Algorithm.LNW, bucket_spec=SPEC, output="blocks").run(ds)
    return out.output_bytes(), out.scores()


@pytest.mark.parametrize("config", [
    {},
    {"stripe_s": 16},
    {"max_inflight": 1},
    {"max_inflight": 0},
    {"output": "records"},
], ids=lambda c: ",".join(f"{k}={v}" for k, v in c.items()) or "defaults")
def test_engine_matches_jax_engine(ds, jax_blocks, config):
    kwargs = {"output": "blocks", **config}
    out = AlignmentEngine(Algorithm.LNW, bucket_spec=SPEC, device="cpu",
                          **kwargs).run(ds)
    assert out.output_bytes() == jax_blocks[0]
    np.testing.assert_array_equal(out.scores(), jax_blocks[1])


def test_engine_batches_smaller_than_the_dataset(ds, jax_blocks):
    spec = BucketSpec(batch_pairs=8)  # many buckets, several shapes
    out = AlignmentEngine(Algorithm.LNW, bucket_spec=spec, device="cpu",
                          output="blocks", max_inflight=2).run(ds)
    assert out.output_bytes() == jax_blocks[0]


def test_records_equal_blocks(ds):
    rec = AlignmentEngine(Algorithm.LNW, bucket_spec=SPEC, device="cpu",
                          output="records").run(ds)
    blk = AlignmentEngine(Algorithm.LNW, bucket_spec=SPEC, device="cpu",
                          output="blocks").run(ds)
    assert blk.blocks is not None and not blk.results
    assert [r.pair_num for r in rec.results] == list(range(len(ds)))
    assert rec.output_bytes() == blk.output_bytes()


@pytest.fixture(scope="module")
def jax_scores_only(ds):
    return JaxEngine(Algorithm.LNW, bucket_spec=SPEC, output="blocks",
                     with_traceback=False).run(ds).output_bytes()


@pytest.mark.parametrize("output", ["records", "blocks"])
def test_scores_only(ds, jax_blocks, jax_scores_only, output):
    out = AlignmentEngine(Algorithm.LNW, bucket_spec=SPEC, device="cpu",
                          with_traceback=False, output=output).run(ds)
    np.testing.assert_array_equal(out.scores(), jax_blocks[1])
    assert out.output_bytes() == jax_scores_only


@pytest.mark.parametrize("output", ["records", "blocks"])
def test_reproduces_goldens_lnw(output):
    out = align_file(os.path.join(GOLDENS, "input-data.txt"), Algorithm.LNW,
                     device="cpu", output=output)
    with open(os.path.join(GOLDENS, "align-output.txt"), "rb") as f:
        assert out.output_bytes() == f.read()


@pytest.mark.parametrize("output", ["records", "blocks"])
def test_checkpoint_resume(tmp_path, ds, jax_blocks, output):
    ckpt = str(tmp_path / "ckpt")
    spec = BucketSpec(batch_pairs=8)

    def run():
        return AlignmentEngine(Algorithm.LNW, bucket_spec=spec, device="cpu",
                               output=output).run(ds, checkpoint_dir=ckpt)

    first = run()
    parts = sorted(os.listdir(ckpt))
    assert parts
    second = run()  # every bucket restored from its checkpoint part
    assert sorted(os.listdir(ckpt)) == parts
    assert first.output_bytes() == second.output_bytes() == jax_blocks[0]


@pytest.mark.parametrize("output", ["records", "blocks"])
def test_checkpoint_resume_of_some_buckets(tmp_path, ds, jax_blocks, output):
    """Restored buckets and recomputed ones interleave in one dispatch
    window: a run that finds every other part computes just the rest."""
    ckpt = str(tmp_path / "ckpt")
    spec = BucketSpec(batch_pairs=8)

    def run(timer=None):
        return AlignmentEngine(Algorithm.LNW, bucket_spec=spec, device="cpu",
                               output=output, max_inflight=2).run(
            ds, checkpoint_dir=ckpt, timer=timer)

    first = run()
    parts = sorted(os.listdir(ckpt))
    assert len(parts) > 2
    for name in parts[::2]:
        os.remove(os.path.join(ckpt, name))
    timer = PhaseTimer(record=True)
    second = run(timer)
    assert sorted(os.listdir(ckpt)) == parts
    assert sum(s.name == "dispatch" for s in timer.spans) == len(parts[::2])
    assert first.output_bytes() == second.output_bytes() == jax_blocks[0]


def test_buckets_are_gathered_as_they_are_dispatched(ds, jax_blocks):
    """A bucket is gathered just before its dispatch, after the bucket
    ahead of it was dispatched: with a window of one, after that bucket
    was finished; with the default window, the first four while bucket 0
    fills.  The blocks do not depend on the window."""
    spec = BucketSpec(batch_pairs=8)  # several buckets
    for window in (1, None):
        timer = PhaseTimer(record=True)
        engine = AlignmentEngine(
            Algorithm.LNW, bucket_spec=spec, device="cpu", output="blocks",
            **({} if window is None else {"max_inflight": window}))
        out = engine.run(ds, timer=timer)
        assert out.output_bytes() == jax_blocks[0]
        span = {(s.name, s.bucket): s for s in timer.spans
                if s.bucket is not None}
        n = len(engine._buckets_of(ds))
        assert n > 4
        for k in range(1, n):
            gather = span["memmgmt.gather", k]
            assert gather.start_ns >= span["dispatch", k - 1].end_ns
            if window == 1:
                assert gather.start_ns >= span["printing.blocks", k - 1].end_ns
            elif k < engine.max_inflight:
                assert gather.end_ns <= span["kernel", 0].start_ns


def test_phase_timer_accounts_the_main_path(ds):
    out = AlignmentEngine(Algorithm.LNW, bucket_spec=SPEC, device="cpu",
                          output="blocks").run(ds)
    for phase in ("memmgmt", "dispatch", "kernel", "backtrack", "printing"):
        assert out.timer.seconds[phase] > 0, phase
    assert out.num_cells == ds.num_cells


def test_cli_matches_jax_cli(tmp_path, capsys):
    rng = random.Random(7)
    # query <= 32 and reference <= 128: one bucket shape at the CLI defaults
    pairs = [(random_dna(rng, 1, 100), random_dna(rng, 1, 32))
             for _ in range(12)] + [("ACGT", "")]
    path = tmp_path / "pairs.txt"
    write_pair_file(path, pairs)
    a, b = tmp_path / "jax.txt", tmp_path / "torch.txt"
    assert jax_cli(["-pairs", str(path), "-out", str(a)]) == 0
    jax_err = capsys.readouterr().err.splitlines()
    assert torch_cli(["-pairs", str(path), "-device", "cpu",
                      "-out", str(b)]) == 0
    torch_err = capsys.readouterr().err.splitlines()
    assert b.read_bytes() == a.read_bytes()
    # the same dataset banner, then the phase report and GCUPS lines
    assert torch_err[:4] == jax_err[:4]
    assert [ln.split(":")[0] for ln in torch_err[4:]] == \
        [ln.split(":")[0] for ln in jax_err[4:]]


def test_cli_scores_only_and_stdout(tmp_path, capsys):
    path = tmp_path / "pairs.txt"
    write_pair_file(path, [("ACGT", "AGT"), ("GG", "G")])
    assert torch_cli(["-pairs", str(path), "-device", "cpu",
                      "-scores-only", "-stripe", "16"]) == 0
    assert capsys.readouterr().out == "0 | 7\n\n\n\n1 | 1\n\n\n\n"


def test_engine_alt_params_match_jax_engine():
    params = AlignmentParams(match=5, mismatch=-2, gap=-3)
    rng = random.Random(11)
    ds = PairDataset.from_pairs([(random_dna(rng, 1, 30),
                                  random_dna(rng, 1, 30)) for _ in range(8)])
    spec = BucketSpec(batch_pairs=8)
    want = JaxEngine(Algorithm.LNW, params, bucket_spec=spec,
                     output="blocks").run(ds).output_bytes()
    got = AlignmentEngine(Algorithm.LNW, params, bucket_spec=spec,
                          device="cpu", output="blocks").run(ds)
    assert got.output_bytes() == want


DEVICE_CONFIGS = [
    {},
    {"stripe_s": 16},
    {"max_inflight": 1},
    {"max_inflight": 0},
    {"output": "records"},
]


@pytest.mark.parametrize("config", DEVICE_CONFIGS, ids=lambda c: ",".join(
    f"{k}={v}" for k, v in c.items()) or "defaults")
def test_device_traceback_matches_jax_engine(ds, jax_blocks, config):
    kwargs = {"output": "blocks", **config}
    out = AlignmentEngine(Algorithm.LNW, bucket_spec=SPEC, device="cpu",
                          traceback="device", **kwargs).run(ds)
    assert out.output_bytes() == jax_blocks[0]
    np.testing.assert_array_equal(out.scores(), jax_blocks[1])


def test_device_traceback_matches_jax_device_engine(ds):
    want = JaxEngine(Algorithm.LNW, bucket_spec=SPEC, output="blocks",
                     traceback="device", walker="pallas").run(ds)
    got = AlignmentEngine(Algorithm.LNW, bucket_spec=SPEC, device="cpu",
                          output="blocks", traceback="device",
                          walker="pallas").run(ds)
    assert got.output_bytes() == want.output_bytes()
    np.testing.assert_array_equal(got.scores(), want.scores())


@pytest.fixture(scope="module")
def jax_lsw_blocks(ds):
    out = JaxEngine(Algorithm.LSW, bucket_spec=SPEC, output="blocks").run(ds)
    return out.output_bytes(), out.scores()


@pytest.mark.parametrize("output", ["records", "blocks"])
@pytest.mark.parametrize("traceback", ["host", "device"])
def test_lsw_engine_matches_jax_engine(ds, jax_lsw_blocks, traceback, output):
    out = AlignmentEngine(Algorithm.LSW, bucket_spec=SPEC, device="cpu",
                          traceback=traceback, output=output).run(ds)
    assert out.output_bytes() == jax_lsw_blocks[0]
    np.testing.assert_array_equal(out.scores(), jax_lsw_blocks[1])


@pytest.mark.parametrize("algo,traceback", [
    (Algorithm.LNW, "device"),
    (Algorithm.LSW, "host"),
    (Algorithm.LSW, "device"),
    (Algorithm.ANW, "host"),
    (Algorithm.ANW, "device"),
    (Algorithm.BSW, "host"),
    (Algorithm.BSW, "device"),
], ids=lambda v: getattr(v, "value", v))
def test_reproduces_goldens(algo, traceback):
    d = os.path.join(GOLDENS_ROOT, algo.value)
    out = align_file(os.path.join(d, "input-data.txt"), algo, device="cpu",
                     output="blocks", traceback=traceback)
    with open(os.path.join(d, "align-output.txt"), "rb") as f:
        assert out.output_bytes() == f.read()


def test_host_checkpoint_resumes_a_device_run(tmp_path, ds, jax_blocks):
    """Blocks do not depend on where the walk ran, so the parts a
    host-walk run wrote restore every bucket of a device-walk run."""
    ckpt = str(tmp_path / "ckpt")
    spec = BucketSpec(batch_pairs=8)
    host = AlignmentEngine(Algorithm.LNW, bucket_spec=spec, device="cpu",
                           output="blocks").run(ds, checkpoint_dir=ckpt)
    parts = sorted(os.listdir(ckpt))
    dev = AlignmentEngine(Algorithm.LNW, bucket_spec=spec, device="cpu",
                          output="blocks", traceback="device").run(
        ds, checkpoint_dir=ckpt)
    assert sorted(os.listdir(ckpt)) == parts
    assert "dispatch" not in dev.timer.seconds  # nothing was recomputed
    assert host.output_bytes() == dev.output_bytes() == jax_blocks[0]


def test_device_checkpoint_resume(tmp_path, ds, jax_blocks):
    ckpt = str(tmp_path / "ckpt")

    def run():
        return AlignmentEngine(Algorithm.LNW, bucket_spec=BucketSpec(
            batch_pairs=8), device="cpu", output="records",
            traceback="device").run(ds, checkpoint_dir=ckpt)

    first = run()
    parts = sorted(os.listdir(ckpt))
    second = run()
    assert sorted(os.listdir(ckpt)) == parts
    assert first.output_bytes() == second.output_bytes() == jax_blocks[0]


def test_phase_timer_accounts_the_device_path(ds):
    """Device traceback never waits in a "kernel" phase: the wait for a
    bucket's events is "backtrack", as in the JAX engine."""
    out = AlignmentEngine(Algorithm.LNW, bucket_spec=SPEC, device="cpu",
                          output="blocks", traceback="device").run(ds)
    for phase in ("memmgmt", "dispatch", "backtrack", "printing"):
        assert out.timer.seconds[phase] > 0, phase
    assert "kernel" not in out.timer.seconds


@pytest.mark.parametrize("algorithm", ["lnw", "lsw", "anw", "bsw"])
def test_cli_device_traceback_matches_jax_cli(tmp_path, capsys, algorithm):
    rng = random.Random(7)
    # query <= 32 and reference <= 128: one bucket shape at the CLI defaults
    pairs = [(random_dna(rng, 1, 100), random_dna(rng, 1, 32))
             for _ in range(12)] + [("ACGT", "")]
    path = tmp_path / "pairs.txt"
    write_pair_file(path, pairs)
    flags = ["-pairs", str(path), "-algorithm", algorithm, "-traceback",
             "device", "-walker", "pallas"]
    a, b = tmp_path / "jax.txt", tmp_path / "torch.txt"
    assert jax_cli([*flags, "-out", str(a)]) == 0
    jax_err = capsys.readouterr().err.splitlines()
    assert torch_cli([*flags, "-device", "cpu", "-out", str(b)]) == 0
    torch_err = capsys.readouterr().err.splitlines()
    assert b.read_bytes() == a.read_bytes()
    assert torch_err[:4] == jax_err[:4]
    assert [ln.split(":")[0] for ln in torch_err[4:]] == \
        [ln.split(":")[0] for ln in jax_err[4:]]
    assert torch_err[-1] == jax_err[-1]  # GCUPS n/a: no kernel phase


def test_engine_refuses_an_unknown_walker():
    with pytest.raises(ValueError, match="walker"):
        AlignmentEngine(Algorithm.LNW, device="cpu", traceback="device",
                        walker="scan")


@pytest.fixture(scope="module")
def jax_anw_bsw_blocks(ds):
    out = {}
    for algo in (Algorithm.ANW, Algorithm.BSW):
        res = JaxEngine(algo, bucket_spec=SPEC, output="blocks").run(ds)
        out[algo] = (res.output_bytes(), res.scores())
    return out


@pytest.mark.parametrize("output", ["records", "blocks"])
@pytest.mark.parametrize("traceback", ["host", "device"])
@pytest.mark.parametrize("algo", [Algorithm.ANW, Algorithm.BSW],
                         ids=lambda a: a.value)
def test_anw_bsw_engine_matches_jax_engine(ds, jax_anw_bsw_blocks, algo,
                                           traceback, output):
    out = AlignmentEngine(algo, bucket_spec=SPEC, device="cpu",
                          traceback=traceback, output=output).run(ds)
    assert out.output_bytes() == jax_anw_bsw_blocks[algo][0]
    np.testing.assert_array_equal(out.scores(), jax_anw_bsw_blocks[algo][1])


@pytest.mark.parametrize("algo", [Algorithm.ANW, Algorithm.BSW],
                         ids=lambda a: a.value)
def test_anw_bsw_scores_only_match_jax_engine(ds, jax_anw_bsw_blocks, algo):
    out = AlignmentEngine(algo, bucket_spec=SPEC, device="cpu",
                          with_traceback=False, output="blocks").run(ds)
    np.testing.assert_array_equal(out.scores(), jax_anw_bsw_blocks[algo][1])


def test_bsw_takes_the_banded_fill_whatever_the_kernel(
        ds, jax_anw_bsw_blocks, monkeypatch):
    """As the JAX engine (runtime/engine.py:373-377): kernel="rowscan",
    the row-sweep fill for the other aligners, fills BSW with the banded
    fill."""
    from tpu_align_torch.kernels import banded, fill, stagger

    assert AlignmentEngine(Algorithm.LSW, device="cpu",
                           kernel="rowscan").kernel == "rowscan"
    calls = []

    def spy(real):
        def fill(*args, **kwargs):
            calls.append(real.__name__)
            return real(*args, **kwargs)
        return fill

    for mod, name in ((banded, "fill_banded_reference"),
                      (stagger, "fill_stagger_reference"),
                      (fill, "fill_rowscan_reference")):
        monkeypatch.setattr(mod, name, spy(getattr(mod, name)))
    out = AlignmentEngine(Algorithm.BSW, bucket_spec=SPEC, device="cpu",
                          kernel="rowscan", output="blocks").run(ds)
    assert calls and set(calls) == {"fill_banded_reference"}
    assert out.output_bytes() == jax_anw_bsw_blocks[Algorithm.BSW][0]


def test_bsw_alt_band_matches_jax_engine(ds):
    params = AlignmentParams(band=3)
    want = JaxEngine(Algorithm.BSW, params, bucket_spec=SPEC,
                     output="blocks", traceback="device").run(ds)
    got = AlignmentEngine(Algorithm.BSW, params, bucket_spec=SPEC,
                          device="cpu", output="blocks",
                          traceback="device").run(ds)
    assert got.output_bytes() == want.output_bytes()
