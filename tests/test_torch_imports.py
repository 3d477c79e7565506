"""The port runs without JAX and without the JAX package: the card's
machine has no JAX, and the port keeps its own copy of every host layer.

Subprocesses block `jax`, `jaxlib` and `tpu_align` (sys.modules[name] =
None makes every import of it fail), import the port's package, engine,
CLI, distributed layer and host copies, and align pairs on the CPU
through every path, a mesh of CPU shards too.  A static scan
holds every module of the package, and chip_smoke.py, to the same rule.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tpu_align_torch import Algorithm
from tpu_align_torch.runtime.engine import AlignmentEngine

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "tpu_align_torch"

_BLOCKED = """
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["tpu_align"] = None
import tpu_align_torch
import tpu_align_torch.cli
import tpu_align_torch.distributed
import tpu_align_torch.io.fasta
import tpu_align_torch.oracle.lcs
import tpu_align_torch.utils.pretty
import tpu_align_torch.utils.timing_analysis
from tpu_align_torch.distributed import make_pairs_mesh
from tpu_align_torch.io import PairDataset
from tpu_align_torch.oracle.api import align_pair
from tpu_align_torch.runtime.engine import AlignmentEngine
ds = PairDataset.from_pairs([("ACGT", "AGT"), ("GATTACA", "GCATGCT"),
                             ("A", "")])
out = AlignmentEngine(tpu_align_torch.Algorithm.LNW, device="cpu",
                      output="blocks").run(ds)
sys.stdout.write(out.output_text())
mesh = AlignmentEngine(tpu_align_torch.Algorithm.LNW, device="cpu",
                       output="blocks", traceback="device",
                       mesh=make_pairs_mesh(["cpu", "cpu"])).run(ds)
assert mesh.output_text() == out.output_text()
assert align_pair(tpu_align_torch.Algorithm.LNW,
                  tpu_align_torch.AlignmentParams(), "ACGT", "AGT").score == 7
assert sys.modules["jax"] is None and sys.modules["tpu_align"] is None
"""


def test_port_aligns_with_jax_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED], cwd=REPO, capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO)},
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == (
        "0 | 7\nACGT\n* **\nA_GT\n"
        "1 | 6\nG_ATTACA\n* **| *|\nGCATG_CT\n"
        "2 | -2\nA\n \n_\n"
    )


# JAX and the whole JAX package, its jax-free modules too; the prefix
# check below spares tpu_align_torch
_FORBIDDEN = ("jax", "jaxlib", "tpu_align")


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [
    REPO / "chip_smoke.py"], ids=lambda p: str(p.relative_to(REPO)))
def test_module_imports_no_jax(path):
    bad = [m for m in _imports(path)
           if any(m == f or m.startswith(f + ".") for f in _FORBIDDEN)]
    assert not bad, f"{path.name} imports {bad}"


def test_cuda_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="cuda"):
        AlignmentEngine(Algorithm.LNW, device="cuda")


def test_cli_cuda_device_exits_2_without_cuda(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from tpu_align_torch.cli import main

    path = tmp_path / "pairs.txt"
    path.write_text("0\nACGT\nAGT\n")
    assert main(["-pairs", str(path)]) == 2
    assert "is_available" in capsys.readouterr().err


_BLOCKED_DEVICE = """
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["tpu_align"] = None
import tpu_align_torch
from tpu_align_torch.io import PairDataset
from tpu_align_torch.oracle.api import align_pair
from tpu_align_torch.runtime.engine import AlignmentEngine
algo = tpu_align_torch.Algorithm({algo!r})
pairs = [("ACGT", "AGT"), ("GATTACA", "GCATGCT"), ("A", ""), ("TTTT", "AAAA")]
out = AlignmentEngine(algo, device="cpu", output="blocks",
                      traceback="device").run(PairDataset.from_pairs(pairs))
want = "".join(align_pair(algo, tpu_align_torch.AlignmentParams(), r, q,
                          pair_num=k).block() for k, (r, q) in enumerate(pairs))
assert out.output_text() == want, out.output_text()
host = AlignmentEngine(algo, device="cpu", output="blocks",
                       traceback="host").run(PairDataset.from_pairs(pairs))
assert host.output_text() == want, host.output_text()
assert sys.modules["jax"] is None and sys.modules["tpu_align"] is None
"""


@pytest.mark.parametrize("algo", ["lnw", "lsw", "anw", "bsw"])
def test_device_traceback_with_jax_blocked(algo):
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_DEVICE.format(algo=algo)], cwd=REPO,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO)},
    )
    assert proc.returncode == 0, proc.stderr


_BLOCKED_HIRSCHBERG = """
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["tpu_align"] = None
import tpu_align_torch
from tpu_align_torch.io import PairDataset
from tpu_align_torch.oracle.api import align_pair
from tpu_align_torch.runtime.engine import AlignmentEngine
algo = tpu_align_torch.Algorithm({algo!r})
pairs = [("ACGTTGCA" * 5, "ACGTGCA" * 6), ("GATTACA", "GCATGCT"), ("A", "")]
ds = PairDataset.from_pairs(pairs)
params = tpu_align_torch.AlignmentParams()
want = [align_pair(algo, params, r, q, pair_num=k)
        for k, (r, q) in enumerate(pairs)]
rows = AlignmentEngine(algo, device="cpu", output="blocks",
                       kernel="rowscan").run(ds)
assert rows.output_text() == "".join(w.block() for w in want)
hb = AlignmentEngine(algo, device="cpu", output="records",
                     traceback="hirschberg").run(ds)
assert [r.score for r in hb.results] == [w.score for w in want]
assert sys.modules["jax"] is None and sys.modules["tpu_align"] is None
"""


@pytest.mark.parametrize("algo", ["lnw", "lsw", "anw"])
def test_rowscan_and_hirschberg_with_jax_blocked(algo):
    """The new paths import no jax either: the rowscan engine path prints
    the oracle's blocks, and Hirschberg its scores."""
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_HIRSCHBERG.format(algo=algo)],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO)},
    )
    assert proc.returncode == 0, proc.stderr


_BLOCKED_OPS = """
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["tpu_align"] = None
import torch
from tpu_align_torch.ops import dpx
from tpu_align_torch.scripts import exp_s16x2
x = torch.from_numpy(exp_s16x2.inputs(512))
for packed in (False, True):
    assert torch.equal(exp_s16x2.run_core(x, packed, 3),
                       exp_s16x2.run_core_reference(x, packed, 3))
v, hi, lo = dpx.vibmax_s16x2(0xFFFD00FF, 0xFFFE01FF)
assert int(v.view(torch.int32)) & 0xFFFFFFFF == 0xFFFE01FF
assert not bool(hi) and not bool(lo)
assert sys.modules["jax"] is None and sys.modules["tpu_align"] is None
"""


def test_dpx_and_s16x2_with_jax_blocked():
    """The DPX op layer and the s16x2 experiment's core import no jax."""
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_OPS], cwd=REPO, capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO)},
    )
    assert proc.returncode == 0, proc.stderr
