"""What the benchmark runs imports neither JAX nor the JAX package nor
chip_smoke.py, compared by whole top-level name; the reference imports
nothing of the program."""

import ast
import subprocess
import sys
import types

from benchmarks import harness
from benchmarks.tests.conftest import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "tpu_align", "chip_smoke"}
# the yardstick: none of it may lean on the program
PLAIN = ("reference.py", "checks.py", "traffic.py", "roofline.py",
         "trace.py")


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _sources():
    return [p for p in harness.HERE.rglob("*.py") if "tests" not in p.parts]


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_the_yardstick_imports_nothing_of_the_program():
    for name in PLAIN:
        tops = {n.split(".")[0] for n in _imports(harness.HERE / name)}
        assert "tpu_align_torch" not in tops, name
    for path in (harness.HERE / "metrics").glob("*.py"):
        tops = {n.split(".")[0] for n in _imports(path)}
        assert "tpu_align_torch" not in tops, path


def test_the_check_compares_whole_top_level_names(monkeypatch):
    assert harness.forbidden_modules() == [] or "jax" in sys.modules
    for name in ("tpu_align_torch_extra", "jaxy", "flaxen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert not set(harness.forbidden_modules()) & {
        "tpu_align_torch_extra", "jaxy", "flaxen"}
    for name in ("tpu_align.core", "jaxlib", "flax.linen"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert {"tpu_align.core", "jaxlib", "flax.linen"} <= set(
        harness.forbidden_modules())


def test_a_whole_cpu_run_loads_none_of_them():
    code = (
        "import sys, json, time; sys.path.insert(0, %r)\n"
        "from benchmarks import harness\n"
        "from benchmarks.tests.conftest import tiny_cell\n"
        "bench = json.load(open(%r))\n"
        "for name in ('lnw-reads250-device', 'lnw-long16k-hirschberg'):\n"
        "    harness.run(tiny_cell(name), 5, 0.1, True, 'cpu', bench,\n"
        "                time.perf_counter(), log=lambda m: None)\n"
        "print(json.dumps(harness.forbidden_modules()))\n"
    ) % (str(REPO), str(REPO / "BENCHMARK.json"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
