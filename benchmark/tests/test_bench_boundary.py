"""The import boundary: nothing the benchmark loads is JAX or the JAX
package, compared by whole top-level names; the reference and the frozen
generators load nothing of the program."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import run

BENCH = Path(run.__file__).resolve().parent


def test_top_level_names_compared_whole():
    mods = ["openpcseg_torch", "openpcseg_torch.ops", "jaxtyping",
            "flaxen.x", "numpy"]
    assert run.forbidden_modules(mods) == []
    assert run.forbidden_modules(mods + ["jaxlib.xla", "openpcseg_tpu.ops",
                                         "optax"]) == [
        "jaxlib", "openpcseg_tpu", "optax"]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    p for p in BENCH.rglob("*.py") if "tests" not in p.parts),
    ids=lambda p: str(p.relative_to(BENCH)))
def test_no_source_imports_jax(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & set(run.FORBIDDEN)
    if path.parent.name in ("reference", "scangen"):
        assert run.PROGRAM not in tops


def _loaded_after(code: str):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(' '.join("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, check=True, cwd=BENCH.parent)
    return set(out.stdout.split())


def test_reference_loads_nothing_of_the_program():
    tops = _loaded_after(
        "from benchmark.reference import geometry, minkunet\n"
        "from benchmark.scangen import raycast, raycast_waymo\n"
        "from benchmark.lib import checks, work, weights, scans, readers")
    assert run.PROGRAM not in tops
    assert not tops & set(run.FORBIDDEN)


def test_harness_with_the_program_loads_no_jax():
    tops = _loaded_after(
        "import benchmark.run, benchmark.calibrate\n"
        "import benchmark.drivers.train, benchmark.drivers.predict\n"
        "import openpcseg_torch.engine.task, openpcseg_torch.models")
    assert run.PROGRAM in tops
    assert not tops & set(run.FORBIDDEN)
