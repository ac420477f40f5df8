"""Nothing the benchmark loads is JAX or the JAX package, and the plain
reference imports nothing of the program either.  Top-level module
names are compared whole: ``rabbitkssd_tpu_torch`` is the program, not
``rabbitkssd_tpu``."""

from __future__ import annotations

import ast
import glob
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "kssd_bench")
FORBIDDEN = {"jax", "jaxlib", "flax", "rabbitkssd_tpu"}
PROGRAM = "rabbitkssd_tpu_torch"
sys.path.insert(0, ROOT)

from kssd_bench import harness  # noqa: E402


def _cell_modules(cell: str) -> list[tuple[str, str]]:
    """(kind, name) of every module a run of ``cell`` loads by name."""
    c = harness.load_json("cells", cell)
    mix = harness.load_json("traffic", c["traffic"])
    bench = harness.benchmark()
    metrics = (harness.cell_metrics(bench, cell, False)
               + harness.cell_metrics(bench, cell, True))
    return ([("traffic", mix["generator"]), ("checks", c["check"])]
            + [("metrics", m["name"]) for m in metrics])


@pytest.mark.parametrize("cell", harness.names("cells", ".json"))
def test_a_run_loads_no_jax(cell):
    loads = "".join(f"harness.load_module({k!r}, {n!r})\n"
                    for k, n in _cell_modules(cell))
    code = (f"import sys\nsys.path.insert(0, {ROOT!r})\n"
            "import kssd_bench.run, kssd_bench.controls, kssd_bench.trace\n"
            "from kssd_bench import harness\n"
            "from rabbitkssd_tpu_torch import cli\n" + loads +
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    top = set(eval(p.stdout.strip().splitlines()[-1]))
    assert PROGRAM in top
    assert not top & FORBIDDEN, sorted(top & FORBIDDEN)


def _imports(path: str) -> set[str]:
    """Top-level names of the absolute imports in a source file."""
    tree = ast.parse(open(path).read(), path)
    got = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            got |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            got.add(node.module.split(".")[0])
    return got


REFERENCE = sorted(glob.glob(os.path.join(BENCH, "reference", "*.py")))


@pytest.mark.parametrize("path", REFERENCE,
                         ids=[os.path.basename(p) for p in REFERENCE])
def test_reference_imports_neither_jax_nor_the_program(path):
    bad = _imports(path) & (FORBIDDEN | {PROGRAM})
    assert not bad, f"{path} imports {sorted(bad)}"


def test_reference_relative_imports_stay_inside_it():
    for path in REFERENCE:
        for node in ast.walk(ast.parse(open(path).read())):
            if isinstance(node, ast.ImportFrom) and node.level:
                assert node.level == 1, f"{path}: from {'.' * node.level}"


SOURCES = sorted(p for p in glob.glob(os.path.join(BENCH, "**", "*.py"),
                                      recursive=True)
                 if os.sep + "cache" + os.sep not in p)


def test_no_benchmark_source_imports_jax():
    for path in SOURCES:
        bad = _imports(path) & FORBIDDEN
        assert not bad, f"{path} imports {sorted(bad)}"


def test_benchmark_names_its_harness_alone():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    assert bench["paths"] == ["kssd_bench"]
    assert bench["command"][1].startswith("kssd_bench/")
