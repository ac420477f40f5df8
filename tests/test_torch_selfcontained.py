"""The port is self-contained: it imports nothing of the JAX package.

* An AST scan: no file under ``rabbitkssd_tpu_torch/``, and not
  ``chip_smoke.py``, imports ``rabbitkssd_tpu`` or ``rabbitkssd_tpu.*``
  (``rabbitkssd_tpu_torch`` shares the prefix and is allowed).
* A subprocess runs each of the port's nine subcommands on the small
  golden inputs with ``--device cpu``, then finds no module named
  ``rabbitkssd_tpu`` or ``rabbitkssd_tpu.*`` (nor jax) in ``sys.modules``;
  its shuffle file and alldist rows equal the reference binary's
  goldens.
"""

import ast
import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")


def _is_jax_package(name: str) -> bool:
    return name == "rabbitkssd_tpu" or name.startswith("rabbitkssd_tpu.")


def _port_files() -> list[str]:
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "rabbitkssd_tpu_torch")):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported(tree: ast.AST) -> list[str]:
    """Absolute module names a module imports, by statement or by an
    ``import_module``/``__import__`` call with a literal name."""
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            names.append(node.args[0].value)
    return names


def test_no_port_file_imports_the_jax_package():
    files = _port_files()
    assert len(files) >= 25  # the scan found the package
    bad = {}
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        hits = [m for m in _imported(tree) if _is_jax_package(m)]
        if hits:
            bad[os.path.relpath(path, REPO)] = hits
    assert not bad, bad


_CHILD = r"""
import json, sys
from rabbitkssd_tpu_torch.cli import main

cmds = [
    ["shuffle", "-k", "5", "-s", "4", "-l", "1", "-o", "new.shuf"],
    ["sketch", "-i", "fa.list", "-o", "a.sketch", "-L", "k5s4l1.shuf"],
    ["alldist", "-i", "a.sketch", "-o", "a.alldist", "-D", "1.0"],
    ["dist", "-r", "a.sketch", "-q", "fa_query.list", "-L", "k5s4l1.shuf",
     "-D", "1.0", "-o", "q.dist"],
    ["union", "-i", "a.sketch", "-o", "u.sketch"],
    ["sub", "--rs", "u.sketch", "--qs", "a.sketch", "-o", "s.sketch"],
    ["convert", "-i", "a.sketch", "-o", "kdir", "--reverse"],
    ["merge", "-i", "merge.list", "-o", "m.sketch"],
    ["info", "-i", "a.sketch", "-o", "a.info"],
]
rcs = [main(["--device", "cpu"] + c) for c in cmds]
loaded = sorted(m for m in sys.modules
                if m == "rabbitkssd_tpu" or m.startswith("rabbitkssd_tpu."))
print(json.dumps({"cmds": [c[0] for c in cmds], "rcs": rcs,
                  "loaded": loaded, "jax": "jax" in sys.modules}))
"""


def test_nine_subcommands_load_no_jax_package(tmp_path):
    shutil.copytree(os.path.join(GOLDEN, "genomes"), tmp_path / "genomes")
    for name in ("fa.list", "fa_query.list", "k5s4l1.shuf"):
        shutil.copy(os.path.join(GOLDEN, name), tmp_path)
    (tmp_path / "merge.list").write_text("a.sketch\nu.sketch\n")
    env = dict(os.environ, PYTHONPATH=REPO, KSSD_TIMER="0")
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["cmds"] == ["shuffle", "sketch", "alldist", "dist", "union",
                           "sub", "convert", "merge", "info"]
    assert got["rcs"] == [0] * 9
    assert got["loaded"] == [] and not got["jax"]
    for out in ("new.shuf", "a.sketch", "a.alldist", "q.dist", "u.sketch",
                "s.sketch", "kdir", "m.sketch", "a.info"):
        assert (tmp_path / out).exists(), out
    # the port's own host modules give the reference binary's files
    with open(tmp_path / "new.shuf", "rb") as f, \
            open(os.path.join(GOLDEN, "k5s4l1.shuf"), "rb") as g:
        assert f.read() == g.read()

    def rows(path):
        with open(path) as f:
            lines = f.readlines()
        return lines[:1] + sorted(lines[1:])

    assert rows(tmp_path / "a.alldist") == rows(
        os.path.join(GOLDEN, "fa_k5s4l1.alldist"))
