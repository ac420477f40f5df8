"""Tiny test-only cells, added to a copy of the benchmark as files only.

:func:`bench_copy` copies ``kssd_bench/`` and ``BENCHMARK.json`` into a
directory and adds a configuration (L2K6: half_k 6, half_subk 4,
drlevel 1, 20-bit hashes), two traffic mixes, two cells, and a
per-layer metric
(``test_commands``), each as a new file, plus their entries in the
copy's ``BENCHMARK.json``: what a later change that adds a cell does.
:func:`run_in` runs a cell of such a copy on the CPU in a subprocess.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "kssd_bench")

CONFIG = {"source": "test only", "sizes": {"half_k": 6, "half_subk": 4,
                                           "drlevel": 1}}
MIXES = {
    "test-genomes": {"generator": "fasta_corpus", "n_genomes": 6,
                     "genome_len": 30000, "ancestors": 2,
                     "snp_log10": [-2.6, -0.7], "n_runs": 4,
                     "n_run_max": 30, "length_spread": [0.7, 1.3]},
    "test-large": {"generator": "fasta_large", "large": [300000],
                   "snp_rate": 0.01, "n_runs": 16, "n_run_max": 120,
                   "n_contigs": 3, "contig_len": 20000, "lower_every": 3},
}
# cell -> (the cell it copies, traffic mix, changes)
CELLS = {
    "sketch.test-L2K6": ("sketch.bact-L3K10", "test-genomes", {}),
    # the chunked reader on a small file
    "sketchL.test-L2K6": ("sketch.mammal-L4K10", "test-large",
                          {"env": {"KSSD_STREAM_THRESHOLD": "100000"}}),
}
METRIC = '''"""Timed commands in the window (a test-only metric)."""


def read(rec):
    return len(rec.passes)
'''


def _write(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def bench_copy(dest: str) -> str:
    """A copy of the benchmark in ``dest`` with the test-only files, the
    program linked beside it."""
    shutil.copytree(BENCH, os.path.join(dest, "kssd_bench"),
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dest)
    # the program, and the benchmark's caches (native library, shuffle
    # files), as they are
    os.symlink(os.path.join(ROOT, "rabbitkssd_tpu_torch"),
               os.path.join(dest, "rabbitkssd_tpu_torch"))
    os.makedirs(os.path.join(BENCH, "cache"), exist_ok=True)
    os.symlink(os.path.join(BENCH, "cache"),
               os.path.join(dest, "kssd_bench", "cache"))
    b = os.path.join(dest, "kssd_bench")
    _write(os.path.join(b, "configs", "test-L2K6.json"), CONFIG)
    for name, mix in MIXES.items():
        _write(os.path.join(b, "traffic", f"{name}.json"), mix)
    for name, (like, mix, change) in CELLS.items():
        with open(os.path.join(b, "cells", f"{like}.json")) as f:
            cell = json.load(f)
        cell.update(config="test-L2K6", traffic=mix, **change)
        _write(os.path.join(b, "cells", f"{name}.json"), cell)
    with open(os.path.join(b, "metrics", "test_commands.py"), "w") as f:
        f.write(METRIC)
    with open(os.path.join(dest, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for m in bench["end_to_end"] + bench["per_layer"]:
        for name, (like, _, _) in CELLS.items():
            if like in m.get("workloads", ()):
                m["workloads"].append(name)
    bench["workloads"] += [{"name": n, "config": "test-L2K6", "traffic": t,
                            "chips": 1, "why": "test only"}
                           for n, (_, t, _) in CELLS.items()]
    bench["per_layer"].append({
        "name": "test_commands", "unit": "commands", "better": "higher",
        "source": "host_clock", "layer": "CLI", "moves": "sketch_Mbase_s",
        "workloads": ["sketch.test-L2K6"]})
    _write(os.path.join(dest, "BENCHMARK.json"), bench)
    return dest


PRELUDE = """
import json, sys, time
start = time.perf_counter()
sys.path[:0] = [{dest!r}, {root!r}]
"""


def run_in(dest: str, body: str, timeout: float = 300) -> tuple[int, str,
                                                                  str]:
    """Run ``body`` in a fresh interpreter with the copy ``dest`` (and
    the program) importable; ``start`` holds the time it began."""
    code = PRELUDE.format(dest=dest, root=ROOT) + body
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-c", code], cwd=dest, env=env,
                       capture_output=True, text=True, timeout=timeout)
    return p.returncode, p.stdout, p.stderr


def cpu_run(dest: str, cell: str, trace: int = 0, seed: int = 2 ** 31 + 7,
            seconds: float = 1.0, patch: str = "") -> dict:
    """The result of ``cell`` run on the CPU (``patch``: code run first,
    that breaks the program underneath)."""
    rc, out, err = run_in(dest, patch + f"""
from kssd_bench import harness
r = harness.run({cell!r}, {seed}, {seconds}, bool({trace}), start,
                device="cpu", require_card=False)
r.pop("_failures", None)
r.pop("_stages", None)
r.pop("_commands", None)
print(json.dumps(r))
""")
    assert rc == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])
