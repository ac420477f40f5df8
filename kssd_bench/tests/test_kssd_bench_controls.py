"""Each cell's correctness control reads above the cell's limits, at a
size a test run holds; on a card the plain reference on the card agrees
with itself on the CPU.  The controls' readings at the cells' own sizes
come from ``kssd_bench/controls.py`` on the card (PERF.md)."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import kssd_bench_tiny as tiny  # noqa: E402

sys.path.insert(0, tiny.ROOT)
from kssd_bench.reference import shuffle as ref_shuffle  # noqa: E402


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return tiny.bench_copy(str(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
@pytest.mark.parametrize("seed", [1, 2 ** 33 + 5])
def test_control_fails_a_limit(copy, cell, seed):
    rc, out, err = tiny.run_in(copy, f"""
from kssd_bench import controls
print(json.dumps(controls.readings({cell!r}, {seed}, "cpu")))
""")
    assert rc == 0, err[-3000:]
    got = json.loads(out.strip().splitlines()[-1])
    over = {k: v for k, v in got["readings"].items()
            if v > got["limits"][k]}
    assert over, got


@pytest.mark.parametrize("sizes", [(5, 3, 1), (6, 4, 1), (8, 4, 2)])
def test_reference_shuffle_is_the_programs(tmp_path, sizes):
    k, s, l = sizes
    out = tmp_path / "p.shuf"
    p = subprocess.run([sys.executable, "-m", "rabbitkssd_tpu_torch.cli",
                        "shuffle", "-k", str(k), "-s", str(s), "-l", str(l),
                        "-o", str(out)], cwd=tiny.ROOT, capture_output=True,
                       text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=tiny.ROOT))
    assert p.returncode == 0, p.stderr
    assert out.read_bytes() == ref_shuffle.shuffle_bytes(k, s, l)


def test_fisher_yates_solves_the_loop():
    import torch

    for n in (1, 2, 3, 7, 100, 5000, 70000):
        for seed in (23, 1, 2659):
            v = list(range(n))
            js = (ref_shuffle.rand_stream(seed, max(n - 1, 0))
                  % torch.arange(n, 1, -1)).tolist()
            for i, j in zip(range(n - 1, 0, -1), js):
                v[i], v[j] = v[j], v[i]
            assert ref_shuffle.fisher_yates(torch.arange(n),
                                            seed).tolist() == v


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_reference_on_the_card_is_the_cpus(card, tmp_path):
    import torch

    from kssd_bench.reference import kssd
    from kssd_bench.traffic import fasta_corpus

    sizes = kssd.KssdSizes(10, 6, 3)
    table = ref_shuffle.shuffle_table(10, 6, 3)
    assert torch.equal(ref_shuffle.shuffle_table(10, 6, 3, card).cpu(),
                       table)
    got = fasta_corpus.make(str(tmp_path), tiny.MIXES["test-genomes"], 3,
                            torch.device("cpu"))
    with open(got["paths"]["list"]) as f:
        files = f.read().split()
    for path in files:
        a, na = kssd.genome_sketch(path, sizes, table)
        b, nb = kssd.genome_sketch(path, sizes, table.to(card))
        assert na == nb and np.array_equal(a, b)
