"""Port ref-vs-query distance (rabbitkssd_tpu_torch.engine.dist_engine
``run_dist``, ``dist_rows``, ``_topn_heap`` and the CLI ``dist``) vs the
JAX package and the reference binary's goldens.

Exact comparison (tolerance 0): counts are integers and rows are text.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from rabbitkssd_tpu.engine.dist_engine import run_dist as jax_run_dist
from rabbitkssd_tpu.formats import read_sketches
from rabbitkssd_tpu.utils.stdheap import StdPriorityQueue
from rabbitkssd_tpu_torch.cli import main as port_main
from rabbitkssd_tpu_torch.engine.dist_engine import (_bulk_dist,
                                                     _containment_aaf,
                                                     _jaccard_mash,
                                                     _Neighbor, _topn_heap,
                                                     run_dist)
from test_torch_alldist import synthetic  # noqa: F401  (module fixture)

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _sorted_rows(path):
    with open(path) as f:
        lines = f.readlines()
    return lines[0], sorted(lines[1:])


@pytest.fixture(scope="module")
def golden_dir(tmp_path_factory):
    """The golden genomes, query list and k8s4l1 reference sketch in one
    directory (the list names genomes relatively); the reference-side
    index is built once, by the first CLI run."""
    root = tmp_path_factory.mktemp("golden_dist")
    shutil.copytree(os.path.join(GOLDEN, "genomes"), root / "genomes")
    shutil.copy(os.path.join(GOLDEN, "fa_query.list"), root)
    shutil.copy(os.path.join(GOLDEN, "fa_k8s4l1.sketch"), root)
    return root


@pytest.mark.parametrize("n_top,golden", [(0, "fa_k8s4l1.dist"),
                                          (2, "fa_k8s4l1.distN2")])
def test_cli_dist_goldens(golden_dir, monkeypatch, n_top, golden):
    """Port CLI dist on the CPU device: the query side is sketched from
    FASTA, the rows equal the reference binary's; the reference side
    gets an index, the query side none."""
    monkeypatch.chdir(golden_dir)
    out = f"q{n_top}.dist"
    argv = ["--device", "cpu", "dist", "-r", "fa_k8s4l1.sketch", "-q",
            "fa_query.list", "-L", os.path.join(GOLDEN, "k8s4l1.shuf"),
            "-D", "1.0", "-o", out]
    assert port_main(argv + (["-N", str(n_top)] if n_top else [])) == 0
    assert _sorted_rows(out) == _sorted_rows(os.path.join(GOLDEN, golden))
    assert os.path.exists("fa_k8s4l1.sketch.index")
    assert os.path.exists("fa_query.list.sketch")
    assert not os.path.exists("fa_query.list.sketch.index")


@pytest.fixture(scope="module")
def ref_query(synthetic):
    """The 150-genome synthetic sketch (with its 64-bit index) as the
    reference side, and perturbed copies of it as the query side (a
    ref/query axis swap would show)."""
    _, _, jdir = synthetic
    ref_path = str(jdir / "syn.sketch")
    ref = read_sketches(ref_path)
    qs = [dataclasses.replace(s, name=f"{s.name}#q",
                              hashes=s.hashes[g % 5 + 1:])
          for g, s in enumerate(ref.sketches)]
    return ref, dataclasses.replace(ref, sketches=qs), ref_path


@pytest.fixture(scope="module")
def jax_rows(ref_query, tmp_path_factory):
    """JAX run_dist bytes by (max_dist, containment, n_top), each
    computed once per module (its output does not depend on the block
    size)."""
    ref, query, _ = ref_query
    root = tmp_path_factory.mktemp("jax_dist")
    done = {}

    def rows(max_dist, containment, n_top):
        key = (max_dist, containment, n_top)
        if key not in done:
            out = str(root / "jax.dist")
            jax_run_dist(ref, query, out, max_dist=max_dist,
                         containment=containment, max_neighbor=n_top)
            with open(out, "rb") as f:
                done[key] = f.read()
        return done[key]

    return rows


_CASES = [(path, index, n_top, False, "128")
          for path in ("walk", "matmul")
          for index in ("consumed", "rebuilt")
          for n_top in (0, 2, 5)]
_CASES += [("walk", "consumed", 0, True, "128"),
           ("matmul", "rebuilt", 0, True, "128"),
           ("walk", "rebuilt", 0, False, ""),
           ("matmul", "rebuilt", 3, False, "")]


@pytest.mark.parametrize("path,index,n_top,containment,block", _CASES)
def test_run_dist_matches_jax(ref_query, jax_rows, tmp_path, monkeypatch,
                              path, index, n_top, containment, block):
    """Port run_dist == JAX run_dist, byte-equal files.  block "128":
    two query strips of the two-axis blocked path (150 > 128); "": one
    block.  matmul: device counting forced (int8 memberships and
    ``torch._int_mm`` on the CPU device); index: the reference side's
    persisted index consumed, or an in-memory index rebuilt."""
    ref, query, ref_path = ref_query
    max_dist = 0.05 if containment else 1.0
    if block:
        monkeypatch.setenv("KSSD_DIST_BLOCK", block)
    else:
        monkeypatch.delenv("KSSD_DIST_BLOCK", raising=False)
    want = jax_rows(max_dist, containment, n_top)
    monkeypatch.setenv("KSSD_DIST_PATH", path)
    if path == "matmul":
        monkeypatch.setenv("KSSD_HOST_JOIN_MAX", "0")
    monkeypatch.setenv("KSSD_USE_INDEX", "1" if index == "consumed" else "0")
    out = str(tmp_path / "port.dist")
    run_dist(ref, query, out, max_dist=max_dist, containment=containment,
             device="cpu", max_neighbor=n_top, ref_index_path=ref_path)
    with open(out, "rb") as f:
        got = f.read()
    assert got == want
    assert got.count(b"\n") > (n_top or 1) * len(query.sketches) // 2


@pytest.mark.parametrize("seed,containment", [(0, False), (1, False),
                                              (2, True)])
def test_topn_heap_matches_scalar_replay(seed, containment):
    """The candidate-jump top-N heap replays the reference's scalar
    push/pop sequence exactly (incl. ties and the fill phase)."""
    rng = np.random.default_rng(seed)
    f = _containment_aaf if containment else _jaccard_mash
    nr, kmer = 500, 16
    for trial in range(20):
        rsizes = rng.integers(1, 2000, size=nr).astype(np.int64)
        size1 = int(rng.integers(1, 2000))
        crow = np.minimum(rng.integers(0, 600, size=nr),
                          np.minimum(rsizes, size1))
        # inject exact ties and degenerate rows
        crow[rng.integers(0, nr, 30)] = 0
        crow[rng.integers(0, nr, 10)] = crow[int(rng.integers(0, nr))]
        bulk = _bulk_dist(crow, rsizes, size1, kmer, containment)
        max_dist = float(rng.choice([0.05, 0.3, 1.0]))
        n_top = int(rng.choice([1, 3, 7]))
        names = [f"r{j}" for j in range(nr)]
        got = _topn_heap(crow, bulk, names, rsizes, size1, kmer, max_dist,
                         f, n_top)
        want: StdPriorityQueue = StdPriorityQueue(
            lambda a, b: a.dist < b.dist)
        for j in range(nr):
            jorc, d = f(int(crow[j]), int(rsizes[j]), size1, kmer)
            if d <= max_dist:
                nb = _Neighbor(names[j], int(crow[j]), int(rsizes[j]),
                               jorc, d)
                if len(want) < n_top:
                    want.push(nb)
                elif d < want.top().dist:
                    want.push(nb)
                    want.pop()
        got_rows = [got.pop() for _ in range(len(got))]
        want_rows = [want.pop() for _ in range(len(want))]
        assert got_rows == want_rows, f"trial {trial}"


def test_cli_dist_info_id_mismatch(tmp_path, capsys):
    """Sketches of two shuffle files: exit 1 with the reference's text."""
    ref = shutil.copy(os.path.join(GOLDEN, "fa_k10s4l1.sketch"), tmp_path)
    qry = shutil.copy(os.path.join(GOLDEN, "fa_k5s4l1.sketch"), tmp_path)
    assert port_main(["--device", "cpu", "dist", "-r", ref, "-q", qry,
                      "-o", str(tmp_path / "x.dist")]) == 1
    err = capsys.readouterr().err
    assert ("ERROR: dist, the sketch infos between reference and query "
            "files are not match\ntry to use the same shuffle file") in err
    assert not os.path.exists(tmp_path / "x.dist")


def test_cli_dist_negative_max_dist(tmp_path, capsys):
    assert port_main(["--device", "cpu", "dist", "-r", "missing.sketch",
                      "-q", "missing.list", "-o", str(tmp_path / "x.dist"),
                      "-D", "-0.1"]) == 1
    assert "ERROR: dist, maxDist must be > 0" in capsys.readouterr().err
