"""Port sorted-set intersection and legacy distance paths
(rabbitkssd_tpu_torch.ops.intersect, the legacy engines and CLI
branches) vs the JAX package.

Exact comparison (tolerance 0): counts are integers and rows are text.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from rabbitkssd_tpu.cli import main as jax_main
from rabbitkssd_tpu.formats import read_sketches, save_sketches
from rabbitkssd_tpu.ops.intersect import common_counts_sorted as jax_sorted
from rabbitkssd_tpu.ops.intersect import pad_sketch_matrix as jax_pad
from rabbitkssd_tpu_torch.cli import main as port_main
from rabbitkssd_tpu_torch.ops.intersect import (common_counts_sorted,
                                                pad_sketch_matrix)

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
TOP = np.uint64(0xFFFFFFFFFFFFFFFF)


def _oracle(h0, h1):
    return np.array([[np.intersect1d(a, b).size for b in h1] for a in h0],
                    np.int32).reshape(len(h0), len(h1))


def _sets(rng, n, hi, size, dtype=np.uint64):
    return [np.unique(rng.integers(0, hi, size=int(rng.integers(0, size)))
                      .astype(dtype)) for _ in range(n)]


def _high_sets(rng, n, size):
    """64-bit hash sets reaching past 2^63; the even ones hold 2^64 - 1
    (the pad value) as a real hash."""
    out = []
    for i in range(n):
        lo = rng.integers(0, 2**62, size=size, dtype=np.uint64)
        hi = rng.integers(2**63, 2**64 - 1, size=size, dtype=np.uint64,
                          endpoint=True)
        out.append(np.unique(np.concatenate(
            [lo, hi, hi[: size // 2] ^ np.uint64(1)]
            + ([[TOP]] if i % 2 == 0 else []))))
    return out


def test_pad_sketch_matrix_matches_jax(rng):
    hashes = _high_sets(rng, 4, 70) + [np.empty(0, np.uint64)]
    got, got_sizes = pad_sketch_matrix(hashes)
    want, want_sizes = jax_pad(hashes)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_sizes, want_sizes)
    assert got.shape[1] % 128 == 0


def test_symmetric_matches_jax(rng):
    hashes = _sets(rng, 17, 50000, 700)
    got = common_counts_sorted(hashes, None, "cpu")
    np.testing.assert_array_equal(got, jax_sorted(hashes, None))
    np.testing.assert_array_equal(np.diag(got), [h.size for h in hashes])


def test_refquery_64bit_high_hashes(rng):
    """Hashes >= 2^63 keep their order through the int64 mapping, and a
    real 2^64 - 1 hash counts where both sides hold it despite equalling
    the pad, and only there."""
    ref = _high_sets(rng, 6, 150)
    qry = [np.unique(np.concatenate([rng.choice(ref[i % 6], size=90),
                                     [TOP]])) for i in range(4)]
    qry.append(ref[1][:40])  # no 2^64 - 1
    got = common_counts_sorted(qry, ref, "cpu")
    np.testing.assert_array_equal(got, jax_sorted(qry, ref))
    np.testing.assert_array_equal(got, _oracle(qry, ref))
    np.testing.assert_array_equal(
        common_counts_sorted(ref, qry, "cpu"), got.T)


@pytest.mark.parametrize("case", ["some_empty", "all_empty"])
def test_empty_sketches(rng, case):
    empty = np.empty(0, np.uint64)
    if case == "some_empty":
        h0 = _sets(rng, 5, 3000, 300) + [empty]
        h1 = [empty] + _sets(rng, 3, 3000, 300) + [empty]
        want = jax_sorted(h0, h1)
    else:
        h0, h1 = [empty, empty], [empty]
        want = np.zeros((2, 1), np.int32)
    got = common_counts_sorted(h0, h1, "cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _oracle(h0, h1))
    np.testing.assert_array_equal(
        common_counts_sorted([], h1, "cpu"), np.zeros((0, len(h1))))


@pytest.mark.parametrize("chunk", [1, 2, 5])
def test_small_chunks(rng, chunk):
    """Passes over a few rows of the second side at a time give the
    one-pass counts (11 rows: ragged last chunk for 2 and 5)."""
    h0 = _sets(rng, 7, 4000, 400, np.uint32)
    h1 = _sets(rng, 11, 4000, 400, np.uint32)
    got = common_counts_sorted(h0, h1, "cpu", chunk=chunk)
    np.testing.assert_array_equal(got, common_counts_sorted(h0, h1, "cpu"))
    np.testing.assert_array_equal(got, jax_sorted(h0, h1))


@pytest.fixture(scope="module")
def legacy_inputs(tmp_path_factory):
    """The golden 7-genome k10s4l1 sketch (64-bit hashes) and a
    2-genome sketch of its g3 and g6 (g6 shares hashes with g0 and g5,
    whose sizes differ from its own, so the size0 column shows which
    side each dist branch takes it from)."""
    root = tmp_path_factory.mktemp("legacy")
    full = read_sketches(os.path.join(GOLDEN, "fa_k10s4l1.sketch"))
    sub = dataclasses.replace(
        full, sketches=full.sketches[3::3],
        info=dataclasses.replace(full.info, genome_number=2))
    save_sketches(sub, str(root / "small.sketch"))
    return root, os.path.join(GOLDEN, "fa_k10s4l1.sketch")


def _copy_in(src, dst_dir, name):
    dst = str(dst_dir / name)
    shutil.copy(src, dst)
    return dst


@pytest.mark.parametrize("leg", ["alldist", "dist_ref_ge_query",
                                 "dist_ref_lt_query"])
def test_legacy_cli_matches_jax(legacy_inputs, tmp_path, monkeypatch, leg):
    """KSSD_LEGACY_DIST=1: the port CLI's files equal the JAX CLI's,
    byte for byte (leading-space rows, strict < threshold, and for dist
    both size0 branches)."""
    root, big = legacy_inputs
    monkeypatch.setenv("KSSD_LEGACY_DIST", "1")
    outs = {}
    for tag, main, dev in (("jax", jax_main, []),
                           ("port", port_main, ["--device", "cpu"])):
        d = tmp_path / tag
        d.mkdir()
        b = _copy_in(big, d, "big.sketch")
        s = _copy_in(str(root / "small.sketch"), d, "small.sketch")
        out = str(d / "out.txt")
        if leg == "alldist":
            argv = ["alldist", "-i", b, "-o", out, "-D", "0.9"]
        elif leg == "dist_ref_ge_query":
            argv = ["dist", "-r", b, "-q", s, "-o", out, "-D", "1.0"]
        else:
            argv = ["dist", "-r", s, "-q", b, "-o", out, "-D", "1.0"]
        assert main(dev + argv) == 0
        with open(out, "rb") as f:
            outs[tag] = f.read()
    header = (b" genome0\t" if leg == "alldist" else b" referenceGenome\t")
    assert outs["port"].startswith(header)
    assert outs["port"].count(b"\n") > 1
    assert outs["port"] == outs["jax"]
