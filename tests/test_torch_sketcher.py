"""Port sketcher (rabbitkssd_tpu_torch.engine.sketcher) vs the JAX
``DeviceSketcher`` and the reference-binary golden sketches.

Exact comparison (tolerance 0): per-genome sorted hash sets.
"""

import os

import numpy as np
import pytest
import torch

from rabbitkssd_tpu.engine.sketcher import DeviceSketcher as JaxSketcher
from rabbitkssd_tpu.formats import read_sketches
from rabbitkssd_tpu.params import KssdParams
from rabbitkssd_tpu.shuffle import generate_shuffle, read_shuffle_file
from rabbitkssd_tpu_torch.engine.sketcher import (DeviceSketcher,
                                                  StreamStep,
                                                  sketch_file_list)
from rabbitkssd_tpu_torch.ops.kmer import pack_words_np

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _genomes(rng, sizes, n_runs=True):
    out = []
    for n in sizes:
        g = rng.integers(0, 4, size=n).astype(np.int8)
        if n_runs and n > 100:
            st = int(rng.integers(0, n - 60))
            g[st:st + int(rng.integers(1, 40))] = -1
        out.append(g)
    return out


def _both(k, s, l, genomes, make_src=None, cap=None, **kw):
    """(port hashes, jax hashes) for the same genome sources."""
    shuf = generate_shuffle(k, s, l)
    params = KssdParams(k, s, l)
    make_src = make_src or (lambda: iter([g.copy() for g in genomes]))
    port = DeviceSketcher(params, shuf.shuffled_dim, device="cpu",
                          n_blocks=2, block=2048, **kw)
    if cap is not None:
        port.cap = cap
        port.step = StreamStep(params, cap, port.buf_cap)
    got, n = port.sketch_codes(make_src())
    want, n2 = JaxSketcher(params, shuf.shuffled_dim, n_blocks=2,
                           block=2048, **kw).sketch_codes(make_src())
    assert n == n2 == len(genomes)
    return got, want, port


def _assert_equal(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype, i
        np.testing.assert_array_equal(a, b, err_msg=f"genome {i}")


@pytest.mark.parametrize("k,s,l", [(8, 4, 1), (10, 6, 3), (12, 6, 3)])
def test_many_small_genomes(k, s, l):
    """Genome boundaries inside shared blocks; drlevel 3 takes the
    32-window group compaction, (12, 6, 3) the 64-bit hashes."""
    rng = np.random.default_rng(k * 10 + l)
    genomes = _genomes(rng, [int(x) for x in rng.integers(5, 3000, 37)])
    got, want, port = _both(k, s, l, genomes)
    _assert_equal(got, want)
    assert port.last_budget["batches"] >= 2


def test_chunked_and_packed_sources():
    """Chunked int8 iterators and native-style packed tuples feed the
    same tape as whole arrays."""
    rng = np.random.default_rng(3)
    genomes = _genomes(rng, [40_000, 700, 9_000])

    def src():
        big = genomes[0]
        yield (big[i:i + 4096] for i in range(0, len(big), 4096))
        yield pack_words_np(genomes[1])
        yield iter([pack_words_np(genomes[2][:4096]),
                    genomes[2][4096:]])

    got, want, _ = _both(8, 4, 1, genomes, make_src=src)
    _assert_equal(got, want)
    whole, _, _ = _both(8, 4, 1, genomes)
    _assert_equal(got, whole)


def test_forced_overflow_reruns_exactly():
    """A tiny per-batch cap overflows every window; the full-capacity
    re-run keeps the result exact."""
    rng = np.random.default_rng(5)
    genomes = _genomes(rng, [30_000, 5_000])
    got, want, port = _both(5, 4, 1, genomes, cap=64)
    _assert_equal(got, want)
    assert port.last_budget["reruns"] == port.last_budget["batches"]
    assert got[0].size > 64


def test_least_num_kmer():
    """The fastq abundance filter (-n 2): repeated genome content."""
    rng = np.random.default_rng(9)
    base = rng.integers(0, 4, size=3000).astype(np.int8)
    genomes = [np.concatenate([base, np.full(5, -1, np.int8), base[:1500]]),
               _genomes(rng, [4000])[0]]
    got, want, _ = _both(8, 4, 1, genomes, least_num_kmer=2)
    _assert_equal(got, want)
    assert got[0].size > 0


@pytest.mark.parametrize(
    "shuf_name,golden,lst,kwargs",
    [
        ("k5s4l1.shuf", "fa_k5s4l1.sketch", "fa.list", {}),
        ("k8s4l1.shuf", "fa_k8s4l1.sketch", "fa.list", {}),
        ("k10s4l1.shuf", "fa_k10s4l1.sketch", "fa.list", {}),
        ("k8s4l1.shuf", "fq_k8s4l1.sketch", "fq.list",
         {"least_num_kmer": 2, "least_qual": 40}),
        ("k8s4l1.shuf", "faq_k8s4l1.sketch", "fa_query.list", {}),
    ],
)
def test_sketch_file_list_goldens(shuf_name, golden, lst, kwargs,
                                  monkeypatch):
    monkeypatch.chdir(GOLDEN)
    shuf = read_shuffle_file(shuf_name)
    ours = sketch_file_list(lst, shuf, device="cpu", n_blocks=4,
                            block=1 << 14, **kwargs)
    want = read_sketches(golden)
    assert ours.info.id == want.info.id
    assert ours.info.use64 == want.info.use64
    w = {s.name: np.sort(s.hashes) for s in want.sketches}
    assert sorted(s.name for s in ours.sketches) == sorted(w)
    for s in ours.sketches:
        np.testing.assert_array_equal(s.hashes, w[s.name], err_msg=s.name)
        assert s.hashes.dtype == w[s.name].dtype


def test_streaming_finalization_bounded():
    """A 3-batch flush window: genomes finalize as the tape passes their
    ends, so the pending survivor pool stays well below the corpus
    total, and the result equals the JAX sketcher's."""
    rng = np.random.default_rng(13)
    genomes = _genomes(rng, [6000] * 40)
    shuf = generate_shuffle(8, 4, 1)
    params = KssdParams(8, 4, 1)
    sk = DeviceSketcher(params, shuf.shuffled_dim, device="cpu",
                        n_blocks=2, block=2048)
    sk.buf_cap = 4 * sk.cap
    sk.step = StreamStep(params, sk.cap, sk.buf_cap)
    got, n = sk.sketch_codes(iter([g.copy() for g in genomes]))
    assert n == 40
    total = sum(int(h.size) for h in got)
    assert 0 < sk.last_peak_pending < max(2 * sk.cap, total // 2)
    want, _ = JaxSketcher(params, shuf.shuffled_dim, n_blocks=2,
                          block=2048).sketch_codes(iter(genomes))
    _assert_equal(got, want)
