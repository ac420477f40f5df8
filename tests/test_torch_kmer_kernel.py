"""The port's K-step window hash (``rabbitkssd_tpu_torch.ops.kmer``:
``make_hash_kernel`` = ``hash_windows``) and its numpy helpers against
the JAX package's, on the CPU.

The cases are tests/test_kmer_kernel.py's (half_k 4 to 16, FASTQ
quality masking, block sizes, a committed reference shuffle): the same
seeded numpy inputs go through ``pack_blocks`` and both kernels, whose
h_lo, h_hi and keep must be equal at every window (valid or not), and
the kept hashes (``combine_hash_words``) must equal the exact oracle.
The copied helpers must return what the JAX ones return.  Exact
comparisons (tolerance 0): everything compared is an integer.
"""

import os

import numpy as np
import pytest
import torch

from rabbitkssd_tpu.ops import kmer as jax_kmer
from rabbitkssd_tpu.oracle import oracle_hashes_pyloop, sketch_records_oracle
from rabbitkssd_tpu.params import KssdParams
from rabbitkssd_tpu.shuffle import generate_shuffle, read_shuffle_file
from rabbitkssd_tpu_torch.ops import kmer

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

torch.set_num_threads(1)


def random_seq(rng, n, n_fraction=0.02, lower_fraction=0.2):
    bases = np.array(list("ACGTN"), dtype="U1")
    p = [(1 - n_fraction) / 4] * 4 + [n_fraction]
    s = rng.choice(bases, size=n, p=p)
    low = rng.random(n) < lower_fraction
    return "".join(np.where(low, np.char.lower(s), s)).encode()


def port_vs_jax(records, params, table, least_qual=0, block=4096):
    """The port's kept hashes, after asserting that every window's
    (h_lo, h_hi, keep) equals the JAX kernel's on the same blocks."""
    codes = kmer.encode_concat(records, least_qual)
    np.testing.assert_array_equal(
        codes, jax_kmer.encode_concat(records, least_qual))
    blocks, valid = kmer.pack_blocks(codes, block, params.kmer_size)
    jb, jv = jax_kmer.pack_blocks(codes, block, params.kmer_size)
    np.testing.assert_array_equal(blocks, jb)
    np.testing.assert_array_equal(valid, jv)
    want = [np.asarray(x) for x in
            jax_kmer.make_hash_kernel(params)(blocks, valid, table)]
    got = kmer.make_hash_kernel(params)(
        torch.from_numpy(blocks), torch.from_numpy(valid),
        torch.from_numpy(table))
    for g, w, name in zip(got, want, ("h_lo", "h_hi", "keep")):
        assert g.shape == w.shape, name
        g = g.numpy()
        if name != "keep":
            assert g.dtype == np.int64 and g.min() >= 0 and g.max() < 2**32
            g = g.astype(np.uint32)
        np.testing.assert_array_equal(g, w, err_msg=name)
    out = kmer.combine_hash_words(*got, use64=True)
    np.testing.assert_array_equal(
        out, jax_kmer.combine_hash_words(*want, use64=True))
    return out


@pytest.mark.parametrize(
    "half_k,half_subk,drlevel",
    [(8, 4, 1), (10, 4, 1), (12, 5, 2), (16, 4, 1), (5, 4, 1), (4, 4, 1)],
)
def test_kernel_matches_jax_and_oracle(rng, half_k, half_subk, drlevel):
    params = KssdParams(half_k=half_k, half_subk=half_subk, drlevel=drlevel)
    table = generate_shuffle(half_k, half_subk, drlevel).shuffled_dim.astype(
        np.int32)
    seqs = [random_seq(rng, n) for n in (1, 10, 400, 5000, 13000)]
    got = port_vs_jax([(s, None) for s in seqs], params, table)
    want = np.concatenate([np.asarray(oracle_hashes_pyloop(s, params, table),
                                      dtype=np.uint64) for s in seqs])
    np.testing.assert_array_equal(np.sort(got), np.sort(want))
    assert got.size == want.size  # multiset equality


def test_kernel_matches_jax_fastq(rng):
    params = KssdParams(half_k=8, half_subk=4, drlevel=1)
    table = generate_shuffle(8, 4, 1).shuffled_dim.astype(np.int32)
    seq = random_seq(rng, 4000)
    qual = rng.integers(30, 75, size=len(seq)).astype(np.uint8).tobytes()
    got = port_vs_jax([(seq, qual)], params, table, least_qual=53)
    want = oracle_hashes_pyloop(seq, params, table, quality=qual,
                                least_qual=53)
    np.testing.assert_array_equal(np.sort(got),
                                  np.sort(np.array(want, np.uint64)))


def test_kernel_block_boundaries(rng):
    """The same hashes whatever the block size (halo correctness)."""
    params = KssdParams(half_k=10, half_subk=4, drlevel=1)
    table = generate_shuffle(10, 4, 1).shuffled_dim.astype(np.int32)
    seq = random_seq(rng, 30000, n_fraction=0.01)
    ref = port_vs_jax([(seq, None)], params, table, block=1 << 16)
    for block in (64, 1000, 4096):
        got = port_vs_jax([(seq, None)], params, table, block=block)
        np.testing.assert_array_equal(np.sort(got), np.sort(ref))


def test_kernel_golden_shuffle(rng):
    """With a committed reference .shuf file, against the set oracle."""
    shuf = read_shuffle_file(os.path.join(GOLDEN, "k8s4l1.shuf"))
    params = KssdParams(half_k=shuf.k, half_subk=shuf.subk,
                        drlevel=shuf.drlevel)
    table = shuf.shuffled_dim.astype(np.int32)
    records = [(random_seq(rng, 8000), None) for _ in range(3)]
    got = np.unique(port_vs_jax(records, params, table)).astype(np.uint32)
    np.testing.assert_array_equal(
        got, sketch_records_oracle(records, params, table))


def test_combine_hash_words_32_bit(rng):
    lo = rng.integers(0, 2**32, size=50).astype(np.uint32)
    hi = rng.integers(0, 2**32, size=50).astype(np.uint32)
    keep = rng.random(50) < 0.5
    for use64 in (False, True):
        got = kmer.combine_hash_words(lo, hi, keep, use64)
        want = jax_kmer.combine_hash_words(lo, hi, keep, use64)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dim_end", [0, 16, 4096, 1 << 16])
def test_kept_dims_np(dim_end):
    table = np.random.default_rng(dim_end).permutation(1 << 16).astype(
        np.int32)
    table[:3] = [-1, -5, 70000]  # out of range: never kept
    got = kmer.kept_dims_np(table, dim_end)
    want = jax_kmer.kept_dims_np(table, dim_end)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_packing_helpers(rng):
    codes = rng.integers(-1, 4, size=(3, 256)).astype(np.int8)
    p, e = kmer.pack_codes_sparse_np(codes)
    jp, je = jax_kmer.pack_codes_sparse_np(codes)
    np.testing.assert_array_equal(p, jp)
    np.testing.assert_array_equal(e, je)
    np.testing.assert_array_equal(kmer.packed_to_words_np(p),
                                  jax_kmer.packed_to_words_np(jp))
    # the word rows are the layout the stream hasher reads: base i at bits
    # 2*(i%16) of word i//16, invalid bases as 0, two zero pad words
    words = kmer.packed_to_words_np(p)
    assert words.shape == (3, 256 // 16 + 2) and not words[:, -2:].any()
    base = (words[:, :16, None] >> (2 * np.arange(16))) & 3
    np.testing.assert_array_equal(base.reshape(3, 256),
                                  np.where(codes >= 0, codes, 0))

