"""Port window hash (rabbitkssd_tpu_torch.ops.kmer) vs the JAX
``hash_windows_stream`` and the numpy oracle.

Exact comparison (tolerance 0): codes, dim_ids and flags are integers.
"""

import jax
import numpy as np
import pytest
import torch

from rabbitkssd_tpu.oracle import oracle_hashes_numpy
from rabbitkssd_tpu.ops.kmer import hash_windows_stream
from rabbitkssd_tpu.params import KssdParams
from rabbitkssd_tpu_torch.ops.kmer import StreamHasher, pack_words_np

torch.set_num_threads(1)

GRID = [(5, 4, 1), (8, 4, 1), (10, 6, 3), (12, 6, 3), (16, 4, 1)]


def _rows(rng, nb: int, L: int):
    """Random code rows with N runs -> (codes int8[nb, L], words
    u32[nb, L/16 + 2])."""
    codes = rng.integers(0, 4, size=(nb, L)).astype(np.int8)
    for r in range(nb):
        for _ in range(3):
            st = int(rng.integers(0, L - 40))
            codes[r, st:st + int(rng.integers(1, 30))] = -1
    words = np.zeros((nb, L // 16 + 2), np.uint32)
    for r in range(nb):
        words[r, :L // 16] = pack_words_np(codes[r])[0]
    return codes, words


@pytest.mark.parametrize("half_k,half_subk,drlevel", GRID)
def test_windows_match_jax(half_k, half_subk, drlevel):
    rng = np.random.default_rng(100 + half_k)
    params = KssdParams(half_k, half_subk, drlevel)
    codes, words = _rows(rng, 3, 2048)
    valid = codes >= 0
    jh = hash_windows_stream(params)
    j_lo, j_hi, j_dim, j_ok = (np.asarray(x) for x in
                               jax.jit(jh.windows)(words, valid))
    h = StreamHasher(params)
    lo, hi, dim, ok = h.windows(torch.from_numpy(words.view(np.int32)),
                                torch.from_numpy(valid))
    np.testing.assert_array_equal(ok.numpy(), j_ok)
    np.testing.assert_array_equal(dim.numpy(), j_dim.astype(np.int32))
    np.testing.assert_array_equal(lo.numpy(), j_lo.astype(np.int64))
    np.testing.assert_array_equal(hi.numpy(), j_hi.astype(np.int64))
    pf = rng.integers(0, params.dim_end, size=lo.shape).astype(np.int32)
    c_lo, c_hi = h.compose(lo, hi, torch.from_numpy(pf))
    jc_lo, jc_hi = jax.jit(jh.compose)(j_lo, j_hi, pf)
    np.testing.assert_array_equal(c_lo.numpy(), np.asarray(jc_lo))
    np.testing.assert_array_equal(c_hi.numpy(), np.asarray(jc_hi))


@pytest.mark.parametrize("half_k,half_subk,drlevel", GRID)
def test_survivors_match_oracle(half_k, half_subk, drlevel):
    """Keep test by table gather + compose == the oracle's hash multiset
    for a genome laid at the start of one row."""
    rng = np.random.default_rng(200 + half_k)
    params = KssdParams(half_k, half_subk, drlevel)
    table = rng.permutation(params.dim_size).astype(np.int32)
    codes, words = _rows(rng, 1, 4096)
    seq = np.frombuffer(b"ACGT", np.uint8)[np.maximum(codes[0], 0)].copy()
    seq[codes[0] < 0] = ord("N")
    want = oracle_hashes_numpy(seq.tobytes(), params, table)

    h = StreamHasher(params)
    lo, hi, dim, ok = h.windows(torch.from_numpy(words.view(np.int32)),
                                torch.from_numpy(codes >= 0))
    pf = torch.from_numpy(table)[dim.long()]
    keep = ok & (pf >= 0) & (pf < params.dim_end)
    c_lo, c_hi = h.compose(lo[keep], hi[keep], pf[keep])
    got = (c_hi.numpy().astype(np.uint64) << np.uint64(32)) \
        | c_lo.numpy().astype(np.uint64)
    np.testing.assert_array_equal(np.sort(got),
                                  np.sort(np.asarray(want, np.uint64)))
