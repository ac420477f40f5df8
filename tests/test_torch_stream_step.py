"""Port stream step (rabbitkssd_tpu_torch.engine.sketcher.StreamStep) vs
the JAX ``make_stream_step`` on the same inputs.

Equal (tolerance 0) buffer prefixes ``[:count]``, ``count`` and
``overflow``.  The JAX side runs with its CPU default keep
representation (the full-table gather).
"""

import numpy as np
import pytest
import torch

import __graft_entry__
from rabbitkssd_tpu.engine.sketcher import keep_rep_np, make_stream_step
from rabbitkssd_tpu.params import KssdParams
from rabbitkssd_tpu_torch.engine.sketcher import StreamStep, aligned_halo
from rabbitkssd_tpu_torch.ops.kmer import pack_words_np, pad_exceptions
from rabbitkssd_tpu_torch.ops.member import keep_tables

torch.set_num_threads(1)


def _inputs(params, n_blocks, block, seed):
    """Word rows + exceptions built like ``__graft_entry__.entry()``."""
    rng = np.random.default_rng(seed)
    halo = aligned_halo(params)
    L = block + halo
    codes = rng.integers(0, 4, size=(n_blocks, L), dtype=np.int8)
    codes[codes == 3] = np.where(
        rng.random((codes == 3).sum()) < 0.02, -1, 3)
    flat_words, _, exc = pack_words_np(codes.ravel())
    words = np.concatenate([flat_words.reshape(n_blocks, L // 16),
                            np.zeros((n_blocks, 2), np.uint32)], axis=1)
    exc = pad_exceptions(exc, codes.size)
    table = rng.permutation(params.dim_size).astype(np.int32)
    return words, exc, table


def _run_both(params, words, exc, table, cap, buf_cap, valid_upto,
              compaction="auto", n_steps=2):
    jstep = make_stream_step(params, words.shape[0], 0, cap, buf_cap,
                             compaction=compaction)
    jtables = (table, keep_rep_np(table, params.dim_end))
    z = np.zeros(buf_cap, np.uint32)
    zi = np.zeros(buf_cap, np.int32)
    jb = (z, z.copy(), zi, zi.copy(), np.int32(0), np.bool_(False))
    step = StreamStep(params, cap, buf_cap, compaction=compaction)
    tables = keep_tables(table, params.dim_end, "cpu")
    bufs = tuple(torch.zeros(buf_cap, dtype=torch.int32) for _ in range(4))
    count = torch.zeros((), dtype=torch.int32)
    overflow = torch.zeros((), dtype=torch.bool)
    tw = torch.from_numpy(words.view(np.int32))
    te = torch.from_numpy(exc)
    for b in range(n_steps):
        jb = jstep(words, exc, jtables, *jb, np.int32(b),
                   np.int32(valid_upto))
        count, overflow = step(tw, te, tables, bufs, count, overflow, b,
                               valid_upto)
    jn = int(jb[4])
    assert int(count) == jn
    assert bool(overflow) == bool(jb[5])
    names = ("lo", "hi", "pos", "batch")
    for name, got, want in zip(names, bufs, jb[:4]):
        np.testing.assert_array_equal(
            got[:jn].numpy(), np.asarray(want)[:jn].view(np.int32),
            err_msg=name)
    return jn, bool(overflow)


def test_step_matches_jax_on_entry_inputs():
    """The ``__graft_entry__.entry()`` step arguments, two steps deep."""
    _, args = __graft_entry__.entry()
    words, exc, (table, _), *_rest = args
    params = KssdParams(half_k=10, half_subk=6, drlevel=3)
    n, oflow = _run_both(params, words, exc, table, cap=1 << 12,
                         buf_cap=1 << 14, valid_upto=int(args[-1]))
    assert n > 0 and not oflow


@pytest.mark.parametrize("valid_upto", [2 * 4096, 5000])
def test_step_dense_branch(valid_upto):
    """drlevel < 3 takes the dense rank scatter; a short valid_upto masks
    the tape tail."""
    params = KssdParams(half_k=8, half_subk=4, drlevel=1)
    words, exc, table = _inputs(params, 2, 4096, seed=3)
    n, oflow = _run_both(params, words, exc, table, cap=1 << 12,
                         buf_cap=1 << 14, valid_upto=valid_upto)
    assert n > 0 and not oflow


@pytest.mark.parametrize("half_k,half_subk,drlevel,compaction,cap",
                         [(8, 4, 1, "auto", 16), (10, 6, 3, "auto", 2),
                          (10, 6, 3, "dense", 2)])
def test_step_forced_overflow(half_k, half_subk, drlevel, compaction, cap):
    """A tiny cap overflows: count stops at the capped writes, the flag
    is set, and the written prefix still equals JAX's."""
    params = KssdParams(half_k, half_subk, drlevel)
    words, exc, table = _inputs(params, 2, 1 << 14, seed=5)
    n, oflow = _run_both(params, words, exc, table, cap=cap,
                         buf_cap=4 * cap, valid_upto=2 << 14,
                         compaction=compaction, n_steps=3)
    assert oflow and n == 3 * cap
