"""Port stream step (rabbitkssd_tpu_torch.engine.sketcher.StreamStep:
the valid mask, then ``keep_words`` and ``compact_append``, here their
plain versions) vs the JAX ``make_stream_step`` (the jitted
``_stream_step_body``) on the same inputs.

Equal (tolerance 0) buffer prefixes ``[:count]``, ``count`` and
``overflow``, from the same random buffer contents.  The JAX side runs
with its CPU default keep representation (the full-table gather).
Cases: sparse L3K10 and dense L2K8 compaction, 32-window groups aligned
to rows and straddling them (``block % 32 == 16``), forced survivor and
group overflow, a near-full buffer.
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
              compaction="auto", n_steps=2, count0=0):
    jstep = make_stream_step(params, words.shape[0], 0, cap, buf_cap,
                             compaction=compaction)
    jtables = (table, keep_rep_np(table, params.dim_end))
    fill = np.random.default_rng(9).integers(
        -2**31, 2**31, size=(4, buf_cap)).astype(np.int32)
    jb = (fill[0].view(np.uint32), fill[1].view(np.uint32), fill[2],
          fill[3], np.int32(count0), np.bool_(False))
    step = StreamStep(params, cap, buf_cap, compaction=compaction)
    tables = keep_tables(table, params.dim_end, "cpu")
    bufs = tuple(torch.from_numpy(f.copy()) for f in fill)
    count = torch.tensor(count0, dtype=torch.int32)
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
                          (10, 6, 3, "dense", 2), (8, 6, 2, "auto", 16)])
def test_step_forced_overflow(half_k, half_subk, drlevel, compaction, cap):
    """A tiny cap overflows: count stops at the capped writes, the flag
    is set, and the written prefix still equals JAX's."""
    params = KssdParams(half_k, half_subk, drlevel)
    words, exc, table = _inputs(params, 2, 1 << 14, seed=5)
    n, oflow = _run_both(params, words, exc, table, cap=cap,
                         buf_cap=4 * cap, valid_upto=2 << 14,
                         compaction=compaction, n_steps=3)
    assert oflow and n == 3 * cap


@pytest.mark.parametrize("cfg,nb,block", [
    ((10, 6, 3), 2, 4096),  # sparse, groups aligned to rows
    ((10, 6, 3), 2, 4112),  # sparse, groups straddle rows
    ((10, 6, 3), 3, 4112),  # n % 32 != 0: dense
    ((8, 6, 2), 2, 4096),   # drlevel < 3 (L2K8): dense
    ((8, 6, 2), 3, 4112),
])
def test_step_block_layouts(cfg, nb, block):
    """32-window groups over the flattened payload, with ``block % 32``
    0 and 16, in sparse and dense mode; a short valid_upto."""
    params = KssdParams(*cfg)
    words, exc, table = _inputs(params, nb, block, seed=nb * block)
    n, oflow = _run_both(params, words, exc, table, cap=1 << 12,
                         buf_cap=1 << 14, valid_upto=nb * block - 100)
    assert n > 0 and not oflow


def test_step_group_overflow():
    """More flagged 32-window groups than g_cap (4096; half the dims
    kept): only the first g_cap count, and the overflow flag is set."""
    params = KssdParams(10, 6, 3)
    words, exc, _ = _inputs(params, 2, 1 << 17, seed=6)
    table = np.random.default_rng(6).integers(
        0, 2 * params.dim_end, size=params.dim_size).astype(np.int32)
    n, oflow = _run_both(params, words, exc, table, cap=1 << 17,
                         buf_cap=1 << 19, valid_upto=2 << 17, n_steps=1)
    assert oflow and n > 4096


@pytest.mark.parametrize("cfg", [(10, 6, 3), (8, 6, 2)])
def test_step_near_full_buffer(cfg):
    """The count starts past buf_cap - cap: the batch lands at buf_cap -
    cap, over earlier slots, and the overflow flag is set."""
    params = KssdParams(*cfg)
    words, exc, table = _inputs(params, 2, 4096, seed=8)
    cap, buf_cap = 1 << 11, 1 << 13
    n, oflow = _run_both(params, words, exc, table, cap=cap,
                         buf_cap=buf_cap, valid_upto=2 * 4096, n_steps=1,
                         count0=buf_cap - cap + 7)
    assert oflow and buf_cap - cap < n <= buf_cap
