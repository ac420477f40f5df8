"""The stream step's two kernels (rabbitkssd_tpu_torch.ops.stream).

* ``keep_words`` (plain, CPU) equals the bit-packed ``ok & member_lane``
  of the JAX ``hash_windows_stream`` with the Pallas lane kernel in
  interpret mode, at L3K10 and L2K8, with ``block % 32`` 0 and 16;
* on a card (marker ``cuda``), both kernels equal their plain versions
  at L3K10, L2K8, L3K12 (K = 24) and (16, 4, 1) (K = 32), with forced
  overflow, a near-full buffer and a dense kept table that
  flags more groups than the sparse mode's ``g_cap`` (a cut also placed
  on a ``stream_compact`` tile boundary), at keep-word counts that are
  no multiple of the tile and below one tile, and over 100
  back-to-back ``compact_append`` launches on one look-back scratch.
The split ``StreamStep`` against the JAX ``_stream_step_body`` is in
tests/test_torch_stream_step.py.

Exact comparisons (tolerance 0): everything compared is an integer.
Inputs are made from numpy seeds, at small block sizes.  The JAX side
is imported inside the tests that use it, so that on a card without jax
``python -m pytest tests/test_torch_stream_kernels.py -m cuda`` runs the
card test alone.
"""

import numpy as np
import pytest
import torch

from rabbitkssd_tpu_torch.engine.sketcher import aligned_halo
from rabbitkssd_tpu_torch.ops.kmer import (StreamHasher, pack_words_np,
                                           pad_exceptions)
from rabbitkssd_tpu_torch.ops.member import keep_tables
from rabbitkssd_tpu_torch.ops.stream import (compact_append,
                                             compact_append_plain,
                                             keep_words, keep_words_plain,
                                             pack_bits, unpack_bits)
from rabbitkssd_tpu_torch.params import KssdParams

torch.set_num_threads(1)

L3K10 = (10, 6, 3)
L2K8 = (8, 6, 2)
L3K12 = (12, 6, 3)  # K = 24: a 36-bit hash
K32 = (16, 4, 1)  # K = 32: the full 64-bit window, a 60-bit hash


def _batch(params, nb, block, seed):
    """(words u32[nb, nw], exc int32 padded, table int32[dim_size]) for
    random rows with ~2 % invalid bases, as the feeder lays them out."""
    rng = np.random.default_rng(seed)
    L = block + aligned_halo(params)
    codes = rng.integers(0, 4, size=(nb, L), dtype=np.int8)
    codes[rng.random((nb, L)) < 0.02] = -1
    flat, _, exc = pack_words_np(codes.ravel())
    words = np.concatenate([flat.reshape(nb, L // 16),
                            np.zeros((nb, 2), np.uint32)], axis=1)
    table = rng.permutation(params.dim_size).astype(np.int32)
    return words, pad_exceptions(exc, codes.size), table


def _valid(words, exc):
    nb, nw = words.shape
    L = 16 * (nw - 2)
    valid = torch.ones(nb * L + 1, dtype=torch.bool)
    valid.index_fill_(0, torch.from_numpy(exc).long(), False)
    return valid


def _jax_keep(params, words, exc, table, valid_upto):
    """The JAX stream step's keep mask over the flattened payload:
    ``ok & member_lane`` (interpret) of ``hash_windows_stream``."""
    import jax

    from rabbitkssd_tpu.ops.kmer import hash_windows_stream
    from rabbitkssd_tpu.ops.pallas_member import lane_table_np, member_lane

    nb, nw = words.shape
    halo = aligned_halo(params)
    L = 16 * (nw - 2)
    valid = np.ones(nb * L + 1, bool)
    valid[exc] = False
    coord = (np.arange(nb)[:, None] * (L - halo) + np.arange(L)[None, :]
             - halo)
    valid = valid[: nb * L].reshape(nb, L) & (coord < valid_upto)
    _, _, dim_id, ok = jax.jit(hash_windows_stream(params).windows)(
        words, valid)
    hit = member_lane(dim_id, lane_table_np(table, params.dim_end),
                      interpret=True)
    return np.asarray(ok & hit)[:, halo:].ravel()


@pytest.mark.parametrize("cfg,nb,block", [
    (L3K10, 4, 8192), (L3K10, 4, 8208), (L2K8, 3, 1024), (L2K8, 3, 1040)])
def test_keep_words_match_jax(cfg, nb, block):
    params = KssdParams(*cfg)
    words, exc, table = _batch(params, nb, block, seed=block + cfg[0])
    valid_upto = nb * block - 300  # mask the tape tail of the last row
    want = _jax_keep(params, words, exc, table, valid_upto)
    _, bitmap = keep_tables(table, params.dim_end, "cpu")
    got = keep_words(torch.from_numpy(words.view(np.int32)),
                     _valid(words, exc), valid_upto, StreamHasher(params),
                     aligned_halo(params), bitmap)
    assert got.dtype == torch.int32 and got.shape == (-(-want.size // 32),)
    assert want.any()
    np.testing.assert_array_equal(unpack_bits(got, want.size).numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  pack_bits(torch.from_numpy(want)).numpy())


def test_pack_bits_round_trip():
    rng = np.random.default_rng(4)
    keep = torch.from_numpy(rng.random(1000) < 0.3)
    w = pack_bits(keep)
    assert w.shape == (32,)
    assert torch.equal(unpack_bits(w, 1000), keep)
    assert int(w[-1]) >> 8 == 0  # bits past n are 0
    assert int(pack_bits(torch.ones(32, dtype=torch.bool))[0]) == -1


def test_wrappers_refuse_other_devices():
    params = KssdParams(*L3K10)
    h = StreamHasher(params)
    w = torch.zeros((2, 10), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        keep_words(w, w, 0, h, 32, w)
    with pytest.raises(ValueError, match="unsupported device"):
        compact_append(w, w, w, (w,) * 4, w, w, 0, h, 32, 1, 4, None)


def _card_compact(fn, keep, tw, table_t, h, halo, cap, buf_cap, count0,
                  g_cap, dev):
    """(count, overflow, buffers[:count]) of one compact + append from
    zeroed buffers."""
    bufs = tuple(torch.zeros(buf_cap, dtype=torch.int32, device=dev)
                 for _ in range(4))
    c, o = fn(keep, tw, table_t, bufs,
              torch.tensor(count0, dtype=torch.int32, device=dev),
              torch.zeros((), dtype=torch.bool, device=dev), 5, h, halo, cap,
              buf_cap, g_cap)
    return int(c), bool(o), [b[: int(c)] for b in bufs]


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [L3K10, L2K8, L3K12, K32])
@pytest.mark.parametrize("nb,block", [(16, 1 << 17), (16, (1 << 17) - 16),
                                      (1, 2048)])
@pytest.mark.parametrize("kept", ["shuffled", "dense"])
def test_kernels_match_plain_on_card(cfg, nb, block, kept):
    """Both kernels against their plain versions on the card, at the
    stream step's shape, with forced overflow and a near-full buffer;
    at 2^17 - 16 windows a row the keep words are no multiple of
    stream_compact's tile, and one row of 2048 is less than one tile.
    The dense kept table (half the dims kept) flags more 32-window
    groups than the sparse mode's g_cap, so only the first g_cap count;
    there the group cut also lands exactly on a tile boundary."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from rabbitkssd_tpu_torch.ops.stream import compact_tile_words

    params = KssdParams(*cfg)
    dev = torch.device("cuda")
    words, exc, table = _batch(params, nb, block, seed=3)
    if kept == "dense":
        table = np.random.default_rng(3).integers(
            0, 2 * params.dim_end, size=params.dim_size).astype(np.int32)
    halo = aligned_halo(params)
    h = StreamHasher(params)
    table_t, bitmap = keep_tables(table, params.dim_end, dev)
    tw = torch.from_numpy(words.view(np.int32)).to(dev)
    valid = _valid(words, exc).to(dev)
    n = nb * block
    upto = n - 1000
    before = keep_words.launches
    got = keep_words(tw, valid, upto, h, halo, bitmap)
    assert keep_words.launches == before + 1
    want = keep_words_plain(tw, valid, upto, h, halo, bitmap)
    assert torch.equal(got, want)
    g_cap = (min(n // 32, max(4096, 4 * (n >> 4 * params.drlevel) // 32))
             if params.drlevel >= 3 and n % 32 == 0 else None)
    modes = [g_cap]
    if kept == "dense" and g_cap is not None:
        flags = (got != 0).cpu()
        if nb > 1:
            assert int(flags.sum()) > g_cap
        modes.append(int(flags[: 3 * compact_tile_words()].sum()))
    for mode in modes:
        for cap, buf_cap, count0 in ((1 << 17, 1 << 19, 100), (8, 64, 0),
                                     (1 << 12, 1 << 14, (1 << 14) - 100)):
            (kc, ko, kb), (pc, po, pb) = (
                _card_compact(fn, got, tw, table_t, h, halo, cap, buf_cap,
                              count0, mode, dev)
                for fn in (compact_append, compact_append_plain))
            assert (kc, ko) == (pc, po)
            for x, y in zip(kb, pb):
                assert torch.equal(x, y)


@pytest.mark.cuda
def test_compact_back_to_back_on_card():
    """100 launches of compact_append on one stream (one look-back
    scratch, a new epoch each), cycling grids of 64, 64 and 1 tiles in
    sparse and dense mode: every count and overflow equals the plain
    version's, and so do the last launch's buffers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    dev = torch.device("cuda")
    params = KssdParams(*L3K10)
    halo = aligned_halo(params)
    h = StreamHasher(params)
    cycle = []
    for nb, block, g_cap in ((16, 1 << 17, 4096), (16, (1 << 17) - 16, None),
                             (1, 2048, 64)):
        words, exc, table = _batch(params, nb, block, seed=nb + block)
        table_t, bitmap = keep_tables(table, params.dim_end, dev)
        tw = torch.from_numpy(words.view(np.int32)).to(dev)
        keep = keep_words(tw, _valid(words, exc).to(dev), nb * block, h,
                          halo, bitmap)
        cycle.append((keep, tw, table_t, g_cap))
    cap, buf_cap = 1 << 12, 1 << 14
    want = [_card_compact(compact_append_plain, k, tw, t, h, halo, cap,
                          buf_cap, 7, g, dev) for k, tw, t, g in cycle]
    for i in range(100):
        got = _card_compact(compact_append, *cycle[i % 3][:3], h, halo, cap,
                            buf_cap, 7, cycle[i % 3][3], dev)
        assert got[:2] == want[i % 3][:2]
    for x, y in zip(got[2], want[99 % 3][2]):
        assert torch.equal(x, y)
