"""The stream step's two kernels (rabbitkssd_tpu_torch.ops.stream).

* ``keep_words`` (plain, CPU) equals the bit-packed ``ok & member_lane``
  of the JAX ``hash_windows_stream`` with the Pallas lane kernel in
  interpret mode, at L3K10 and L2K8, with ``block % 32`` 0 and 16;
* on a card (marker ``cuda``), both kernels equal their plain versions,
  with forced overflow, a near-full buffer and a dense kept table that
  flags more groups than the sparse mode's ``g_cap``.
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


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [L3K10, L2K8])
@pytest.mark.parametrize("block", [1 << 17, (1 << 17) - 16])
@pytest.mark.parametrize("kept", ["shuffled", "dense"])
def test_kernels_match_plain_on_card(cfg, block, kept):
    """Both kernels against their plain versions on the card, at the
    stream step's shape, with forced overflow and a near-full buffer.
    The dense kept table (half the dims kept) flags more 32-window
    groups than the sparse mode's g_cap, so only the first g_cap count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    params = KssdParams(*cfg)
    dev = torch.device("cuda")
    words, exc, table = _batch(params, 16, block, seed=3)
    if kept == "dense":
        table = np.random.default_rng(3).integers(
            0, 2 * params.dim_end, size=params.dim_size).astype(np.int32)
    halo = aligned_halo(params)
    h = StreamHasher(params)
    table_t, bitmap = keep_tables(table, params.dim_end, dev)
    tw = torch.from_numpy(words.view(np.int32)).to(dev)
    valid = _valid(words, exc).to(dev)
    upto = 16 * block - 1000
    before = keep_words.launches
    got = keep_words(tw, valid, upto, h, halo, bitmap)
    assert keep_words.launches == before + 1
    want = keep_words_plain(tw, valid, upto, h, halo, bitmap)
    assert torch.equal(got, want)
    n = 16 * block
    g_cap = (min(n // 32, max(4096, 4 * (n >> 4 * params.drlevel) // 32))
             if params.drlevel >= 3 and n % 32 == 0 else None)
    if kept == "dense" and g_cap is not None:
        assert int((got != 0).sum()) > g_cap
    for cap, buf_cap, count0 in ((1 << 17, 1 << 19, 100), (8, 64, 0),
                                 (1 << 12, 1 << 14, (1 << 14) - 100)):
        outs = []
        for fn in (compact_append, compact_append_plain):
            bufs = tuple(torch.zeros(buf_cap, dtype=torch.int32, device=dev)
                         for _ in range(4))
            c, o = fn(got, tw, table_t, bufs,
                      torch.tensor(count0, dtype=torch.int32, device=dev),
                      torch.zeros((), dtype=torch.bool, device=dev), 5, h,
                      halo, cap, buf_cap, g_cap)
            outs.append((int(c), bool(o), [b[: int(c)] for b in bufs]))
        (kc, ko, kb), (pc, po, pb) = outs
        assert (kc, ko) == (pc, po)
        for x, y in zip(kb, pb):
            assert torch.equal(x, y)
