"""Numpy models of the stream kernels' work decompositions
(``csrc/stream_keep.cu``, ``csrc/stream_compact.cu``) against the
plain versions in rabbitkssd_tpu_torch.ops.stream, on the CPU.

The kernels run only on a card; these models follow their index math
step by step in Python so that an error in it shows here first:

* ``stream_keep``: a thread owns keep word g (windows 32g .. 32g+31 of
  the flattened payload), hashes its first window in full, rolls the
  forward and reverse-complement codes one base at a time, takes the
  K-window validity of its 32 windows from 16-byte chunks of the bool
  mask, reads the bitmap only under a set bit of its summary, and
  restarts at the next row where its word crosses a row break
  (``block % 32 == 16``); the summary itself against its definition;
* ``stream_compact``: tiles of threads x 4 keep words, tile ids from a
  ticket, exclusive prefixes by decoupled look-back through the
  :class:`LookbackScratch` the wrapper keeps (flags tagged with an
  epoch), with the tiles' steps interleaved in a random order; the
  ``g_cap`` cut inside a tile, on a tile boundary and at exactly the
  flagged count, the ``cap`` cut, a near-full buffer, a grid below one
  tile, and one writer for count and one for overflow.

Both models run at L3K10, L2K8, L3K12 (K = 24) and (16, 4, 1) (K = 32,
where the window mask and the forward code's shift take their 64-bit
edge).  Exact comparisons (tolerance 0): everything compared is an
integer.  The model's tile is 16 words (4 threads x 4) with a look-back window of
4 tiles, so that small batches span several tiles and several look-back
windows; the card's kernel has 1024 and 32.
"""

import numpy as np
import pytest
import torch

from rabbitkssd_tpu_torch.engine.sketcher import aligned_halo
from rabbitkssd_tpu_torch.ops.kmer import (StreamHasher, pack_words_np,
                                           pad_exceptions)
from rabbitkssd_tpu_torch.ops.member import (SUMMARY_BYTES, bitmap_summary,
                                             keep_tables, summary_np)
from rabbitkssd_tpu_torch.ops.stream import (LookbackScratch,
                                             compact_append_plain,
                                             keep_words_plain)
from rabbitkssd_tpu_torch.params import KssdParams

torch.set_num_threads(1)

L3K10 = (10, 6, 3)
L2K8 = (8, 6, 2)
L3K12 = (12, 6, 3)  # K = 24: a 36-bit hash, the complement's high word
K32 = (16, 4, 1)  # K = 32: the full 64-bit window, a 60-bit hash
CFGS = pytest.mark.parametrize("cfg", [L3K10, L2K8, L3K12, K32],
                               ids=["L3K10", "L2K8", "L3K12", "K32"])


def _kept_every(cfg) -> int:
    """About 1 in this many dims kept: summary bits both set and clear,
    and enough survivors in a few rows (K32's 65,536 dims: 1 in 32)."""
    return 32 if cfg == K32 else 64
M64 = (1 << 64) - 1
AGGREGATE, PREFIX = 1, 2


# --------------------------------------------------------------------------
# inputs
# --------------------------------------------------------------------------

_TABLES: dict = {}


def _tables(cfg, kept_every: int):
    """(table int32[dim_size], bitmap) with about 1 in ``kept_every``
    dims kept; cached per module."""
    key = (cfg, kept_every)
    if key not in _TABLES:
        params = KssdParams(*cfg)
        table = np.random.default_rng(kept_every).integers(
            0, kept_every * params.dim_end,
            size=params.dim_size).astype(np.int32)
        _TABLES[key] = (table, keep_tables(table, params.dim_end, "cpu")[1])
    return _TABLES[key]


def _batch(params, nb, block, seed):
    """(words u32[nb, nw], valid bool[nb*L + 1]) for random rows with
    ~2 % invalid bases, laid out as the feeder lays them out."""
    rng = np.random.default_rng(seed)
    L = block + aligned_halo(params)
    codes = rng.integers(0, 4, size=(nb, L), dtype=np.int8)
    codes[rng.random((nb, L)) < 0.02] = -1
    flat, _, exc = pack_words_np(codes.ravel())
    words = np.concatenate([flat.reshape(nb, L // 16),
                            np.zeros((nb, 2), np.uint32)], axis=1)
    valid = torch.ones(nb * L + 1, dtype=torch.bool)
    valid.index_fill_(0, torch.from_numpy(
        pad_exceptions(exc, codes.size)).long(), False)
    return words, valid


# --------------------------------------------------------------------------
# the window hash, as stream_hash.cuh computes it (Python ints)
# --------------------------------------------------------------------------

def _window_mask(TB):
    return M64 if TB >= 64 else (1 << TB) - 1


def _rev2_64(x):
    return sum(((x >> (2 * i)) & 3) << (62 - 2 * i) for i in range(32))


def _stream_bits(a, b, c, sh):
    ab = (b << 32) | a
    return ((ab >> sh) | (c << (64 - sh))) & M64 if sh else ab


def _canonical(a, b, c, sh, TB):
    m = _window_mask(TB)
    e = _stream_bits(a, b, c, sh) & m
    return min(_rev2_64(e) >> (64 - TB), ~e & m)


def _dim_id(uni, hoc2, dim_size):
    return (uni >> hoc2) & (dim_size - 1)


# --------------------------------------------------------------------------
# stream_keep: a thread owns a keep word
# --------------------------------------------------------------------------

def _valid_bits(vrow, s, L):
    """Validity of row positions s .. s+63 from five 16-byte chunks."""
    c0 = s >> 4
    v = 0
    for c in range(5):
        if (c0 + c) * 16 < L:
            chunk = vrow[(c0 + c) * 16:(c0 + c + 1) * 16]
            v |= sum(int(x != 0) << i for i, x in enumerate(chunk)) << (16 * c)
    return (v >> (s & 15)) & M64


def _valid_runs(v, K):
    length = 1
    while 2 * length <= K:
        v &= v >> length
        length *= 2
    if length < K:
        v &= v >> (K - length)
    return v & 0xFFFFFFFF


def _keep_run(wrow, vrow, L, q, nwin, halo, K, hoc2, bitmap, dim_size,
              summary, shift):
    nw = len(wrow)
    word_at = lambda i: int(wrow[i]) if i < nw else 0  # noqa: E731
    s = q + halo - (K - 1)
    TB = 2 * K
    m = _window_mask(TB)
    a = s >> 4
    e = _stream_bits(word_at(a), word_at(a + 1), word_at(a + 2),
                     2 * (s & 15)) & m
    f, r = _rev2_64(e) >> (64 - TB), ~e & m
    t = s + K
    nxt = _stream_bits(word_at(t >> 4), word_at((t >> 4) + 1),
                       word_at((t >> 4) + 2), 2 * (t & 15))
    top = TB - 2
    hit = 0
    for j in range(32):
        if j:
            base = (nxt >> (2 * (j - 1))) & 3
            f = ((f << 2) | base) & m
            r = (r >> 2) | ((base ^ 3) << top)
        d = _dim_id(min(f, r), hoc2, dim_size)
        i = d >> (5 + shift)  # the bitmap is read only under a summary bit
        word = int(bitmap[d >> 5]) if (summary[i >> 5] >> (i & 31)) & 1 else 0
        hit |= ((word >> (d & 31)) & 1) << j
    live = (1 << nwin) - 1
    return hit & _valid_runs(_valid_bits(vrow, s, L), K) & live


def keep_model(words, valid, valid_upto, params, bitmap):
    """Keep words by the kernel's decomposition: thread g for word g."""
    nb, nw = words.shape
    L = 16 * (nw - 2)
    halo = aligned_halo(params)
    block = L - halo
    n = nb * block
    G = -(-n // 32)
    K, hoc2 = params.kmer_size, 2 * params.half_outctx_len
    v = valid.numpy()
    bm = bitmap.numpy().view(np.uint32)
    summary, shift = bitmap_summary(bitmap, params.dim_size)
    summary = summary.numpy().view(np.uint32)
    out = np.zeros(G, np.uint32)
    for g in range(G):
        p0 = 32 * g
        end = min(p0 + 32, n, max(valid_upto, p0))
        row, q = divmod(p0, block)
        bits, j = 0, 0
        while p0 + j < end:  # a second run restarts at the next row
            nwin = min(end - p0 - j, block - q)
            bits |= _keep_run(words[row], v[row * L:(row + 1) * L], L, q,
                              nwin, halo, K, hoc2, bm, params.dim_size,
                              summary, shift) << j
            j += nwin
            row, q = row + 1, 0
        out[g] = bits
    return out


@CFGS
@pytest.mark.parametrize("block", [1024, 1040], ids=["mod32_0", "mod32_16"])
def test_keep_model_matches_plain(cfg, block):
    params = KssdParams(*cfg)
    words, valid = _batch(params, 3, block, seed=block + cfg[0])
    _, bitmap = _tables(cfg, _kept_every(cfg))
    upto = 3 * block - 37  # ends inside a word
    want = keep_words_plain(torch.from_numpy(words.view(np.int32)), valid,
                            upto, StreamHasher(params), aligned_halo(params),
                            bitmap).numpy().view(np.uint32)
    got = keep_model(words, valid, upto, params, bitmap)
    assert int(np.unpackbits(want.view(np.uint8)).sum()) > 20
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("half_subk", [3, 6, 7])
def test_bitmap_summary(half_subk):
    """A summary bit is set iff one of the bitmap words it covers is
    nonzero; it fits SUMMARY_BYTES with the smallest such run."""
    dim_size = 16 ** half_subk
    words = dim_size // 32
    bm = np.zeros(words, np.int32)
    rng = np.random.default_rng(half_subk)
    bm[rng.integers(0, words, size=50)] = rng.integers(1, 2**31, size=50)
    summary, shift = summary_np(bm, dim_size)
    assert summary.nbytes <= SUMMARY_BYTES
    assert shift == 0 or (words >> (shift - 1)) > 8 * SUMMARY_BYTES
    bits = np.unpackbits(summary.view(np.uint8), bitorder="little")
    want = (bm != 0).reshape(-1, 1 << shift).any(axis=1)
    np.testing.assert_array_equal(bits[:want.size].astype(bool), want)
    assert not bits[want.size:].any()
    # a bitmap keep_tables did not make gets the same summary at first use
    got, got_shift = bitmap_summary(torch.from_numpy(bm), dim_size)
    assert got_shift == shift
    np.testing.assert_array_equal(got.numpy(), summary)


# --------------------------------------------------------------------------
# stream_compact: tiles, look-back, the single writers
# --------------------------------------------------------------------------

THREADS, PER_THREAD, WINDOW = 4, 4, 4
TILE = THREADS * PER_THREAD


def _scratch_views(buf, tiles):
    """(ticket, aggregate, inclusive, flags) numpy views of the scratch,
    laid out as kssd_stream_compact reads it."""
    a = buf.numpy()
    return (a[:1].view(np.uint32), a[1:1 + tiles], a[1 + tiles:1 + 2 * tiles],
            a[1 + 2 * tiles:].view(np.uint32)[:tiles])


class CompactModel:
    """One launch of the kernel's decomposition over numpy buffers."""

    def __init__(self, keep, words, table, params, cap, buf_cap, g_cap,
                 count, overflow, batch_idx, bufs, scratch, tiles_cap,
                 epoch):
        self.keep = keep.view(np.uint32)
        self.G = len(self.keep)
        self.words, self.table, self.bufs = words, table, bufs
        self.K = params.kmer_size
        self.hoc2 = 2 * params.half_outctx_len
        self.subk4 = 4 * params.half_subk
        self.pf_bits = 4 * (params.half_subk - params.drlevel)
        self.dim_size = params.dim_size
        self.halo = aligned_halo(params)
        self.block = 16 * (words.shape[1] - 2) - self.halo
        self.cap, self.buf_cap, self.g_cap = cap, buf_cap, g_cap
        self.sparse = g_cap is not None
        self.count, self.overflow, self.batch_idx = count, overflow, batch_idx
        self.ticket, self.agg, self.inc, self.flags = _scratch_views(
            scratch, tiles_cap)
        self.epoch = epoch
        self.tiles = -(-self.G // TILE)
        self.count_writers, self.overflow_writers = [], []
        self.out_count = self.out_overflow = None

    def run(self, rng):
        """Start every tile, then step them in a random order until all
        end (a spinning tile yields)."""
        procs = [self._tile() for _ in range(self.tiles)]
        while procs:
            i = int(rng.integers(len(procs)))
            try:
                next(procs[i])
            except StopIteration:
                procs.pop(i)
        return self

    def _look_back(self, tile):
        excl, last = 0, tile - 1
        while last >= 0:
            lanes = [last - lane for lane in range(WINDOW)]
            while any(j >= 0 and int(self.flags[j]) >> 2 != self.epoch
                      for j in lanes):
                yield  # spin
            vals, prefix = [], None
            for lane, j in enumerate(lanes):
                state = int(self.flags[j]) & 3 if j >= 0 else 0
                if state == PREFIX and prefix is None:
                    prefix = lane
                vals.append(0 if j < 0 else int(
                    (self.inc if state == PREFIX else self.agg)[j]))
            if prefix is not None:
                return excl + sum(vals[:prefix + 1])
            excl += sum(vals)
            last -= WINDOW
        return excl

    def _tile(self):
        yield  # blocks start in any order
        tile = int(self.ticket[0])
        self.ticket[0] += 1
        yield
        w = np.zeros(TILE, np.uint32)
        part = self.keep[tile * TILE:(tile + 1) * TILE]
        w[:len(part)] = part
        w = w.reshape(THREADS, PER_THREAD)
        flagged = (w != 0).sum(1)
        surv = np.array([sum(bin(int(x)).count("1") for x in row)
                         for row in w])
        f_ex = np.cumsum(flagged) - flagged
        s_ex = np.cumsum(surv) - surv
        Gt, St = int(flagged.sum()), int(surv.sum())
        tile_sum = (St << 32) | Gt
        if tile == 0:
            excl = 0
            self.inc[0] = tile_sum
            self.flags[0] = (self.epoch << 2) | PREFIX
        else:
            self.agg[tile] = tile_sum
            self.flags[tile] = (self.epoch << 2) | AGGREGATE
            yield
            excl = yield from self._look_back(tile)
            self.inc[tile] = excl + tile_sum
            self.flags[tile] = (self.epoch << 2) | PREFIX
        yield
        Gp, Sp = excl & 0xFFFFFFFF, excl >> 32
        g_cap, cap = self.g_cap, self.cap
        c = self.count
        start = min(c, self.buf_cap - cap)
        cut_tile = self.sparse and Gp < g_cap <= Gp + Gt
        grank = Gp + f_ex
        r = Sp + s_ex
        counted = St
        if cut_tile and Gp + Gt > g_cap:
            mine = np.zeros(THREADS, np.int64)
            for th in range(THREADS):
                gr = grank[th]
                for x in w[th]:
                    if x and gr < g_cap:
                        mine[th] += bin(int(x)).count("1")
                    gr += x != 0
            r = Sp + np.cumsum(mine) - mine
            counted = int(mine.sum())
        if cut_tile:
            self.count_writers.append(tile)
            self.out_count = start + min(Sp + counted, cap)
        if tile == self.tiles - 1:
            n_sel, total = Gp + Gt, Sp + St
            self.overflow_writers.append(tile)
            self.out_overflow = bool(
                self.overflow or (self.sparse and n_sel > g_cap)
                or total > cap or c > self.buf_cap - cap)
            if not self.sparse or n_sel < g_cap:
                self.count_writers.append(tile)
                self.out_count = start + min(total, cap)
            self.ticket[0] = 0
        if self.sparse and Gp >= g_cap:
            return
        yield
        for th in range(THREADS):
            self._write(tile * TILE + th * PER_THREAD, w[th], int(grank[th]),
                        int(r[th]), start)

    def _write(self, g0, w, grank, r, start):
        for i, x in enumerate(w):
            x = int(x)
            if not x:
                continue
            if self.sparse and grank >= self.g_cap:
                break
            grank += 1
            while x and r < self.cap:
                p = (g0 + i) * 32 + (x & -x).bit_length() - 1
                self._append(start + r, p)
                x &= x - 1
                r += 1
            if r >= self.cap:
                break

    def _append(self, slot, p):
        row, q = divmod(p, self.block)
        s = q + self.halo - (self.K - 1)
        wr = self.words[row, s >> 4:(s >> 4) + 3].astype(np.int64)
        uni = _canonical(*(int(x) for x in wr), 2 * (s & 15), 2 * self.K)
        h = int(self.table[_dim_id(uni, self.hoc2, self.dim_size)]) \
            & 0xFFFFFFFF
        hoc2 = self.hoc2
        if hoc2:
            outer = (1 << hoc2) - 1
            h |= (uni & outer) << self.pf_bits
            h |= ((uni >> (hoc2 + self.subk4)) & outer) << (self.pf_bits
                                                            + hoc2)
        lo, hi, pos, bat = self.bufs
        lo[slot] = np.uint32(h & 0xFFFFFFFF).view(np.int32)
        hi[slot] = np.uint32(h >> 32).view(np.int32)
        pos[slot] = p
        bat[slot] = self.batch_idx


def _compact_case(cfg, nb, block, kept_every, seed):
    """(keep int32[G] from the plain keep words, words, table)."""
    params = KssdParams(*cfg)
    words, valid = _batch(params, nb, block, seed)
    table, bitmap = _tables(cfg, kept_every)
    keep = keep_words_plain(torch.from_numpy(words.view(np.int32)), valid,
                            nb * block - 5, StreamHasher(params),
                            aligned_halo(params), bitmap)
    return keep, words, table


def _run_both(params, keep, words, table, cap, buf_cap, g_cap, count0,
              scratch, rng, overflow0=False):
    """The model and the plain version from the same buffer contents;
    asserts they agree and returns the model."""
    sentinel = np.random.default_rng(7).integers(
        -2**31, 2**31, size=(4, buf_cap)).astype(np.int32)
    model_bufs = [b.copy() for b in sentinel]
    buf, epoch = scratch.take(-(-keep.numel() // TILE))
    m = CompactModel(keep.numpy(), words, table, params, cap, buf_cap, g_cap,
                     count0, overflow0, 5, model_bufs, buf, scratch.tiles,
                     epoch).run(rng)
    assert len(m.count_writers) == 1 and len(m.overflow_writers) == 1
    assert int(_scratch_views(buf, scratch.tiles)[0][0]) == 0  # ticket reset
    plain_bufs = tuple(torch.from_numpy(b.copy()) for b in sentinel)
    c, o = compact_append_plain(
        keep, torch.from_numpy(words.view(np.int32)),
        torch.from_numpy(table), plain_bufs,
        torch.tensor(count0, dtype=torch.int32),
        torch.tensor(overflow0), 5, StreamHasher(params),
        aligned_halo(params), cap, buf_cap, g_cap)
    assert (m.out_count, m.out_overflow) == (int(c), bool(o))
    start = min(count0, buf_cap - cap)
    for got, want, orig in zip(model_bufs, plain_bufs, sentinel):
        np.testing.assert_array_equal(got[:int(c)], want[:int(c)].numpy())
        # nothing outside [start, count) is written
        np.testing.assert_array_equal(got[:start], orig[:start])
        np.testing.assert_array_equal(got[int(c):], orig[int(c):])
    return m


def _flagged_before(keep, tile):
    return int((keep[:tile * TILE] != 0).sum())


CASES = ["dense", "sparse", "gcap_inside", "gcap_boundary", "gcap_total",
         "cap_cut", "near_full", "sub_tile"]


@CFGS
@pytest.mark.parametrize("block", [1024, 1040], ids=["mod32_0", "mod32_16"])
@pytest.mark.parametrize("case", CASES)
def test_compact_model_matches_plain(cfg, block, case):
    params = KssdParams(*cfg)
    nb, blk = (1, 256 + block % 32) if case == "sub_tile" else (3, block)
    keep, words, table = _compact_case(cfg, nb, blk, _kept_every(cfg),
                                       seed=blk + cfg[0])
    G = keep.numel()
    n_sel = int((keep != 0).sum())
    total = int(sum(bin(int(x) & 0xFFFFFFFF).count("1") for x in keep))
    assert (G < TILE) == (case == "sub_tile")
    assert block % 32 == 0 or G % TILE
    cap, buf_cap, count0, g_cap = 4096, 1 << 14, 100, None
    if case == "sparse" or case == "sub_tile":
        g_cap = n_sel + 3
    elif case == "gcap_inside":
        lo, hi = _flagged_before(keep, 2), _flagged_before(keep, 3)
        assert hi - lo >= 2
        g_cap = (lo + hi) // 2
        assert lo < g_cap < hi
    elif case == "gcap_boundary":
        g_cap = _flagged_before(keep, 2)
    elif case == "gcap_total":
        g_cap = n_sel
    elif case == "cap_cut":
        cap = total // 3
    elif case == "near_full":
        cap, buf_cap = 64, 1024
        count0 = buf_cap - cap + 9
    scratch = LookbackScratch("cpu")
    rng = np.random.default_rng(G + len(case))
    # a launch on a larger grid first, so that stale flags are present
    other = _compact_case(cfg, 4, 1024, 64, seed=11)
    _run_both(params, *other, 4096, 1 << 14, None, 0, scratch, rng)
    m = _run_both(params, keep, words, table, cap, buf_cap, g_cap, count0,
                  scratch, rng)
    cut = g_cap is not None and n_sel >= g_cap
    if case in ("gcap_inside", "gcap_boundary", "gcap_total"):
        # the count comes from the tile that holds the g_cap-th group
        assert cut and m.count_writers == [
            next(t for t in range(m.tiles)
                 if _flagged_before(keep, t + 1) >= g_cap)]
        assert m.out_overflow == (n_sel > g_cap)
    else:
        assert not cut and m.count_writers == [m.tiles - 1]
    assert m.overflow_writers == [m.tiles - 1]
    if case == "cap_cut" or case == "near_full":
        assert m.out_overflow


def test_compact_model_epoch_reuse():
    """Many launches on one scratch, cycling grids of 1, 7 and 24
    tiles and both modes, with epochs wrapping every 5 launches: each
    equals the plain version, and a wrap zeroes the state once."""
    params = KssdParams(*L3K10)
    cases = [_compact_case(L3K10, 1, 256, 64, seed=1),
             _compact_case(L3K10, 3, 1040, 64, seed=2),
             _compact_case(L3K10, 8, 1536, 64, seed=3)]
    scratch = LookbackScratch("cpu", epoch_limit=5)
    rng = np.random.default_rng(0)
    epochs = []
    for i in range(13):
        keep, words, table = cases[i % 3]
        g_cap = None if i % 2 else max(1, int((keep != 0).sum()) - 7)
        _run_both(params, keep, words, table, 1024, 1 << 13, g_cap, i,
                  scratch, rng, overflow0=i == 4)
        epochs.append(scratch.epoch)
    assert scratch.tiles == 24
    assert epochs == [1, 1, 1, 2, 3, 4, 1, 2, 3, 4, 1, 2, 3]
