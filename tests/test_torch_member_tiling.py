"""Numpy model of the keep-test kernel's work decomposition
(``csrc/member.cu``) against ``member_plain``, on the CPU.

The kernel runs only on a card; this model follows its index math step
by step so that an error in it shows here first:

* the plan from both pointers: a head of ``h`` dims (at most 15) up to
  the first dim where the dims are 16-byte aligned and the output is
  aligned to the store width ``sw`` (16, else 2, else 1 byte, whichever
  the two pointers' offsets allow), ``nv`` chunks of 16 dims (four
  16-byte loads, one ``sw``-wide store at a time), and a tail of at most
  15 dims;
* a persistent grid of at most ``sms * per_sm`` blocks of ``threads``;
  thread t of block b takes chunks ``b * threads + t`` and on by the
  grid's stride; block 0's first 32 threads take the head (t < 16) and
  the tail (t >= 16) one dim each;
* a dim probes the bitmap only where its summary bit (in shared memory,
  a bit for each run of ``2^shift`` bitmap words) is set; dims outside
  [0, dim_size) neither test the summary nor probe.

Every dim is written once, every vector access is aligned, and the
result equals ``member_plain`` exactly (tolerance 0: boolean masks), at
n in {1, 15, 17, 4097, 2,097,669}, dims views at element offsets 0-3
(``dims.view(-1)[o:]``, as ``member`` accepts them), and the L3
(L3K10), L2 (L2K8) and (16, 4, 1) kept sets.  The card's grid is 1024
threads a block on 132 SMs; a grid of 3 blocks of 64 threads makes
threads take several chunks.
"""

import numpy as np
import pytest
import torch

from rabbitkssd_tpu_torch.ops.member import (bitmap_summary, keep_tables,
                                             member_plain)
from rabbitkssd_tpu_torch.params import KssdParams

torch.set_num_threads(1)

VEC = 16  # dims a thread a chunk
KEPT_SETS = {"L3": (10, 6, 3), "L2": (8, 6, 2), "16,4,1": (16, 4, 1)}
STEP_DIMS = 16 * ((1 << 17) + 32) + 5  # chip_smoke.py phase 3 (a)
SIZES = [1, 15, 17, 4097, STEP_DIMS]
# (threads a block, SMs x resident blocks): the card's, and a small grid
GRIDS = [(1024, 132), (64, 3)]


def plan(dims_addr: int, out_addr: int, n: int) -> tuple[int, int, int]:
    """(h, sw, nv) as ``kssd_member_bitmap`` computes them: dims from
    ``h`` on are 16-byte aligned at every chunk, the output ``sw``-byte
    aligned."""
    d_a = ((16 - dims_addr % 16) % 16) // 4  # dims to 16-byte alignment
    o_a = (16 - out_addr % 16) % 16  # bytes to 16-byte alignment
    rel = (o_a - d_a) % 4
    if rel == 0:
        sw, h = 16, o_a
    elif rel == 2:
        sw, h = 2, d_a
    else:
        sw, h = 1, d_a
    h = min(h, n)
    return h, sw, (n - h) // VEC


def grid(nv: int, threads: int, max_blocks: int) -> int:
    return max(1, min(-(-nv // threads), max_blocks))


_KEPT: dict = {}


def _kept(cfg: str):
    """(dim_size, bitmap int32 words, summary u32 words, shift, dims
    base int32[STEP_DIMS + 3]) for a kept set of the real size: a
    random permutation table, dims mostly in range plus edge values."""
    if cfg not in _KEPT:
        params = KssdParams(*KEPT_SETS[cfg])
        rng = np.random.default_rng(len(_KEPT) + 40)
        table = rng.permutation(params.dim_size).astype(np.int32)
        _, bitmap = keep_tables(table, params.dim_end, "cpu")
        summary, shift = bitmap_summary(bitmap, params.dim_size)
        base = rng.integers(-3, params.dim_size + 3,
                            size=STEP_DIMS + 3).astype(np.int32)
        base[[0, 7, 100, 4000]] = [-(2**31), 2**31 - 1, params.dim_size, -1]
        _KEPT[cfg] = (params.dim_size, bitmap,
                      summary.numpy().view(np.uint32), shift, base)
    return _KEPT[cfg]


def _hits(d: np.ndarray, bm: np.ndarray, summary: np.ndarray, shift: int,
          dim_size: int) -> tuple[np.ndarray, np.ndarray]:
    """(hit, probed) of dims ``d`` as a thread computes them: the range
    test, the summary bit, the bitmap word only under a set summary bit,
    then the dim's bit."""
    inside = d.astype(np.uint32) < np.uint32(dim_size)
    i = np.where(inside, d, 0) >> (5 + shift)
    sbit = inside & (((summary[i >> 5] >> (i & 31).astype(np.uint32)) & 1)
                     != 0)
    word = np.where(sbit, bm[np.where(sbit, d, 0) >> 5], 0)
    return ((word >> (d & 31).astype(np.uint32)) & 1).astype(bool), sbit


def member_model(dims_addr: int, out_addr: int, d: np.ndarray,
                 bm: np.ndarray, summary: np.ndarray, shift: int,
                 dim_size: int, threads: int, max_blocks: int
                 ) -> tuple[np.ndarray, int]:
    """The kernel's output and its number of bitmap probes."""
    n = d.size
    out = np.zeros(n, np.uint8)
    writes = np.zeros(n, np.int64)
    probes = 0
    h, sw, nv = plan(dims_addr, out_addr, n)
    blocks = grid(nv, threads, max_blocks)
    stride = blocks * threads
    for k in range(-(-nv // stride) if nv else 0):  # grid-stride rounds
        c = np.arange(stride, dtype=np.int64) + k * stride  # b*threads + t
        c = c[c < nv]
        e0 = h + VEC * c  # a chunk's first dim
        assert not ((dims_addr + 4 * e0) % 16).any()  # four uint4 loads
        assert not ((out_addr + e0) % sw).any()  # 16 / sw stores
        idx = (e0[:, None] + np.arange(VEC)).ravel()
        hit, probed = _hits(d[idx], bm, summary, shift, dim_size)
        out[idx] = hit
        writes[idx] += 1
        probes += int(probed.sum())
    # block 0, threads 0-31: the head (t < 16), the tail (t >= 16)
    t = np.arange(32)
    tail0 = h + VEC * nv
    e = np.where(t < 16, t, tail0 + t - 16)
    e = e[np.where(t < 16, t < h, t - 16 < n - tail0)]
    hit, probed = _hits(d[e], bm, summary, shift, dim_size)
    out[e] = hit
    writes[e] += 1
    probes += int(probed.sum())
    np.testing.assert_array_equal(writes, 1)  # every dim once
    return out.astype(bool), probes


def test_plan_alignment():
    """Every pair of pointer offsets gets a plan whose chunks are
    aligned, and the widest store the offsets allow."""
    for da in range(0, 16, 4):
        for oa in range(16):
            h, sw, nv = plan(4096 + da, 8192 + oa, 1000)
            assert h < 16 and nv == (1000 - h) // VEC
            assert (4096 + da + 4 * h) % 16 == 0 and (8192 + oa + h) % sw == 0
            rel = ((4096 + da) // 4 - (8192 + oa)) % 4
            assert sw == {0: 16, 2: 2}.get(rel, 1)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("cfg", list(KEPT_SETS))
def test_member_model_matches_plain(cfg, n):
    dim_size, bitmap, summary, shift, base = _kept(cfg)
    bm = bitmap.numpy().view(np.uint32)
    want_all = member_plain(torch.from_numpy(base[: n + 3]), bitmap,
                            dim_size).numpy()
    for o in range(4):  # dims.view(-1)[o:]; the output from torch.empty
        d = base[o: o + n]
        for threads, max_blocks in GRIDS if n <= 4097 else GRIDS[:1]:
            got, probes = member_model(1 << 20 | 4 * o, 1 << 21, d, bm,
                                       summary, shift, dim_size, threads,
                                       max_blocks)
            np.testing.assert_array_equal(got, want_all[o: o + n])
        if n == STEP_DIMS:
            # the share of dims that probe the bitmap in L2: ~1.6 % at
            # L3 (4096 kept dims, a summary bit a 64 dims), ~22 % at L2;
            # (16, 4, 1) has a summary bit a bitmap word (~87 %)
            share = probes / n
            assert {"L3": 0.01 < share < 0.025, "L2": 0.18 < share < 0.26,
                    "16,4,1": 0.8 < share < 0.95}[cfg], share


def test_member_model_out_misaligned():
    """An output that is not 16-byte aligned (2- and 1-byte stores)."""
    dim_size, bitmap, summary, shift, base = _kept("16,4,1")
    bm = bitmap.numpy().view(np.uint32)
    d = base[:5000]
    want = member_plain(torch.from_numpy(d), bitmap, dim_size).numpy()
    widths = set()
    for oa in (1, 2, 7, 10):
        for da in (0, 4):
            widths.add(plan(64 + da, 128 + oa, d.size)[1])
            got, _ = member_model(64 + da, 128 + oa, d, bm, summary, shift,
                                  dim_size, 64, 3)
            np.testing.assert_array_equal(got, want)
    assert widths == {16, 2, 1}
