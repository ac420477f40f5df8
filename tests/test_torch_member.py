"""Port keep test (rabbitkssd_tpu_torch.ops.member) vs the JAX Pallas
lane kernel (interpret mode) and ``table[d] < dim_end``.

Exact comparison (tolerance 0): the outputs are boolean masks.  The
card-only test needs no jax, so on a machine with a GPU and no jax
``python -m pytest tests/test_torch_member.py -m cuda`` runs it alone.
"""

import numpy as np
import pytest
import torch

from rabbitkssd_tpu_torch.ops.member import (bitmap_from_lane_table,
                                             keep_tables, member,
                                             member_plain)

torch.set_num_threads(1)

# the tests/test_pallas_member.py cases; the third has R > 64 lane
# rounds; the last an odd n, given as a view 3 dims into its tensor
CASES = [(1 << 12, 600, 50_000), (1 << 16, 4096, 50_000),
         (1 << 17, 80 * 128, 32_768), (1 << 16, 4096, 4097)]


@pytest.mark.parametrize("dim_size,dim_end,n", CASES)
def test_member_matches_lane_kernel(dim_size, dim_end, n):
    pytest.importorskip("jax")
    from rabbitkssd_tpu.ops.pallas_member import lane_table_np, member_lane

    rng = np.random.default_rng(dim_size + dim_end)
    table = rng.permutation(dim_size).astype(np.int32)
    lt = lane_table_np(table, dim_end)
    o = 3 if n % 2 else 0
    base = rng.integers(0, dim_size, size=n + o).astype(np.int32)
    dims = base[o:]
    want = np.asarray(member_lane(dims, lt, interpret=True))
    np.testing.assert_array_equal(want, table[dims] < dim_end)

    t, bitmap = keep_tables(table, dim_end, "cpu")
    assert torch.equal(t, torch.from_numpy(table))
    view = torch.from_numpy(base).view(-1)[o:]
    assert view.storage_offset() == o and view.is_contiguous()
    got = member(view, bitmap, dim_size)
    assert got.dtype == torch.bool and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), want)
    # the JAX package's lane table carries the same kept set
    np.testing.assert_array_equal(bitmap_from_lane_table(lt, dim_size),
                                  bitmap.numpy())


@pytest.mark.parametrize("dim_size,dim_end", [(1 << 12, 600),
                                              (1 << 16, 4096)])
def test_member_out_of_range_dims(dim_size, dim_end):
    """Negative and >= dim_size dims are never kept (the stream step's
    pads and any stray value)."""
    rng = np.random.default_rng(7)
    table = rng.permutation(dim_size).astype(np.int32)
    _, bitmap = keep_tables(table, dim_end, "cpu")
    edge = np.array([-2, -1, dim_size, dim_size + 5, 2**31 - 1, 0,
                     dim_size - 1, -(2**31)], np.int32)
    got = member(torch.from_numpy(edge).view(2, 4), bitmap, dim_size)
    assert got.shape == (2, 4)
    want = np.zeros(edge.size, bool)
    want[5] = table[0] < dim_end
    want[6] = table[dim_size - 1] < dim_end
    np.testing.assert_array_equal(got.numpy().ravel(), want)


# (half_k, half_subk, drlevel) of the kept sets chip_smoke.py times: L3
# (4096 kept dims), L2 (65,536) and (16, 4, 1) (dim_size 2^16, summary
# at shift 0)
CARD_KEPT = [(10, 6, 3), (8, 6, 2), (16, 4, 1)]
CARD_SIZES = [1, 15, 17, 4097, 16 * ((1 << 17) + 32) + 5]


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", CARD_KEPT, ids=["L3", "L2", "16,4,1"])
def test_member_kernel_matches_plain_on_card(cfg):
    """The kernel bit-equal to member_plain at every size, dims offset
    0-3 and the edge dims, each launch counted; then 100 back-to-back
    launches on one stream."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from rabbitkssd_tpu_torch.params import KssdParams

    params = KssdParams(*cfg)
    dim_size = params.dim_size
    rng = np.random.default_rng(11 + cfg[0])
    table = rng.permutation(dim_size).astype(np.int32)
    _, bitmap = keep_tables(table, params.dim_end, "cuda")
    edge = [-(2**31), -1, dim_size, 2**31 - 1, 0, dim_size - 1]
    base = rng.integers(-4, dim_size + 4, size=CARD_SIZES[-1] + 3
                        ).astype(np.int32)
    base[:6] = base[-6:] = edge
    whole = torch.from_numpy(base).cuda()
    for n in CARD_SIZES:
        for o in range(4):
            dims = whole.view(-1)[o: o + n]
            before = member.launches
            got = member(dims, bitmap, dim_size)
            torch.cuda.synchronize()
            assert member.launches == before + 1
            want = member_plain(dims, bitmap, dim_size)
            assert torch.equal(got, want), (n, o)
            assert torch.equal(got.cpu(), torch.from_numpy(
                (table[np.clip(base[o: o + n], 0, dim_size - 1)]
                 < params.dim_end) & (base[o: o + n] >= 0)
                & (base[o: o + n] < dim_size))), (n, o)
    dims = whole[: 16 * ((1 << 17) + 32)].view(16, -1)
    want = member_plain(dims, bitmap, dim_size)
    before = member.launches
    outs = [member(dims, bitmap, dim_size) for _ in range(100)]
    torch.cuda.synchronize()
    assert member.launches == before + 100
    assert all(torch.equal(g, want) for g in outs)
