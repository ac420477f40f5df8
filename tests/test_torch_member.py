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

# the tests/test_pallas_member.py cases; the last has R > 64 lane rounds
CASES = [(1 << 12, 600, 50_000), (1 << 16, 4096, 50_000),
         (1 << 17, 80 * 128, 32_768)]


@pytest.mark.parametrize("dim_size,dim_end,n", CASES)
def test_member_matches_lane_kernel(dim_size, dim_end, n):
    pytest.importorskip("jax")
    from rabbitkssd_tpu.ops.pallas_member import lane_table_np, member_lane

    rng = np.random.default_rng(dim_size + dim_end)
    table = rng.permutation(dim_size).astype(np.int32)
    lt = lane_table_np(table, dim_end)
    dims = rng.integers(0, dim_size, size=n).astype(np.int32)
    want = np.asarray(member_lane(dims, lt, interpret=True))
    np.testing.assert_array_equal(want, table[dims] < dim_end)

    t, bitmap = keep_tables(table, dim_end, "cpu")
    assert torch.equal(t, torch.from_numpy(table))
    got = member(torch.from_numpy(dims), bitmap, dim_size)
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


@pytest.mark.cuda
def test_member_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rng = np.random.default_rng(11)
    dim_size, dim_end = 1 << 24, 4096
    table = rng.permutation(dim_size).astype(np.int32)
    _, bitmap = keep_tables(table, dim_end, "cuda")
    d = rng.integers(-4, dim_size + 4, size=(16, (1 << 17) + 32)
                     ).astype(np.int32)
    dims = torch.from_numpy(d).cuda()
    before = member.launches
    got = member(dims, bitmap, dim_size)
    torch.cuda.synchronize()
    assert member.launches == before + 1
    assert torch.equal(got, member_plain(dims, bitmap, dim_size))
