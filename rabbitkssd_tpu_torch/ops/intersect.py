"""Batched sorted-set intersection (port of ``rabbitkssd_tpu/ops/intersect.py``).

The reference keeps a second, index-free distance path: sort both
sketches and merge-intersect them (the AVX2 kernel of the reference's
dist.cpp:941-1050, used by the legacy
tri_dist/dist, dist.cpp:345-427, 778-893).  Here the padded sorted
sketch matrices are intersected pairwise on the torch device by batched
``torch.searchsorted``: every row of one side is binary-searched in each
row of the other, and a hit at the insertion point counts.  No
posting-list index is needed.

torch has no unsigned 64-bit search, so hashes are mapped to int64 by
``h ^ 2**63``, which keeps their order (the uint64 max pad becomes int64
max).  The JAX package compiles this with XLA (it is not a Pallas
kernel), so it is torch ops here.
"""

from __future__ import annotations

import numpy as np
import torch

_SENTINEL64 = np.uint64(0xFFFFFFFFFFFFFFFF)
_SIGN64 = np.uint64(1 << 63)
# bytes of each [chunk, Na * S] int64 temporary on a CPU device; on a
# card the budget is a share of free device memory
_CPU_CHUNK_BYTES = 1 << 28


def pad_sketch_matrix(hashes: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """Sorted per-genome hash arrays -> (uint64 padded matrix, sizes).

    Rows are padded with the max sentinel (keeps rows sorted; pad slots
    are excluded by the size masks, so a real max-valued hash is safe).
    """
    n = len(hashes)
    smax = max((h.size for h in hashes), default=0)
    smax = max(smax, 1)
    smax = -(-smax // 128) * 128  # lane-align
    out = np.full((n, smax), _SENTINEL64, dtype=np.uint64)
    sizes = np.zeros(n, np.int32)
    for i, h in enumerate(hashes):
        out[i, : h.size] = h.astype(np.uint64)
        sizes[i] = h.size
    return out, sizes


def _ordered_int64(rows: np.ndarray, device) -> torch.Tensor:
    """uint64 matrix -> int64 tensor on ``device`` with the same order."""
    return torch.from_numpy((rows ^ _SIGN64).view(np.int64)).to(device)


def default_chunk(device, cells_a: int) -> int:
    """Rows of the second side per searchsorted pass: the most whose
    [chunk, Na * S] int64 temporaries (about four live at once) fit an
    eighth of free device memory on a card, 256 MB on a CPU device."""
    device = torch.device(device)
    budget = (torch.cuda.mem_get_info(device)[0] // 8
              if device.type == "cuda" else _CPU_CHUNK_BYTES)
    return max(1, budget // (8 * cells_a))


def _pair_common(rows_a: torch.Tensor, sizes_a: torch.Tensor,
                 rows_b: torch.Tensor, sizes_b: torch.Tensor,
                 chunk: int) -> torch.Tensor:
    """common[i, j] = |rows_a[i] ∩ rows_b[j]| via batched searchsorted.

    rows_*: int64 sorted padded [Na, S] / [Nb, S] on one device; sizes_*
    int64 [Na] / [Nb].  Each element of a is searched in every row of b,
    ``chunk`` rows of b at a time.  Pad slots are excluded on BOTH sides
    by index masks (the max pad can equal a real hash of 2^64 - 1).
    Returns int32 [Na, Nb] on the rows' device.
    """
    na, s = rows_a.shape
    nb = rows_b.shape[0]
    dev = rows_a.device
    out = torch.empty((na, nb), dtype=torch.int32, device=dev)
    lane = torch.arange(s, device=dev)
    a_ok = (lane[None, :] < sizes_a[:, None]).reshape(1, na * s)
    a_flat = rows_a.reshape(1, na * s)
    for j0 in range(0, nb, chunk):
        j1 = min(nb, j0 + chunk)
        b = rows_b[j0:j1]
        vals = a_flat.expand(j1 - j0, na * s).contiguous()
        idx = torch.searchsorted(b, vals, side="left")
        in_b = idx < sizes_b[j0:j1, None]
        hit = torch.gather(b, 1, idx.clamp_(max=s - 1)) == vals
        del vals, idx
        hit &= in_b
        hit &= a_ok
        out[:, j0:j1] = hit.view(j1 - j0, na, s).sum(-1, dtype=torch.int32).T
    return out


def common_counts_sorted(hashes0: list[np.ndarray],
                         hashes1: list[np.ndarray] | None, device,
                         chunk: int | None = None) -> np.ndarray:
    """Pairwise intersection counts by direct sorted-set intersection.

    hashes*: per-genome sorted unique hash arrays (``hashes1`` None: all
    against all of ``hashes0``).  ``chunk``: rows of the second side per
    searchsorted pass (default: :func:`default_chunk`).  Returns int32
    [n0, n1].
    """
    device = torch.device(device)
    if hashes1 is None:
        hashes1 = hashes0
    a, sizes_a = pad_sketch_matrix(hashes0)
    b, sizes_b = pad_sketch_matrix(hashes1)
    smax = max(a.shape[1], b.shape[1])
    if a.shape[1] < smax:
        pad = np.full((a.shape[0], smax - a.shape[1]), _SENTINEL64, np.uint64)
        a = np.concatenate([a, pad], axis=1)
    if b.shape[1] < smax:
        pad = np.full((b.shape[0], smax - b.shape[1]), _SENTINEL64, np.uint64)
        b = np.concatenate([b, pad], axis=1)
    if a.shape[0] == 0 or b.shape[0] == 0:
        return np.zeros((a.shape[0], b.shape[0]), np.int32)
    out = _pair_common(_ordered_int64(a, device),
                       torch.from_numpy(sizes_a.astype(np.int64)).to(device),
                       _ordered_int64(b, device),
                       torch.from_numpy(sizes_b.astype(np.int64)).to(device),
                       chunk or default_chunk(device, a.size))
    return out.cpu().numpy()
