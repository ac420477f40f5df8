"""Exact set-intersection counting (port of ``rabbitkssd_tpu/ops/distance.py``).

Pairwise intersection sizes over N sketches are ``M0 @ M1.T`` where
``M[N, V]`` is the 0/1 membership matrix over a vocabulary of hash
values.  The device path builds int8 membership matrices per vocabulary
chunk (``index_put_`` from (genome, column) pairs) and multiplies them
with ``torch._int_mm`` (int8 x int8 -> int32): exact for any count, so
the chunk width is bounded only by device memory.  Small joins, and
every join on a CPU device, run the host posting-list walk instead (the
reference's dist.cpp:193-204 algorithm, shared native code).
"""

from __future__ import annotations

import os

import numpy as np
import torch

# host-join expansion increments per pass (numpy fallback)
_HOST_JOIN_CHUNK = 1 << 24
# membership-matrix budget on a CPU device (tests, rehearsals)
_CPU_MEM_BYTES = 1 << 28


def _memberships(hash_arrays: list[np.ndarray], vocab: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Per-genome sorted hash arrays -> (gid, col) pairs, column-major.

    Hashes absent from the vocabulary are dropped (they cannot
    intersect).  One vectorized pass over the concatenation."""
    if len(vocab) == 0 or not hash_arrays:
        return np.empty(0, np.int32), np.empty(0, np.int64)
    sizes = np.fromiter((h.size for h in hash_arrays), np.int64,
                        len(hash_arrays))
    total = int(sizes.sum())
    if total == 0:
        return np.empty(0, np.int32), np.empty(0, np.int64)
    allh = np.concatenate(hash_arrays)
    gids = np.repeat(np.arange(len(hash_arrays), dtype=np.int32), sizes)
    idx = np.minimum(np.searchsorted(vocab, allh), len(vocab) - 1)
    m = vocab[idx] == allh
    ag, ac = gids[m], idx[m].astype(np.int64)
    order = np.argsort(ac, kind="stable")  # column-major for chunk slicing
    return ag[order], ac[order]


def _host_join_max() -> int:
    """Joins of at most this many (i, j) increments are counted on the
    host, where a device launch would be pure overhead.
    ``KSSD_HOST_JOIN_MAX=0`` forces the device path (tests use it)."""
    return int(os.environ.get("KSSD_HOST_JOIN_MAX", 1 << 22))


def _join_layout(c0, c1):
    """Per-shared-column run lengths of two column-sorted pair lists.

    Returns (u, s0, k0, s1, k1, total): shared column values, each
    side's run start/length per shared column, and the join size
    sum(k0*k1) — the number of (i, j) increments a full expansion costs.
    """
    u0, s0_, k0_ = np.unique(c0, return_index=True, return_counts=True)
    u1, s1_, k1_ = np.unique(c1, return_index=True, return_counts=True)
    u, i0, i1 = np.intersect1d(u0, u1, assume_unique=True,
                               return_indices=True)
    s0, k0 = s0_[i0], k0_[i0]
    s1, k1 = s1_[i1], k1_[i1]
    return u, s0, k0, s1, k1, int(np.sum(k0 * k1, dtype=np.int64))


def _pair_counts_host(g0, c0, g1, c1, n0: int, n1: int,
                      layout=None, out=None, col_lo: int = 0) -> np.ndarray:
    """Exact host-side counting: expand the column join and accumulate
    (native posting walk; chunked numpy expansion without a toolchain).

    col_lo > 0: only count (and zero) columns >= col_lo — the
    upper-triangle alldist strips never read j < i0, so out[:, :col_lo]
    is left with stale contents the caller must not read."""
    if out is None:
        out = np.zeros((n0, n1), np.int32)
    elif col_lo > 0:
        out[:, col_lo:] = 0
    else:
        out[:] = 0
    _, s0, k0, s1, k1, total = (layout if layout is not None
                                else _join_layout(c0, c1))
    if total == 0:
        return out
    from ..native import pair_count_native

    if pair_count_native(g0, s0, k0, g1, s1, k1, out, col_lo=col_lo):
        return out
    tot = (k0 * k1).astype(np.int64)
    ends = np.cumsum(tot)
    starts = ends - tot
    chunk = _HOST_JOIN_CHUNK  # increments per pass (~400 MB temporaries)
    for lo in range(0, total, chunk):
        hi = min(total, lo + chunk)
        # columns overlapping [lo, hi) of the flattened join
        c_lo = int(np.searchsorted(ends, lo, side="right"))
        c_hi = int(np.searchsorted(starts, hi, side="left"))
        cols = np.arange(c_lo, c_hi)
        span = np.minimum(ends[cols], hi) - np.maximum(starts[cols], lo)
        col_of = np.repeat(cols, span)
        base = np.maximum(starts[cols], lo) - starts[cols]
        off0 = np.zeros(len(cols), np.int64)
        np.cumsum(span[:-1], out=off0[1:])
        within = (np.arange(hi - lo, dtype=np.int64)
                  - np.repeat(off0, span) + np.repeat(base, span))
        ii = g0[s0[col_of] + within // k1[col_of]]
        jj = g1[s1[col_of] + within % k1[col_of]]
        if col_lo > 0:
            keep = jj >= col_lo
            ii, jj = ii[keep], jj[keep]
        np.add.at(out, (ii, jj), 1)
    return out


def _r32(n: int) -> int:
    """``_int_mm`` shape rule on CUDA: pad every dim to a multiple of 32
    (covers m > 16 and k, n multiples of 8)."""
    return max(32, -(-n // 32) * 32)


def _membership(g: np.ndarray, c: np.ndarray, rows: int, width: int,
                device) -> torch.Tensor:
    m = torch.zeros((rows, width), dtype=torch.int8, device=device)
    if len(g):
        gi = torch.from_numpy(np.ascontiguousarray(g, np.int64)).to(device)
        ci = torch.from_numpy(np.ascontiguousarray(c, np.int64)).to(device)
        m.index_put_((gi, ci), torch.ones((), dtype=torch.int8,
                                          device=device))
    return m


def membership_budget(device: torch.device) -> int:
    """Bytes the int8 membership matrices of one vocabulary chunk may
    take: a quarter of the card's free memory, or a fixed budget on a
    CPU device."""
    if device.type == "cuda":
        return torch.cuda.mem_get_info(device)[0] // 4
    return _CPU_MEM_BYTES


def pair_counts(g0, c0, g1, c1, n0: int, n1: int, n_vocab: int, device,
                chunk: int | None = None, symmetric: bool = False
                ) -> np.ndarray:
    """Intersection counts from (genome, column) membership pairs.

    Pairs must be column-major sorted (ascending ``c``).  Joins small
    enough that a launch dominates, and all joins on a CPU device
    (unless ``KSSD_HOST_JOIN_MAX=0``), run on the host.  The device
    loop walks vocabulary chunks of at most ``chunk`` columns (default:
    the widest whose two membership matrices fit a quarter of free
    device memory), accumulating ``_int_mm`` products into int32.
    """
    device = torch.device(device)
    out = np.zeros((n0, n1), np.int32)
    if n_vocab == 0 or len(c0) == 0 or len(c1) == 0:
        return out
    host_max = _host_join_max()
    on_cpu = device.type == "cpu"
    if host_max > 0 and (on_cpu or min(len(c0), len(c1)) * 64 <= host_max):
        layout = _join_layout(c0, c1)
        if on_cpu or layout[-1] <= host_max:
            return _pair_counts_host(g0, c0, g1, c1, n0, n1, layout=layout)

    n0p, n1p = _r32(n0), _r32(n1)
    if chunk is None:
        chunk = membership_budget(device) // (n0p + n1p)
    width = max(32, min(chunk, _r32(n_vocab)) // 32 * 32)
    acc = torch.zeros((n0p, n1p), dtype=torch.int32, device=device)
    for lo in range(0, n_vocab, width):
        hi = min(n_vocab, lo + width)
        s0 = slice(*np.searchsorted(c0, [lo, hi]))
        m0 = _membership(g0[s0], c0[s0] - lo, n0p, width, device)
        if symmetric:
            m1 = m0
        else:
            s1 = slice(*np.searchsorted(c1, [lo, hi]))
            m1 = _membership(g1[s1], c1[s1] - lo, n1p, width, device)
        acc += torch._int_mm(m0, m1.t())
    out[:] = acc[:n0, :n1].cpu().numpy()
    return out


def common_counts(hashes0: list[np.ndarray], hashes1: list[np.ndarray] | None,
                  device, chunk: int | None = None, vocab0=None
                  ) -> np.ndarray:
    """Exact pairwise intersection-count matrix.

    hashes*: per-genome sorted unique hash arrays.  If hashes1 is None,
    computes the symmetric all-vs-all matrix of hashes0 over the
    vocabulary of hashes shared by >= 2 genomes (singletons cannot
    contribute off-diagonal, mirroring what the reference's posting lists
    count, dist.cpp:193-204).  Returns int32 [n0, n1] (or [n0, n0]).
    """
    symmetric = hashes1 is None
    if symmetric:
        allh = (np.concatenate(hashes0) if hashes0
                else np.empty(0, np.uint64))
        vocab, counts = np.unique(allh, return_counts=True)
        vocab = vocab[counts >= 2]  # sketches are deduped: count == #genomes
        hashes1 = hashes0
    else:
        # only hashes present on both sides can intersect
        if vocab0 is None:
            vocab0 = (np.unique(np.concatenate(hashes0)) if hashes0
                      else np.empty(0))
        v1 = np.unique(np.concatenate(hashes1)) if hashes1 else np.empty(0)
        vocab = np.intersect1d(vocab0, v1)

    n0, n1 = len(hashes0), len(hashes1)
    g0, c0 = _memberships(hashes0, vocab)
    if symmetric:
        g1, c1 = g0, c0
    else:
        g1, c1 = _memberships(hashes1, vocab)

    out = pair_counts(g0, c0, g1, c1, n0, n1, len(vocab), device, chunk,
                      symmetric=symmetric)
    if symmetric:
        # the >=2-genome vocab filter drops singleton self-counts; the
        # diagonal is by definition the sketch size
        np.fill_diagonal(out, [h.size for h in hashes0])
    return out
