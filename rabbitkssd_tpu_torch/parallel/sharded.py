"""Sharded sketching and counting over a (dp, vp) mesh of ranks.

Port of ``rabbitkssd_tpu/parallel/sharded.py`` (``make_mesh``,
``make_sharded_sketch_step``, ``make_sharded_common_step``,
``sharded_common_counts``).  There is no ``shard_map`` in torch: each
rank of the default process group *is* one shard, and the collectives
are explicit.

The sketch step is data parallel: each rank hashes its own rows of
halo'd code blocks and compacts its survivors; the per-shard results
are all-gathered.  Counting uses both mesh axes:

* **dp (data parallel)**: genome rows of both sides split across dp.
  Side 1's pair shards rotate round the dp ring (``batch_isend_irecv``
  to dp index + 1), so after ``dp`` steps every side-0 shard has met
  every side-1 shard.
* **vp (vocabulary parallel)**: the vocabulary columns of each chunk
  split across vp; each rank's partial count is ``all_reduce``'d over
  its vp group (the reference's per-thread partial counters,
  dist.cpp:143,167).

Counting is exact at any width: int8 memberships and ``torch._int_mm``
(ops/distance.py), not the JAX package's bf16 product.  Pair shards and
the final gather are host data and travel as CPU tensors (gloo); only
the vp reduction of device partials rides the device's backend.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.distributed as dist

from ..ops.distance import (_host_join_max, _join_layout, _membership,
                            _memberships, _pair_counts_host, _r32,
                            membership_budget)
from ..ops.kmer import hash_windows
from ..params import KssdParams
from .multihost import global_mesh, local_world, rank, subgroups, world


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (dp, vp) grid over the ranks of the default process group, row
    major as JAX's ``devices.reshape(dp, vp)``: rank r sits at (r // vp,
    r % vp), and each dp row is one vp group."""

    dp: int
    vp: int

    def __post_init__(self):
        if self.dp < 1 or self.vp < 1:
            raise ValueError(f"mesh ({self.dp}, {self.vp}) is empty")

    @property
    def size(self) -> int:
        return self.dp * self.vp

    @property
    def coords(self) -> tuple[int, int]:
        """This rank's (dp index, vp index)."""
        return divmod(rank(), self.vp)

    def rank_at(self, d: int, v: int) -> int:
        return d * self.vp + v

    def check_world(self) -> None:
        if self.size != world():
            raise ValueError(f"mesh ({self.dp}, {self.vp}) has {self.size} "
                             f"shards but the process group {world()} ranks")

    def vp_group(self):
        """This rank's vp group.  Collective on a mesh shape's first use
        (:func:`multihost.subgroups`): every rank of the mesh calls it
        at the same point."""
        rows = tuple(tuple(range(d * self.vp, (d + 1) * self.vp))
                     for d in range(self.dp))
        return subgroups(rows)[self.coords[0]]


def make_mesh(n: int | None = None, local: int | None = None) -> Mesh:
    """The (dp, vp) mesh over ``n`` ranks, ``local`` per node (default:
    this run's world and node).

    On one node, dp is the largest divisor of n that is <= sqrt(n) (the
    JAX package's single-process rule).  Across nodes it delegates to
    :func:`multihost.global_mesh`, so vp stays within a node."""
    n = world() if n is None else n
    local = local_world() if local is None else local
    if local < n:
        return global_mesh(n, local)
    dp = max(c for c in range(1, math.isqrt(n) + 1) if n % c == 0)
    return Mesh(dp, n // dp)


# --------------------------------------------------------------------------
# host collectives (CPU tensors, so gloo carries them)
# --------------------------------------------------------------------------

def any_rank(flag: bool) -> bool:
    """Logical OR of ``flag`` over every rank."""
    if world() == 1:
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def allgather_columns(x: np.ndarray) -> list[np.ndarray]:
    """Every rank's int64 ``[k, n_rank]`` array, in rank order (the
    column counts may differ between ranks)."""
    if world() == 1:
        return [x]
    t = torch.from_numpy(np.ascontiguousarray(x, np.int64))
    n = torch.tensor([t.shape[1]], dtype=torch.int64)
    sizes = [torch.empty_like(n) for _ in range(world())]
    dist.all_gather(sizes, n)
    sizes = [int(s) for s in sizes]
    m = max(sizes)
    if m == 0:
        return [x[:, :0]] * world()
    pad = torch.zeros((t.shape[0], m), dtype=torch.int64)
    pad[:, : t.shape[1]] = t
    parts = [torch.empty_like(pad) for _ in range(world())]
    dist.all_gather(parts, pad)
    return [p[:, :s].numpy() for p, s in zip(parts, sizes)]


# --------------------------------------------------------------------------
# sharded sketch step
# --------------------------------------------------------------------------

def make_sharded_sketch_step(params: KssdParams, mesh: Mesh, n_blocks: int,
                             block: int, cap: int):
    """Data-parallel sketch step over the ranks of ``mesh``.

    ``fn(codes, table)``: ``codes`` int8[mesh.size * n_blocks, block + K
    - 1], the same halo'd blocks on every rank (numpy or a tensor),
    ``table`` the int32[dim_size] permutation on this rank's device.
    Rank r hashes rows [r*n_blocks, (r+1)*n_blocks) on that device
    (:func:`hash_windows`), drops the K-1 halo columns and compacts its
    first ``cap`` kept windows in window order; slots past its ``total``
    repeat its last window, as the JAX step's clamped searchsorted does.
    Every rank returns the per-shard (h_lo uint32[n_shards, cap], h_hi
    uint32[n_shards, cap], pos int32[n_shards, cap], total
    int32[n_shards]) as numpy, ``pos`` relative to the shard's payload
    start: the shards travel over the gloo group (none on one rank).
    """
    hasher = hash_windows(params)
    halo = params.kmer_size - 1

    def fn(codes, table: torch.Tensor):
        mesh.check_world()
        if tuple(codes.shape) != (mesh.size * n_blocks, block + halo):
            raise ValueError(f"codes of shape {tuple(codes.shape)}, not "
                             f"({mesh.size * n_blocks}, {block + halo})")
        dev = table.device
        r = rank()
        rows = torch.as_tensor(codes[r * n_blocks: (r + 1) * n_blocks])
        rows = rows.to(dev)
        h_lo, h_hi, keep = hasher(rows, rows >= 0, table)
        h_lo = h_lo[:, halo:].reshape(-1)
        h_hi = h_hi[:, halo:].reshape(-1)
        csum = torch.cumsum(keep[:, halo:].reshape(-1), 0, dtype=torch.int32)
        targets = torch.arange(1, cap + 1, dtype=torch.int32, device=dev)
        pos = torch.searchsorted(csum, targets, side="left").clamp_(
            max=csum.numel() - 1)
        # one int64 row of the shard's four outputs, for one gather
        mine = torch.cat([h_lo[pos], h_hi[pos], pos, csum[-1:].long()]).cpu()
        parts = [mine]
        if world() > 1:
            parts = [torch.empty_like(mine) for _ in range(world())]
            dist.all_gather(parts, mine)
        out = torch.stack(parts).numpy()
        return (out[:, :cap].astype(np.uint32),
                out[:, cap:2 * cap].astype(np.uint32),
                out[:, 2 * cap:3 * cap].astype(np.int32),
                out[:, 3 * cap].astype(np.int32))

    return fn


# --------------------------------------------------------------------------
# sharded counting
# --------------------------------------------------------------------------

def split_pairs(g: np.ndarray, c: np.ndarray, dp: int, vp: int, group: int,
                width: int) -> np.ndarray:
    """One vocabulary chunk's (genome, chunk column) pairs -> int32
    ``[dp, vp, 2, cap]``.  Bucket (d, v) holds the pairs of genomes
    [d*group, (d+1)*group) and columns [v*width, (v+1)*width), both made
    local to it; cap is the largest bucket.  Pads are (0, width): a
    column outside every membership, dropped when one is built."""
    key = (g.astype(np.int64) // group) * vp + c // width
    order = np.argsort(key, kind="stable")
    key = key[order]
    counts = np.bincount(key, minlength=dp * vp)
    out = np.zeros((dp * vp, 2, max(1, int(counts.max()))), np.int32)
    out[:, 1] = width
    slot = np.arange(key.size) - np.repeat(np.cumsum(counts) - counts, counts)
    out[key, 0, slot] = g[order] % group
    out[key, 1, slot] = c[order] % width
    return out.reshape(dp, vp, 2, -1)


def _shard_membership(pairs: np.ndarray, rows: int, width: int, device
                      ) -> torch.Tensor:
    real = pairs[1] < width
    return _membership(pairs[0][real], pairs[1][real], rows, width, device)


def _pass_on(shard: torch.Tensor, to: int, frm: int) -> torch.Tensor:
    """Send ``shard`` to rank ``to`` and receive its successor from rank
    ``frm`` (one ring step)."""
    got = torch.empty_like(shard)
    ops = [dist.P2POp(dist.isend, shard, to),
           dist.P2POp(dist.irecv, got, frm)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return got


def default_chunk(device: torch.device, rows: int) -> int:
    """Vocabulary columns per rank and chunk: the widest whose
    memberships (``rows`` int8 rows in all) fit the device's budget.
    Ranks of one node that share a card share its free memory."""
    budget = membership_budget(device)
    if device.type == "cuda":
        budget //= -(-local_world() // torch.cuda.device_count())
    return budget // rows


def _ring_counts(g0, c0, g1, c1, n0: int, n1: int, n_vocab: int, mesh: Mesh,
                 device: torch.device, chunk: int | None) -> np.ndarray:
    """The dp ring with the vp reduction; the replicated [n0, n1]."""
    dp, vp = mesh.dp, mesh.vp
    me, mv = mesh.coords
    rows, n1s = -(-n0 // dp), -(-n1 // dp)  # genomes per dp shard
    r0, r1 = _r32(rows), _r32(n1s)
    if chunk is None:
        chunk = default_chunk(device, r0 + r1)
    width = max(32, min(chunk, _r32(-(-n_vocab // vp))) // 32 * 32)
    to = mesh.rank_at((me + 1) % dp, mv)
    frm = mesh.rank_at((me - 1) % dp, mv)
    group = mesh.vp_group() if vp > 1 else None
    acc = torch.zeros((rows, dp * n1s), dtype=torch.int32, device=device)
    for lo in range(0, n_vocab, vp * width):
        hi = min(n_vocab, lo + vp * width)
        s0 = slice(*np.searchsorted(c0, [lo, hi]))
        s1 = slice(*np.searchsorted(c1, [lo, hi]))
        p0 = split_pairs(g0[s0], c0[s0] - lo, dp, vp, rows, width)
        p1 = split_pairs(g1[s1], c1[s1] - lo, dp, vp, n1s, width)
        m0 = _shard_membership(p0[me, mv], r0, width, device)
        shard = torch.from_numpy(np.ascontiguousarray(p1[me, mv]))
        for i in range(dp):
            m1 = _shard_membership(shard.numpy(), r1, width, device)
            part = torch._int_mm(m0, m1.t())
            if group is not None:
                dist.all_reduce(part, group=group)
            # each step passes shards to dp index + 1, so after i steps
            # this rank holds the shard that started at dp index me - i
            col0 = (me - i) % dp * n1s
            acc[:, col0 : col0 + n1s] += part[:rows, :n1s]
            if i + 1 < dp:
                shard = _pass_on(shard, to, frm)
    acc = acc.cpu()
    if world() > 1:
        parts = [torch.empty_like(acc) for _ in range(world())]
        dist.all_gather(parts, acc)
        acc = torch.cat([parts[mesh.rank_at(d, 0)] for d in range(dp)])
    return acc.numpy()[:n0, :n1]


def sharded_common_counts(hashes0: list[np.ndarray],
                          hashes1: list[np.ndarray] | None, mesh: Mesh,
                          device, chunk: int | None = None, vocab0=None
                          ) -> np.ndarray:
    """Mesh-parallel ``ops.distance.common_counts``: every rank of the
    mesh calls it with the same sketches and gets the same exact int32
    ``[n0, n1]`` (``[n0, n0]`` all-vs-all when ``hashes1`` is None).

    Small joins, and every join on a CPU device, are counted on the host
    by every rank alone, with no collective (``KSSD_HOST_JOIN_MAX=0``
    forces the ring).  ``chunk``: vocabulary columns per rank and ring
    pass (default: from free device memory, :func:`default_chunk`).
    """
    mesh.check_world()
    device = torch.device(device)
    symmetric = hashes1 is None
    if symmetric:
        allh = (np.concatenate(hashes0) if hashes0
                else np.empty(0, np.uint64))
        vocab, counts = np.unique(allh, return_counts=True)
        vocab = vocab[counts >= 2]
        hashes1 = hashes0
    else:
        if vocab0 is None:
            vocab0 = (np.unique(np.concatenate(hashes0)) if hashes0
                      else np.empty(0))
        v1 = np.unique(np.concatenate(hashes1)) if hashes1 else np.empty(0)
        vocab = np.intersect1d(vocab0, v1)

    n0, n1 = len(hashes0), len(hashes1)
    g0, c0 = _memberships(hashes0, vocab)
    g1, c1 = (g0, c0) if symmetric else _memberships(hashes1, vocab)
    host_max = _host_join_max()
    on_cpu = device.type == "cpu"
    out = None
    if len(vocab) == 0:
        out = np.zeros((n0, n1), np.int32)
    elif host_max > 0 and (on_cpu or min(len(c0), len(c1)) * 64 <= host_max):
        layout = _join_layout(c0, c1)
        if on_cpu or layout[-1] <= host_max:
            out = _pair_counts_host(g0, c0, g1, c1, n0, n1, layout=layout)
    if out is None:
        out = _ring_counts(g0, c0, g1, c1, n0, n1, len(vocab), mesh, device,
                           chunk)
    if symmetric:
        # the >=2-genome vocab filter drops singleton self-counts
        np.fill_diagonal(out, [h.size for h in hashes0])
    return out
