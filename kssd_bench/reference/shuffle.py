"""The Kssd shuffle table, worked out from its definition.

The RabbitKSSD binary writes ``.shuf`` files (shuffle.cpp:25-104): a
16-byte header ``{id, half_k, half_subk, drlevel}`` (4 x int32, id =
half_k << 8 | half_subk << 4 | drlevel), then the int32 permutation of
``0 .. 16**half_subk - 1`` that two Fisher-Yates passes make, the first
driven by glibc ``rand()`` seeded with 23, the second seeded with the
id.  Each pass runs ``for i = n-1 .. 1: j = rand() % (i + 1); swap``.

glibc's ``rand()`` (TYPE_3, stdlib/random_r.c) is the lagged additive
generator r[0] = seed (0 -> 1), r[i] = 16807 * r[i-1] mod (2^31 - 1)
for i in 1..30, r[i] = r[i-31] for i in 31..33, r[i] = r[i-31] + r[i-3]
mod 2^32 after that; the k-th output is r[344 + k] >> 1.  Outputs come
a block at a time as sums of products over the last 31 values, since
the recurrence is linear.  Plain PyTorch on the device it is given: at
half_subk 7 the table has 2^28 entries.
"""

from __future__ import annotations

import functools
import os
import struct

import numpy as np
import torch

_LAG = 31
_BLOCK = 1 << 16
_M32 = (1 << 32) - 1


@functools.lru_cache(maxsize=4)
def _block_coefficients(device: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The coefficients, mod 2^32, of the next ``_BLOCK`` values of the
    recurrence in terms of the last 31, as [_BLOCK, 31] int64 halves
    (low 16 bits, high 16 bits), so no product overflows int64."""
    m32 = np.uint64(_M32)
    rows = [np.eye(_LAG, dtype=np.uint64)[i] for i in range(_LAG)]
    for _ in range(_BLOCK):
        rows.append((rows[-31] + rows[-3]) & m32)
    coef = np.stack(rows[_LAG:]).astype(np.int64)
    return (torch.from_numpy(coef & 0xFFFF).to(device),
            torch.from_numpy(coef >> 16).to(device))


def rand_stream(seed: int, n: int, device="cpu") -> torch.Tensor:
    """The first ``n`` outputs of glibc ``rand()`` after ``srand(seed)``,
    as int64 on ``device``."""
    seed &= _M32
    r = [seed or 1]
    for _ in range(1, 31):
        r.append(16807 * r[-1] % 2147483647)
    r += r[:3]
    while len(r) < 344:
        r.append((r[-31] + r[-3]) & _M32)
    device = torch.device(device)
    state = torch.tensor(r[-_LAG:], dtype=torch.int64, device=device)
    lo16, hi16 = _block_coefficients(str(device))
    out = torch.empty(n, dtype=torch.int64, device=device)
    for lo in range(0, n, _BLOCK):
        # sum_j c_j s_j mod 2^32, c_j = lo_j + 2^16 hi_j: each product
        # is under 2^48, each sum of 31 under 2^53
        vals = ((lo16 * state).sum(1)
                + (((hi16 * state).sum(1) & 0xFFFF) << 16)) & _M32
        state = vals[-_LAG:]
        hi = min(n, lo + _BLOCK)
        out[lo:hi] = vals[: hi - lo] >> 1
    return out


def fisher_yates(values: torch.Tensor, seed: int) -> torch.Tensor:
    """glibc-rand Fisher-Yates over ``values``: a new tensor, as
    ``for i = n-1 .. 1: j = rand() % (i + 1); swap(values[i], values[j])``
    leaves it.

    The loop is sequential, so it is solved instead of run.  Position i
    is final after step i (later steps touch only smaller positions).
    Let v_i be the value at position i just before step i: the value
    that the latest earlier step writing to position i moved there,
    else the original one.  Steps run from n-1 down, so "the latest
    earlier step writing to p" is the smallest step index above the
    current one whose j is p.  Then step i leaves at i the value then at
    j_i (v of that latest writer to j_i, else the original), and
    position 0 ends with v_0.  The chain v_i = v_{w(i)} is resolved by
    pointer jumping: O(n log n) vectorised work."""
    n = values.numel()
    if n < 2:
        return values.clone()
    dev = values.device
    i64 = dict(dtype=torch.int64, device=dev)
    steps = torch.arange(1, n, **i64)
    # rand() is drawn for i = n-1 first
    js = torch.flip(rand_stream(seed, n - 1, dev)
                    % torch.arange(n, 1, -1, **i64), [0])
    key = torch.sort(js * n + steps).values  # by target, then step
    del js, steps
    tgt, stp = key // n, key % n
    del key
    same_next = torch.zeros(n - 1, dtype=torch.bool, device=dev)
    same_next[:-1] = tgt[1:] == tgt[:-1]
    # w(p): the smallest step above p that writes to p
    first = torch.ones(n - 1, dtype=torch.bool, device=dev)
    first[1:] = ~same_next[:-1]
    fi = torch.nonzero(first).flatten()
    del first
    use = torch.where(stp[fi] > tgt[fi], fi, fi + 1)
    usec = use.clamp(max=n - 2)
    ok = ((use < n - 1) & (tgt[usec] == tgt[fi])
          & (stp[usec] > tgt[fi]))
    w = torch.full((n,), -1, **i64)
    w[tgt[fi[ok]]] = stp[usec[ok]]
    del fi, use, usec, ok
    # v_i = values[root(i)], root by pointer jumping along w
    jump = torch.where(w < 0, torch.arange(n, **i64), w)
    del w
    while True:
        nxt = jump[jump]
        if torch.equal(nxt, jump):
            break
        jump = nxt
    del nxt
    v = values[jump]
    del jump
    out = torch.empty_like(values)
    out[0] = v[0]
    # step i's previous writer to j_i: the next step in its target group
    later = torch.cat([stp[1:], torch.full((1,), -1, **i64)])
    prev = torch.where(same_next, later, -1)
    del later, same_next
    out[stp] = torch.where(prev >= 0, v[prev.clamp(min=0)], values[tgt])
    return out


def shuffle_table(half_k: int, half_subk: int, drlevel: int,
                  device="cpu") -> torch.Tensor:
    """The int32 permutation of the substring space, on ``device``."""
    sid = (half_k << 8) | (half_subk << 4) | drlevel
    values = fisher_yates(torch.arange(1 << (4 * half_subk),
                                       dtype=torch.int32, device=device), 23)
    return fisher_yates(values, sid)


def shuffle_bytes(half_k: int, half_subk: int, drlevel: int,
                  device="cpu") -> bytes:
    """The ``.shuf`` file's bytes."""
    sid = (half_k << 8) | (half_subk << 4) | drlevel
    table = shuffle_table(half_k, half_subk, drlevel, device).cpu().numpy()
    return (struct.pack("<4i", sid, half_k, half_subk, drlevel)
            + table.astype("<i4").tobytes())


def cache_path(cache_dir: str, half_k: int, half_subk: int,
               drlevel: int) -> str:
    return os.path.join(cache_dir, f"L{drlevel}K{half_k}S{half_subk}.shuf")


def cached_shuffle(cache_dir: str, half_k: int, half_subk: int,
                   drlevel: int, device="cpu") -> str:
    """Path of the ``.shuf`` file in ``cache_dir``, written on first use
    (it depends on the three sizes alone)."""
    path = cache_path(cache_dir, half_k, half_subk, drlevel)
    if not os.path.exists(path):
        os.makedirs(cache_dir, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            f.write(shuffle_bytes(half_k, half_subk, drlevel, device))
        os.replace(tmp, path)
    return path


def read_table(path: str) -> np.ndarray:
    """The permutation held in a ``.shuf`` file."""
    with open(path, "rb") as f:
        struct.unpack("<4i", f.read(16))
        return np.frombuffer(f.read(), "<i4").astype(np.int32)
