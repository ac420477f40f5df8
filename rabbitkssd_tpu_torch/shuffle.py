"""``.shuf`` shuffle files: deterministic permutations of the substring space.

Byte-compatible with the reference on-disk format
(reference shuffle.cpp:25-61): a 16-byte header ``{id, k, subk, drlevel}``
(4 x int32) followed by ``int32[16**subk]`` — the Fisher-Yates permutation
of ``0..16**subk-1`` shuffled first with seed 23 then with seed ``id``
(reference shuffle.cpp:50-54, 76-104), using glibc ``rand()``.  The
port's copy of ``rabbitkssd_tpu/shuffle.py``, plus the kept set: the
sketch reads only ``{d : 0 <= shuffled_dim[d] < dim_end}`` of the table
(:class:`KeptSet`), which :func:`read_shuffle_kept` takes from a file in
one pass without holding the table.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from .glibc_rand import fisher_yates, shuffle_n
from .params import KssdParams

MIN_SUBCTX_DIM_SMP_SZ = 256  # reference shuffle.h:7
# table entries that one range of read_shuffle_kept's pass reads (1 MiB,
# whole bitmap words)
KEPT_RANGE = 1 << 18


def bitmap_np(kept_mask: np.ndarray) -> np.ndarray:
    """bool[dim_size] kept mask -> int32[ceil(dim_size/32)] bitmap words
    (bit d of word d >> 5 set iff d is kept)."""
    m = np.asarray(kept_mask, bool)
    pad = (-m.size) % 32
    if pad:
        m = np.concatenate([m, np.zeros(pad, bool)])
    return np.packbits(m, bitorder="little").view("<u4").view(np.int32)


@dataclasses.dataclass(frozen=True, eq=False)
class KeptSet:
    """The kept set {d : 0 <= shuffled_dim[d] < dim_end} of a shuffle
    table, all of it that a sketch reads: ``bitmap``
    int32[ceil(dim_size/32)] (:func:`bitmap_np`), the kept ``dims``
    (int32, ascending) and their ``values`` (int32
    ``shuffled_dim[dims]``, the permuted ranks).  ``threads``: the
    threads of the native pass that read it from a file, 0 where NumPy
    made it."""

    bitmap: np.ndarray
    dims: np.ndarray
    values: np.ndarray
    dim_size: int
    dim_end: int
    threads: int = 0


def kept_set_np(shuffled_dim: np.ndarray, dim_end: int) -> KeptSet:
    """The kept set of an in-memory table."""
    t = np.asarray(shuffled_dim)
    mask = (t >= 0) & (t < dim_end)
    dims = np.flatnonzero(mask)
    return KeptSet(bitmap_np(mask), dims.astype(np.int32),
                   t[dims].astype(np.int32), t.size, dim_end)


@dataclasses.dataclass
class ShuffleFile:
    """In-memory .shuf: stat header + permutation table."""

    id: int
    k: int  # half_k
    subk: int  # half_subk
    drlevel: int
    shuffled_dim: np.ndarray  # int32[16**subk]

    @property
    def dim_size(self) -> int:
        return 1 << (4 * self.subk)


@dataclasses.dataclass(frozen=True, eq=False)
class ShuffleKept:
    """A .shuf file's header and the kept set of its table
    (:func:`read_shuffle_kept`)."""

    id: int
    k: int  # half_k
    subk: int  # half_subk
    drlevel: int
    kept: KeptSet


def generate_shuffle(half_k: int, half_subk: int, drlevel: int) -> ShuffleFile:
    """Generate the permutation exactly as write_shuffle_dim_file does

    (reference shuffle.cpp:25-61): validate, derive id, double-shuffle.
    """
    if half_k < half_subk:
        raise ValueError(
            f"half_k {half_k} should be larger than sub_k {half_subk}"
        )
    if half_subk >= 8:
        raise ValueError(f"subk {half_subk} should be smaller than 8")
    dim_after_reduction = 1 << (4 * (half_subk - drlevel))
    if dim_after_reduction < MIN_SUBCTX_DIM_SMP_SZ:
        import sys

        print(
            f"Warning: dimension after reduction {dim_after_reduction} is "
            f"smaller than the suggested minimal, which might cause loss of "
            f"robustness, -s {drlevel + 3} is suggested",
            file=sys.stderr,
        )
    sid = (half_k << 8) + (half_subk << 4) + drlevel
    arr = shuffle_n(1 << (4 * half_subk), 0)
    arr = fisher_yates(arr, sid)
    return ShuffleFile(id=sid, k=half_k, subk=half_subk, drlevel=drlevel, shuffled_dim=arr)


def write_shuffle_file(shuf: ShuffleFile, path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<4i", shuf.id, shuf.k, shuf.subk, shuf.drlevel))
        f.write(np.ascontiguousarray(shuf.shuffled_dim, dtype="<i4").tobytes())


def _read_header(f, path: str) -> tuple[int, int, int, int]:
    hdr = f.read(16)
    if len(hdr) != 16:
        raise IOError(f"truncated shuffle file header: {path}")
    return struct.unpack("<4i", hdr)


def read_shuffle_file(path: str) -> ShuffleFile:
    """Reader mirroring read_shuffle_dim (reference shuffle.cpp:8-23)."""
    with open(path, "rb") as f:
        sid, k, subk, drlevel = _read_header(f, path)
        dim_size = 1 << (4 * subk)
        data = np.frombuffer(f.read(4 * dim_size), dtype="<i4")
        if data.size != dim_size:
            raise IOError(f"truncated shuffle table in {path}")
    return ShuffleFile(id=sid, k=k, subk=subk, drlevel=drlevel, shuffled_dim=data.copy())


def read_shuffle_kept(path: str, threads: int,
                      range_entries: int = KEPT_RANGE) -> ShuffleKept:
    """The header and kept set of a .shuf file, in one pass over its
    table that never holds it whole: ``range_entries`` (a multiple of
    32) at a time, on ``threads`` threads in the native library
    (``native/src/shuffle_kept.cpp``), else by the NumPy loop over the
    same ranges.  The same errors as :func:`read_shuffle_file`, and the
    same kept set as its table's :func:`kept_set_np`."""
    from .native import shuffle_kept

    if range_entries <= 0 or range_entries % 32:
        raise ValueError(f"range_entries {range_entries}: a positive "
                         f"multiple of 32")
    with open(path, "rb") as f:
        sid, k, subk, drlevel = _read_header(f, path)
        dim_size = 1 << (4 * subk)
        dim_end = KssdParams(k, subk, drlevel).dim_end
        try:
            got = shuffle_kept(f.fileno(), 16, dim_size, dim_end, threads,
                               range_entries)
            if got is None:
                got, threads = _kept_pass_np(f, dim_size, dim_end,
                                             range_entries), 0
        except EOFError:
            raise IOError(f"truncated shuffle table in {path}") from None
    return ShuffleKept(sid, k, subk, drlevel,
                       KeptSet(*got, dim_size, dim_end, threads))


def _kept_pass_np(f, n: int, dim_end: int, range_entries: int):
    """The native pass's NumPy twin: (bitmap, dims, values) of the ``n``
    table entries that follow ``f``'s position, read a range at a time
    into one reused buffer.  Raises EOFError if the file ends first."""
    bitmap = np.empty(-(-n // 32), np.int32)
    buf = np.empty(min(range_entries, n), "<i4")
    dims, vals = [np.empty(0, np.int32)], [np.empty(0, np.int32)]
    for base in range(0, n, range_entries):
        t = buf[: min(range_entries, n - base)]
        if f.readinto(t) != t.nbytes:
            raise EOFError
        mask = (t >= 0) & (t < dim_end)
        bm = bitmap_np(mask)
        bitmap[base // 32: base // 32 + bm.size] = bm
        d = np.flatnonzero(mask)
        dims.append((d + base).astype(np.int32))
        vals.append(t[d].astype(np.int32))
    return bitmap, np.concatenate(dims), np.concatenate(vals)
