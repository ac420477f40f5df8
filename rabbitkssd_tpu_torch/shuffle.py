"""``.shuf`` shuffle files: deterministic permutations of the substring space.

Byte-compatible with the reference on-disk format
(reference shuffle.cpp:25-61): a 16-byte header ``{id, k, subk, drlevel}``
(4 x int32) followed by ``int32[16**subk]`` — the Fisher-Yates permutation
of ``0..16**subk-1`` shuffled first with seed 23 then with seed ``id``
(reference shuffle.cpp:50-54, 76-104), using glibc ``rand()``.  The
port's copy of ``rabbitkssd_tpu/shuffle.py``.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from .glibc_rand import fisher_yates, shuffle_n

MIN_SUBCTX_DIM_SMP_SZ = 256  # reference shuffle.h:7


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


def read_shuffle_file(path: str) -> ShuffleFile:
    """Reader mirroring read_shuffle_dim (reference shuffle.cpp:8-23)."""
    with open(path, "rb") as f:
        hdr = f.read(16)
        if len(hdr) != 16:
            raise IOError(f"truncated shuffle file header: {path}")
        sid, k, subk, drlevel = struct.unpack("<4i", hdr)
        dim_size = 1 << (4 * subk)
        data = np.frombuffer(f.read(4 * dim_size), dtype="<i4")
        if data.size != dim_size:
            raise IOError(f"truncated shuffle table in {path}")
    return ShuffleFile(id=sid, k=k, subk=subk, drlevel=drlevel, shuffled_dim=data.copy())
