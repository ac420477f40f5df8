"""Keep test: is a window's substring-space dim_id in the kept set?

Port of ``rabbitkssd_tpu/ops/pallas_member.py`` (the Pallas
``_member_kernel``).  The kept set {d : 0 <= shuffled_dim[d] < dim_end}
is carried as a bitmap of ``dim_size`` bits in int32 words (bit d of
word d >> 5, ``shuffle.py:bitmap_np``); :func:`member` looks each dim_id
up in it.  On a CUDA tensor it launches the hand-written kernel in
``csrc/member.cu``, which tests the bitmap's :func:`summary_np` in
shared memory before it reads the bitmap; on a CPU tensor it runs
:func:`member_plain`, the same lookup as torch ops.  The sketch stream
step does not call it: ``ops/stream.py`` fuses the same lookup
(``csrc/member.cuh``, and the same summary) into the window hash.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..shuffle import KeptSet, bitmap_np, kept_set_np
from ..utils.timers import phase
from ._build import load_cuda_lib

_BITS = 32
# the bitmap summary that stream_keep holds in shared memory: at most
# this many bytes
SUMMARY_BYTES = 32 << 10


def summary_np(bm: np.ndarray, dim_size: int) -> tuple[np.ndarray, int]:
    """(summary int32 words, shift) of bitmap words ``bm``: bit i of the
    summary is set iff any of bitmap words [i << shift, (i + 1) << shift)
    is nonzero, with the smallest shift that fits ``SUMMARY_BYTES``.  A
    dim whose summary bit is 0 is not kept.  Zero words pad the summary
    to a multiple of 16 bytes, the unit of member.cu's bulk copy."""
    words = -(-dim_size // _BITS)
    shift = 0
    while -(-words >> shift) > 8 * SUMMARY_BYTES:
        shift += 1
    nz = np.asarray(bm[:words]) != 0
    nz = np.concatenate([nz, np.zeros(-words % (1 << shift), bool)])
    summary = bitmap_np(nz.reshape(-1, 1 << shift).any(axis=1))
    return np.concatenate([summary, np.zeros(-summary.size % 4, np.int32)]
                          ), shift


@dataclasses.dataclass(frozen=True, eq=False)
class KeepTables:
    """The keep test's state on one device, made by :func:`keep_tables`.

    ``table`` int32[dim_size] holds the permuted rank of each kept dim
    and -1 elsewhere: the kernels and the plain compaction read it at
    survivors only, and -1 fails the K-step hasher's ``0 <= pf <
    dim_end`` test as any dim outside the kept set does.  ``bitmap``
    int32[ceil(dim_size/32)] is the kept set; ``summary`` and ``shift``
    its :func:`summary_np`, which the kernels test in shared memory
    before they probe the bitmap.  ``bytes_up``: the bytes that
    :func:`keep_tables` copied to the device; ``threads``: the kept
    set's (:class:`~rabbitkssd_tpu_torch.shuffle.KeptSet`)."""

    table: torch.Tensor
    bitmap: torch.Tensor
    summary: torch.Tensor
    shift: int
    dim_size: int
    bytes_up: int = 0
    threads: int = 0

    def __post_init__(self):
        # the kernels take these tensors' pointers
        parts = (self.table, self.bitmap, self.summary)
        if not all(t.dtype == torch.int32 and t.is_contiguous()
                   and t.device == self.table.device for t in parts):
            raise ValueError("KeepTables: contiguous int32 tensors on one "
                             "device")
        if (self.table.numel() != self.dim_size
                or self.bitmap.numel() * _BITS < self.dim_size):
            raise ValueError(f"KeepTables: a table of {self.table.numel()} "
                             f"and a bitmap of {self.bitmap.numel()} words "
                             f"for dim_size {self.dim_size}")


def keep_tables(kept: KeptSet | np.ndarray, dim_end: int, device
                ) -> KeepTables:
    """The keep test's state on ``device`` from a kept set, or from a
    shuffle permutation turned into one (:func:`kept_set_np`).  The
    bitmap, its summary (from a 16-byte boundary on) and the kept dims
    and values go up in one copy; the table is filled with -1 on the
    device and the kept values scattered into it."""
    with phase("keep table build"):
        if not isinstance(kept, KeptSet):
            kept = kept_set_np(kept, dim_end)
        if kept.dim_end != dim_end:
            raise ValueError(f"keep_tables: a kept set for dim_end "
                             f"{kept.dim_end}, not {dim_end}")
        bm, n = kept.bitmap, kept.dims.size
        summary, shift = summary_np(bm, kept.dim_size)
        gap = np.zeros(-bm.size % 4, np.int32)
        host = np.concatenate([bm, gap, summary, kept.dims, kept.values])
    # the span ends with the tables on the device
    with phase("keep table upload"):
        up = torch.from_numpy(host).to(device)
        table = torch.full((kept.dim_size,), -1, dtype=torch.int32,
                           device=up.device)
        table.index_copy_(0, up[host.size - 2 * n: host.size - n].long(),
                          up[host.size - n:])
        if up.device.type == "cuda":
            torch.cuda.synchronize(up.device)
    s0 = bm.size + gap.size
    return KeepTables(table, up[: bm.size], up[s0: s0 + summary.size],
                      shift, kept.dim_size, host.nbytes, kept.threads)


def bitmap_from_lane_table(lane_tab: np.ndarray, dim_size: int
                           ) -> np.ndarray:
    """The JAX package's ``lane_table_np`` output ([R, 128], kept dims
    by lane, -1 padded) -> the port's bitmap words."""
    lt = np.asarray(lane_tab)
    kept = lt[lt >= 0].astype(np.int64)
    mask = np.zeros(dim_size, bool)
    mask[kept] = True
    return bitmap_np(mask)


def member_plain(dims: torch.Tensor, bitmap: torch.Tensor, dim_size: int
                 ) -> torch.Tensor:
    """Plain PyTorch keep test (any device): bool mask of dims' shape.
    Dims outside [0, dim_size) are never kept."""
    d = dims.to(torch.int64)
    inside = (d >= 0) & (d < dim_size)
    dc = d.clamp(0, dim_size - 1)
    word = bitmap[dc >> 5].to(torch.int64)
    return inside & (((word >> (dc & 31)) & 1) != 0)


def member(dims: torch.Tensor, tables: KeepTables) -> torch.Tensor:
    """Keep test of ``dims`` against the kept set of ``tables``
    (:func:`keep_tables`, on the dims' device).  CUDA tensors launch
    ``kssd_member_bitmap`` (counted in ``member.launches``) or raise;
    CPU tensors run :func:`member_plain`.

    ``dims``: int32, contiguous, any offset.  Returns bool of dims'
    shape (no launch for no dims).
    """
    bitmap, dim_size = tables.bitmap, tables.dim_size
    if dims.device.type == "cpu":
        if bitmap.device.type != "cpu":
            raise ValueError("dims on cpu but bitmap on " + str(bitmap.device))
        return member_plain(dims, bitmap, dim_size)
    if dims.device.type != "cuda":
        raise ValueError(f"member: unsupported device {dims.device}")
    if bitmap.device != dims.device:
        raise ValueError(f"member: bitmap on {bitmap.device}, dims on "
                         f"{dims.device}")
    if dims.dtype != torch.int32:
        raise TypeError(f"member: dims must be int32, got {dims.dtype}")
    if not dims.is_contiguous():
        raise ValueError("member: dims must be contiguous")
    if not 0 < dim_size < 1 << 31:
        raise ValueError(f"member: dim_size {dim_size} outside int32")
    out = torch.empty(dims.shape, dtype=torch.bool, device=dims.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dims.device):
        stream = torch.cuda.current_stream(dims.device).cuda_stream
        rc = lib.kssd_member_bitmap(dims.data_ptr(), dims.numel(),
                                    bitmap.data_ptr(), dim_size,
                                    tables.summary.data_ptr(),
                                    tables.summary.numel(), tables.shift,
                                    out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"kssd_member_bitmap launch failed: CUDA error "
                           f"{rc}")
    member.launches += 1
    return out


member.launches = 0


def _lib() -> ctypes.CDLL:
    lib = load_cuda_lib("member.cu")
    fn = lib.kssd_member_bitmap
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                       ctypes.c_int32, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    return lib
