"""Keep test: is a window's substring-space dim_id in the kept set?

Port of ``rabbitkssd_tpu/ops/pallas_member.py`` (the Pallas
``_member_kernel``).  The kept set {d : 0 <= shuffled_dim[d] < dim_end}
is carried as a bitmap of ``dim_size`` bits in int32 words (bit d of
word d >> 5); :func:`member` looks each dim_id up in it.  On a CUDA
tensor it launches the hand-written kernel in ``csrc/member.cu``, which
tests the bitmap's :func:`bitmap_summary` in shared memory before it
reads the bitmap; on a CPU tensor it runs :func:`member_plain`, the
same lookup as torch ops.  The sketch stream step does not call it:
``ops/stream.py`` fuses the same lookup (``csrc/member.cuh``, and the
same summary) into the window hash.
"""

from __future__ import annotations

import ctypes
import weakref

import numpy as np
import torch

from ._build import load_cuda_lib

_BITS = 32
# the bitmap summary that stream_keep holds in shared memory: at most
# this many bytes
SUMMARY_BYTES = 32 << 10


def bitmap_np(kept_mask: np.ndarray) -> np.ndarray:
    """bool[dim_size] kept mask -> int32[ceil(dim_size/32)] bitmap words
    (bit d of word d >> 5 set iff d is kept)."""
    m = np.asarray(kept_mask, bool)
    pad = (-m.size) % _BITS
    if pad:
        m = np.concatenate([m, np.zeros(pad, bool)])
    return np.packbits(m, bitorder="little").view("<u4").view(np.int32)


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


# summaries by bitmap tensor: id -> (data pointer, version, dim_size,
# summary tensor, shift); an entry goes with its bitmap
_SUMMARIES: dict[int, tuple] = {}


def _register(bitmap: torch.Tensor, dim_size: int, summary: torch.Tensor,
              shift: int) -> None:
    key = id(bitmap)
    if key not in _SUMMARIES:
        weakref.finalize(bitmap, _SUMMARIES.pop, key, None)
    _SUMMARIES[key] = (bitmap.data_ptr(), bitmap._version, dim_size,
                       summary, shift)


def bitmap_summary(bitmap: torch.Tensor, dim_size: int
                   ) -> tuple[torch.Tensor, int]:
    """(summary, shift) of a bitmap on its device (:func:`summary_np`):
    the one :func:`keep_tables` uploaded with it, else made from a host
    copy at first use and kept while the bitmap lives unchanged."""
    entry = _SUMMARIES.get(id(bitmap))
    if entry is None or entry[:3] != (bitmap.data_ptr(), bitmap._version,
                                      dim_size):
        summary, shift = summary_np(bitmap.cpu().numpy(), dim_size)
        _register(bitmap, dim_size,
                  torch.from_numpy(summary).to(bitmap.device), shift)
        entry = _SUMMARIES[id(bitmap)]
    return entry[3], entry[4]


def keep_tables(shuffled_dim: np.ndarray, dim_end: int, device
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The keep test's state from a shuffle permutation: (table
    int32[dim_size], bitmap int32[dim_size/32]) on ``device``.  The
    table gives survivors their permuted rank; the bitmap is the kept
    set.  The bitmap's :func:`bitmap_summary` goes up in the same copy
    (the bitmap is a view of the first words, the summary of the last,
    from a 16-byte boundary on)."""
    t = np.ascontiguousarray(shuffled_dim, dtype=np.int32)
    bm = bitmap_np((t >= 0) & (t < dim_end))
    summary, shift = summary_np(bm, t.size)
    gap = np.zeros(-bm.size % 4, np.int32)
    both = torch.from_numpy(np.concatenate([bm, gap, summary])).to(device)
    bitmap = both[: bm.size]
    _register(bitmap, t.size, both[bm.size + gap.size:], shift)
    return torch.from_numpy(t).to(device), bitmap


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


def member(dims: torch.Tensor, bitmap: torch.Tensor, dim_size: int
           ) -> torch.Tensor:
    """Keep test.  CUDA tensors launch ``kssd_member_bitmap`` (counted in
    ``member.launches``; with the bitmap's :func:`bitmap_summary`, made
    once a bitmap) or raise; CPU tensors run :func:`member_plain`.

    ``dims``: int32, contiguous, any offset; ``bitmap``: int32/uint32
    words covering ``dim_size`` bits, on the same device.  Returns bool
    of dims' shape (no launch for no dims).
    """
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
    if bitmap.dtype not in (torch.int32, torch.uint32):
        raise TypeError(f"member: bitmap must be int32/uint32, got "
                        f"{bitmap.dtype}")
    if not (dims.is_contiguous() and bitmap.is_contiguous()):
        raise ValueError("member: dims and bitmap must be contiguous")
    if not 0 < dim_size <= bitmap.numel() * _BITS or dim_size >= 1 << 31:
        raise ValueError(f"member: bitmap of {bitmap.numel()} words cannot "
                         f"cover dim_size {dim_size}")
    out = torch.empty(dims.shape, dtype=torch.bool, device=dims.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dims.device):
        summary, shift = bitmap_summary(bitmap, dim_size)
        stream = torch.cuda.current_stream(dims.device).cuda_stream
        rc = lib.kssd_member_bitmap(dims.data_ptr(), dims.numel(),
                                    bitmap.data_ptr(), dim_size,
                                    summary.data_ptr(), summary.numel(),
                                    shift, out.data_ptr(), stream)
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
