"""The card's published peaks and the least time the stream kernels'
work needs, counted from the cell's own input.

The peaks, the bound and the per-window and per-survivor operation
counts are a frozen copy of ``chip_smoke.py:_bound`` and its constants
(commit 251baa72153c12dfd30056862f5a431398347f0f): NVIDIA's data sheet
for one H100 SXM at its 700 W limit, HBM3 at 3.35 TB/s, and 32-bit
lane operations at half the 67 TFLOP/s of float32 (132 SMs x 128 lanes
x 1.98 GHz).  The work is re-based on the input: chip_smoke counted each
launch's padded shape (16 x 2^17 windows); here a command's work is
what its bases and its survivors need, the same whatever implements
it.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 2
# 32-bit operations a window that the keep test needs, codes rolled
# along the row: next base 2, forward update 4, reverse-complement
# update 5, canonical minimum 4, dim id 2, run-length validity 2, end
# test 1, bitmap word and bit 4, the AND of the tests 2
KEEP_OPS_PER_WINDOW = 26
# stream_compact: a keep word (32 windows: two loads, a compare, a
# popcount, two adds), and a survivor (bit scan, offsets, the window's
# hash recomputed, table index, composition, slot writes)
COMPACT_OPS_PER_WORD = 6
COMPACT_OPS_PER_SURVIVOR = 80


def bound_s(bytes_moved: float, ops: float) -> tuple[float, str]:
    """(seconds, what bounds it): the larger of bytes over the HBM rate
    and 32-bit operations over the lane rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / INT32_OPS_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def stream_keep_work(bases: int) -> tuple[float, float]:
    """(bytes, operations) of the keep test over ``bases`` windows: each
    base read once at 2 bits, one keep bit written a window."""
    return bases / 4 + bases / 8, KEEP_OPS_PER_WINDOW * bases


def stream_compact_work(bases: int, survivors: int, hash_bytes: int,
                        kmer: int) -> tuple[float, float]:
    """(bytes, operations) of compacting ``bases`` keep bits into
    ``survivors`` (hash, 32-bit position) pairs, each survivor's window
    of ``kmer`` bases read once at 2 bits a base."""
    nbytes = bases / 8 + survivors * (hash_bytes + 4 + -(-2 * kmer // 8))
    ops = (COMPACT_OPS_PER_WORD * bases / 32
           + COMPACT_OPS_PER_SURVIVOR * survivors)
    return nbytes, ops
