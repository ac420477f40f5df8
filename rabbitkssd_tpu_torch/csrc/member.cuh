// The kept-dims bitmap lookup, shared by member.cu and stream_keep.cu.
//
// The kept set {d : 0 <= shuffled_dim[d] < dim_end} is one bitmap of
// dim_size bits in 32-bit words (bit d of word d >> 5), built by
// ops/member.py:keep_tables.  At half_subk = 6 it is 2 MiB and stays
// resident in the H100's 50 MB L2, so a lookup is one random L2 read.

#pragma once

#include <cstdint>

__device__ __forceinline__ bool kssd_bitmap_hit(
    const uint32_t* __restrict__ bitmap, int32_t d, int32_t dim_size) {
  if (d < 0 || d >= dim_size) return false;
  return (__ldg(bitmap + (d >> 5)) >> (d & 31)) & 1u;
}
