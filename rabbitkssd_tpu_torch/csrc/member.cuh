// The kept-dims bitmap lookup, shared by member.cu and stream_keep.cu.
//
// The kept set {d : 0 <= shuffled_dim[d] < dim_end} is one bitmap of
// dim_size bits in 32-bit words (bit d of word d >> 5), built by
// ops/member.py:keep_tables.  At half_subk = 6 it is 2 MiB and stays
// resident in the H100's 50 MB L2, so a lookup is one random L2 read.
// stream_keep.cu issues a thread's probes (kssd_bitmap_word) before it
// tests any bit (kssd_bitmap_bit), so that their latencies overlap.

#pragma once

#include <cstdint>

// the bitmap word holding dim d, 0 <= d < dim_size
__device__ __forceinline__ uint32_t kssd_bitmap_word(
    const uint32_t* __restrict__ bitmap, int32_t d) {
  return __ldg(bitmap + (d >> 5));
}

// dim d's bit of its bitmap word
__device__ __forceinline__ uint32_t kssd_bitmap_bit(uint32_t word,
                                                    int32_t d) {
  return (word >> (d & 31)) & 1u;
}

__device__ __forceinline__ bool kssd_bitmap_hit(
    const uint32_t* __restrict__ bitmap, int32_t d, int32_t dim_size) {
  if (d < 0 || d >= dim_size) return false;
  return kssd_bitmap_bit(kssd_bitmap_word(bitmap, d), d);
}
