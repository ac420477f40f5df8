// The window hash of the sketch stream step, shared by stream_keep.cu and
// stream_compact.cu: the device form of ops/kmer.py:StreamHasher.
//
// A row of the stream step is u32 words of 16 bases each (base i at bits
// 2*(i%16) of word i/16), followed by 2 zero pad words.  The window of
// K = 2*half_k bases whose oldest base is at position s spans words
// s/16, s/16 + 1 and s/16 + 2; its 2K stream bits E (oldest base in the
// low bits) are one 96-to-64-bit funnel shift of them.  The reverse
// complement is ~E, the forward code the 2-bit-group reversal of E, both
// in native uint64 (torch has no u32 arithmetic; the plain version
// carries each u32 lane widened in int64).

#pragma once

#include <cstdint>

// 2K-bit window mask (K <= 32)
__device__ __forceinline__ uint64_t kssd_window_mask(int TB) {
  return TB >= 64 ? ~0ull : ((1ull << TB) - 1ull);
}

// reverse the order of the 32 2-bit groups of x: a bit reversal, then a
// swap of the two bits of each group
__device__ __forceinline__ uint64_t kssd_rev2_64(uint64_t x) {
  const uint64_t m = 0x5555555555555555ull;
  x = __brevll(x);
  return ((x & m) << 1) | ((x >> 1) & m);
}

// the 64 stream bits from bit sh (< 32) of word a on, given the next two
// words: 32 bases, the oldest in the low bits
__device__ __forceinline__ uint64_t kssd_stream_bits(uint32_t a, uint32_t b,
                                                     uint32_t c, int sh) {
  const uint64_t ab = ((uint64_t)b << 32) | a;
  return sh ? (ab >> sh) | ((uint64_t)c << (64 - sh)) : ab;
}

// canonical (min of forward and reverse complement) 2K-bit code of the
// window whose oldest base is bit sh of word a, given the next two words
__device__ __forceinline__ uint64_t kssd_canonical(uint32_t a, uint32_t b,
                                                   uint32_t c, int sh,
                                                   int TB) {
  const uint64_t m = kssd_window_mask(TB);
  const uint64_t e = kssd_stream_bits(a, b, c, sh) & m;
  const uint64_t r = ~e & m;
  const uint64_t f = kssd_rev2_64(e) >> (64 - TB);
  return f <= r ? f : r;
}

// the substring-space id: the middle 4*half_subk bits, above the low
// outer context of hoc2 bits
__device__ __forceinline__ int32_t kssd_dim_id(uint64_t uni, int hoc2,
                                               int32_t dim_size) {
  return (int32_t)((uni >> hoc2) & (uint64_t)(dim_size - 1));
}
