// The sketch stream step's window hash and keep test, fused: one thread
// per keep word, 32 windows to a word.
//
// Replaces, on the port's stream step, the eager window hash
// (ops/kmer.py:StreamHasher.windows, the port of the JAX
// hash_windows_stream, rabbitkssd_tpu/ops/kmer.py:252), the bitmap keep
// test member.cu (which replaced the Pallas TPU kernel _member_kernel,
// rabbitkssd_tpu/ops/pallas_member.py:78), the `ok & hit` and the
// 32-window group flags (rabbitkssd_tpu/engine/sketcher.py:192-233).  A
// batch is one launch that reads the packed words (0.5 MB) and the valid
// mask (2 MB) and writes G = ceil(nb*block/32) keep words (256 KB): no
// per-window intermediate reaches device memory.
//
// Bound on the H100: operations.  The keep test needs ~26 32-bit
// operations a window with the codes rolled along the row (counted in
// chip_smoke.py, KEEP_OPS_PER_WINDOW): 1.6 us a batch of 2.1M windows at
// 132 SMs x 128 lanes x 1.98 GHz, just above the ~5 MB the batch must
// move (1.5 us at 3.35 TB/s).  What held the first versions back was
// neither: each window probed the 2 MiB kept-set bitmap at a random
// word, 2.1M random L2 sector reads a batch, ~19 us on their own (as
// member.cu and the one-call kept_lut[d] show).
//
// Design: thread g owns keep word g of the flattened payload (windows
// p = 32g .. 32g+31, p = row*block + q), so no word is shared and the
// warp's 32 words are one coalesced store.  The thread hashes its first
// window in full (a funnel shift and a 2-bit-group reversal,
// stream_hash.cuh), then rolls the forward code (shift in the next base)
// and the reverse complement (shift out the oldest, put the next base's
// complement at bit 2K-2) one base at a time, from one 64-bit register of
// the next 31 bases: about 26 operations a window instead of ~60.  The
// K-window validity of all 32 windows is one AND of shifted copies of
// the validity bits of their 32 + K - 1 positions (log2 K steps), packed
// from five 16-byte loads of the bool mask.  Each block first copies a
// summary of the bitmap into shared memory (a bit per one or two bitmap
// words, set iff one of them is nonzero; 32 KB at half_subk = 6, built
// by ops/member.py:summary_np); a window reads the bitmap in L2 only
// where its summary bit is set (~1 % of windows at L3K10's 4096 kept
// dims, ~20 % at L2K8's 65,536).  Those probes are issued before any of
// their bits is used, so their latencies overlap.  A word that crosses a
// row break (block % 32 == 16) is two runs, the second restarted at the
// next row: no memset and no atomics.  Windows past n = nb*block (the
// last word's unused bits) and at payload coordinates >= valid_upto are
// 0.
//
// Occupancy (nvcc -Xptxas -v, sm_90a): 64 registers, no spills; blocks
// of 512 threads with 32 KB of shared memory, so two blocks (32 warps,
// half the SM's) an SM by registers; 128 blocks, one wave, at the main
// path's 65,536 keep words.
//
// Plain C interface for ctypes; launches on the caller's stream, does not
// synchronise and allocates nothing.  Returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "member.cuh"
#include "stream_hash.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWin = 32;  // windows a thread: one keep word

__device__ __forceinline__ uint32_t word_at(const uint32_t* __restrict__ wrow,
                                            int i, int nw) {
  return i < nw ? __ldg(wrow + i) : 0u;
}

// four 0/1 bytes as four bits (byte i -> bit i)
__device__ __forceinline__ uint32_t pack4(uint32_t v) {
  return (((__vcmpne4(v, 0u) & 0x01010101u) * 0x01020408u) >> 24) & 0xfu;
}

// validity of row positions s .. s + 63 (bit i = position s + i; positions
// >= L are 0).  vrow is 16-byte aligned (L % 16 == 0).
__device__ __forceinline__ uint64_t valid_bits(const uint8_t* __restrict__ vrow,
                                               int s, int L) {
  const int c0 = s >> 4;
  uint64_t lo = 0;
  uint32_t hi = 0;
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    uint32_t bits = 0;
    if ((c0 + c) * 16 < L) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(vrow) + c0 + c);
      bits = pack4(x.x) | pack4(x.y) << 4 | pack4(x.z) << 8 |
             pack4(x.w) << 12;
    }
    if (c < 4) lo |= (uint64_t)bits << (16 * c); else hi = bits;
  }
  const int sh = s & 15;
  return sh ? (lo >> sh) | ((uint64_t)hi << (64 - sh)) : lo;
}

// bit j set where bits j .. j + K - 1 of v are all set (K <= 32)
__device__ __forceinline__ uint32_t valid_runs(uint64_t v, int K) {
  int len = 1;
  while (2 * len <= K) {
    v &= v >> len;
    len *= 2;
  }
  if (len < K) v &= v >> (K - len);
  return (uint32_t)v;
}

// keep bits of the nwin (1..32) windows of one row from payload offset q
// on (window q ends at row position q + halo), bit j for window q + j;
// summary: the bitmap's summary in shared memory, a bit for each run of
// 2^sum_shift bitmap words, set iff any of them is nonzero
__device__ __forceinline__ uint32_t keep_run(
    const uint32_t* __restrict__ wrow, int nw,
    const uint8_t* __restrict__ vrow, int L, int q, int nwin, int halo,
    int K, int hoc2, const uint32_t* __restrict__ bitmap,
    int32_t dim_size, const uint32_t* summary, int sum_shift) {
  const int s = q + halo - (K - 1);  // oldest base of window 0
  const int TB = 2 * K;
  const uint64_t m = kssd_window_mask(TB);
  const int a = s >> 4;
  const uint64_t e =
      kssd_stream_bits(word_at(wrow, a, nw), word_at(wrow, a + 1, nw),
                       word_at(wrow, a + 2, nw), 2 * (s & 15)) & m;
  uint64_t f = kssd_rev2_64(e) >> (64 - TB);  // newest base low
  uint64_t r = ~e & m;                        // newest base's complement high
  // the newest bases of windows 1 .. 31, from position s + K on
  const int t = s + K;
  const int b = t >> 4;
  const uint64_t next =
      kssd_stream_bits(word_at(wrow, b, nw), word_at(wrow, b + 1, nw),
                       word_at(wrow, b + 2, nw), 2 * (t & 15));
  // a base's complement enters r at bit 2K - 2, in its low or high word
  const int top = TB - 2;
  const uint32_t ins_sh = top & 31;
  const uint32_t lo_mask = top < 32 ? ~0u : 0u;

  int32_t dim[kWin];
#pragma unroll
  for (int j = 0; j < kWin; ++j) {
    if (j > 0) {
      const uint32_t base = (uint32_t)(next >> (2 * (j - 1))) & 3u;
      f = ((f << 2) | base) & m;
      const uint32_t ins = (base ^ 3u) << ins_sh;
      r = (r >> 2) | ((uint64_t)(ins & ~lo_mask) << 32) | (ins & lo_mask);
    }
    dim[j] = kssd_dim_id(f <= r ? f : r, hoc2, dim_size);
  }
  // every probe in flight before any bit is read; a dim whose summary
  // bit is 0 has a zero bitmap word, and its (predicated) load is skipped
  uint32_t word[kWin];
#pragma unroll
  for (int j = 0; j < kWin; ++j) {
    const int i = dim[j] >> (5 + sum_shift);
    word[j] = (summary[i >> 5] >> (i & 31)) & 1u
                  ? kssd_bitmap_word(bitmap, dim[j]) : 0u;
  }
  uint32_t hit = 0;
#pragma unroll
  for (int j = 0; j < kWin; ++j) hit |= kssd_bitmap_bit(word[j], dim[j]) << j;
  const uint32_t live = nwin >= kWin ? ~0u : (1u << nwin) - 1u;
  return hit & valid_runs(valid_bits(vrow, s, L), K) & live;
}

__global__ void __launch_bounds__(kThreads) stream_keep_kernel(
    const uint32_t* __restrict__ words, int nw,
    const uint8_t* __restrict__ valid, int L, int halo, int block,
    long long n, long long valid_upto, int K, int hoc2,
    const uint32_t* __restrict__ bitmap, int32_t dim_size,
    const uint32_t* __restrict__ summary, int sum_words, int sum_shift,
    uint32_t* __restrict__ out, long long G) {
  extern __shared__ uint32_t s_summary[];
  for (int i = threadIdx.x; i < sum_words; i += kThreads)
    s_summary[i] = __ldg(summary + i);
  __syncthreads();
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= G) return;
  const long long p0 = g * kWin;
  // windows p0 .. end - 1 may be kept: none past n, and payload
  // coordinates >= valid_upto are invalid
  const long long end = min(min(p0 + kWin, n), max(valid_upto, p0));
  int row = (int)(p0 / block);
  int q = (int)(p0 - (long long)row * block);
  uint32_t bits = 0;
  for (int j = 0; p0 + j < end; ++row, q = 0) {  // a second run: next row
    const int nwin = (int)min(end - p0 - j, (long long)(block - q));
    bits |= keep_run(words + (size_t)row * nw, nw, valid + (size_t)row * L,
                     L, q, nwin, halo, K, hoc2, bitmap, dim_size, s_summary,
                     sum_shift)
            << j;
    j += nwin;
  }
  out[g] = bits;
}

}  // namespace

// words: u32[nb, nw] rows; valid: bool[>= nb * L] (row-major, L =
// 16 * (nw - 2), 16-byte aligned); bitmap: the kept set, u32[dim_size /
// 32]; summary: u32[sum_words], bit i set iff any of bitmap words [i <<
// sum_shift, (i + 1) << sum_shift) is nonzero (at most 48 KB); out:
// u32[G], G = ceil(nb * block / 32).
extern "C" int kssd_stream_keep(const void* words, int nb, int nw,
                                const void* valid, int halo,
                                long long valid_upto, int K, int hoc2,
                                const void* bitmap, int32_t dim_size,
                                const void* summary, int sum_words,
                                int sum_shift, void* out, long long G,
                                void* stream) {
  const int L = 16 * (nw - 2);
  const int block = L - halo;
  if (nb <= 0 || block <= 0) return (int)cudaGetLastError();
  if (sum_words <= 0 || sum_words > (48 << 10) / 4 ||
      (long long)sum_words * 32 << (5 + sum_shift) < dim_size)
    return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((G + kThreads - 1) / kThreads);
  stream_keep_kernel<<<grid, kThreads, sum_words * sizeof(uint32_t),
                       (cudaStream_t)stream>>>(
      (const uint32_t*)words, nw, (const uint8_t*)valid, L, halo, block,
      (long long)nb * block, valid_upto, K, hoc2, (const uint32_t*)bitmap,
      dim_size, (const uint32_t*)summary, sum_words, sum_shift,
      (uint32_t*)out, G);
  return (int)cudaGetLastError();
}
