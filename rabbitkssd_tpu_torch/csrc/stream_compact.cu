// The sketch stream step's compaction, hash composition and carry-buffer
// append: keep words in, survivors appended, with no host sync.
//
// Replaces, on the port's stream step, the eager group selection, rank
// scatters, gathers, compose and the four buffer writes of the JAX
// _stream_step_body (rabbitkssd_tpu/engine/sketcher.py:218-320), which
// were ~120 torch ops a batch in the port's eager step.  Same results:
//   * sparse mode (drlevel >= 3): the 32-window groups with any survivor
//     are ranked in window order; only the first g_cap count, and
//     overflow is set if more were flagged;
//   * dense mode: every group counts;
//   * survivors keep ascending window order; survivor r (r < cap) lands
//     at slot start + r of the carry buffers, start = min(count,
//     buf_cap - cap), with its reduced hash (lo, hi), its payload
//     position and the batch index;
//   * new count = start + min(total, cap); overflow |= (flagged groups >
//     g_cap) | (total > cap) | (count > buf_cap - cap).
// Slots from the new count on are not written (the host reads
// buf[:count] only).
//
// Work: one block of 1024 threads.  Each thread owns a contiguous run of
// ceil(G / 1024) keep words; a block scan of its flagged-group counts
// ranks the groups, a second block scan of its counted survivors gives
// its first survivor's rank, and it then walks its words in order and
// writes each survivor, recomputing the survivor's canonical code from
// the word rows (stream_hash.cuh, O(1) a survivor), its rank from
// `table` and its reduced hash (sketch.cpp:524 composition).
//
// Bound: bytes, and few of them: the keep words (256 KB a batch of 2.1M
// windows) plus ~36 bytes a survivor (~500 a batch at L3K10, ~8k at
// L2K8).  One block cannot fill the card, so launch latency and the
// single SM's read rate set its time.
//
// Plain C interface for ctypes; launches on the caller's stream, does not
// synchronise and allocates nothing.  Returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "stream_hash.cuh"

namespace {

constexpr int kThreads = 1024;

// exclusive prefix sum of v over the block; *total gets the block's sum
__device__ int block_exclusive_scan(int v, int* total, int* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane];
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  const int excl = x - v + (warp ? warp_sums[warp - 1] : 0);
  *total = warp_sums[31];
  __syncthreads();  // warp_sums is reused by the next scan
  return excl;
}

__global__ void __launch_bounds__(kThreads) stream_compact_kernel(
    const uint32_t* __restrict__ keep, long long G, int sparse, int g_cap,
    const uint32_t* __restrict__ words, int nw, int halo, int block, int K,
    int hoc2, int subk4, int pf_bits, int32_t dim_size,
    const int32_t* __restrict__ table, int32_t* __restrict__ buf_lo,
    int32_t* __restrict__ buf_hi, int32_t* __restrict__ buf_pos,
    int32_t* __restrict__ buf_batch, const int32_t* __restrict__ count,
    const uint8_t* __restrict__ overflow, int32_t* __restrict__ out_count,
    uint8_t* __restrict__ out_overflow, int batch_idx, int cap,
    int buf_cap) {
  __shared__ int warp_sums[32];
  const long long chunk = (G + kThreads - 1) / kThreads;
  const long long g0 = min(G, (long long)threadIdx.x * chunk);
  const long long g1 = min(G, g0 + chunk);

  int flagged = 0;
  for (long long g = g0; g < g1; ++g) flagged += keep[g] != 0u;
  int n_sel;
  const int gbase = block_exclusive_scan(flagged, &n_sel, warp_sums);

  // survivors this thread counts: in sparse mode those of groups ranked
  // below g_cap only
  int mine = 0;
  int grank = gbase;
  for (long long g = g0; g < g1; ++g) {
    const uint32_t w = keep[g];
    if (!w) continue;
    if (sparse && grank >= g_cap) break;
    mine += __popc(w);
    ++grank;
  }
  int total;
  const int sbase = block_exclusive_scan(mine, &total, warp_sums);

  const int c = *count;
  const int start = min(c, buf_cap - cap);
  if (threadIdx.x == 0) {
    *out_count = start + min(total, cap);
    *out_overflow = (uint8_t)((*overflow != 0) || (sparse && n_sel > g_cap) ||
                              total > cap || c > buf_cap - cap);
  }

  const uint64_t outer = hoc2 > 0 ? (1ull << hoc2) - 1ull : 0ull;
  int r = sbase;
  grank = gbase;
  for (long long g = g0; g < g1 && r < cap; ++g) {
    uint32_t w = keep[g];
    if (!w) continue;
    if (sparse && grank >= g_cap) break;
    ++grank;
    for (; w && r < cap; w &= w - 1u, ++r) {
      const long long p = g * 32 + (__ffs(w) - 1);
      const int row = (int)(p / block);
      const int s = (int)(p - (long long)row * block) + halo - (K - 1);
      const uint32_t* wr = words + (size_t)row * nw + (s >> 4);
      const uint64_t uni =
          kssd_canonical(wr[0], wr[1], wr[2], 2 * (s & 15), 2 * K);
      uint64_t h = (uint32_t)table[kssd_dim_id(uni, hoc2, dim_size)];
      if (hoc2 > 0) {
        h |= (uni & outer) << pf_bits;
        h |= ((uni >> (hoc2 + subk4)) & outer) << (pf_bits + hoc2);
      }
      const int slot = start + r;
      buf_lo[slot] = (int32_t)(uint32_t)h;
      buf_hi[slot] = (int32_t)(uint32_t)(h >> 32);
      buf_pos[slot] = (int32_t)p;
      buf_batch[slot] = batch_idx;
    }
  }
}

}  // namespace

// keep: u32[G] keep words over the flattened payload; words: u32[nb, nw]
// rows; table: int32[dim_size]; buf_*: int32[buf_cap]; count: int32 and
// overflow: bool device scalars in; out_count, out_overflow: the same,
// out.
extern "C" int kssd_stream_compact(
    const void* keep, long long G, int sparse, int g_cap, const void* words,
    int nw, int halo, int K, int hoc2, int subk4, int pf_bits,
    int32_t dim_size, const void* table, void* buf_lo, void* buf_hi,
    void* buf_pos, void* buf_batch, const void* count, const void* overflow,
    void* out_count, void* out_overflow, int batch_idx, int cap,
    int buf_cap, void* stream) {
  const int block = 16 * (nw - 2) - halo;
  stream_compact_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)keep, G, sparse, g_cap, (const uint32_t*)words, nw,
      halo, block, K, hoc2, subk4, pf_bits, dim_size, (const int32_t*)table,
      (int32_t*)buf_lo, (int32_t*)buf_hi, (int32_t*)buf_pos,
      (int32_t*)buf_batch, (const int32_t*)count, (const uint8_t*)overflow,
      (int32_t*)out_count, (uint8_t*)out_overflow, batch_idx, cap, buf_cap);
  return (int)cudaGetLastError();
}
