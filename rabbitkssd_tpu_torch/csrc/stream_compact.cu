// The sketch stream step's compaction, hash composition and carry-buffer
// append: keep words in, survivors appended, with no host sync.
//
// Replaces, on the port's stream step, the eager group selection, rank
// scatters, gathers, compose and the four buffer writes of the JAX
// _stream_step_body (rabbitkssd_tpu/engine/sketcher.py:218-320, rank
// scatter at :282-299), which were ~120 torch ops a batch in the port's
// eager step.  Same results:
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
// Bound on the H100: bytes, and few of them: the keep words (256 KB a
// batch of 2.1M windows) plus ~36 bytes a survivor (~500 a batch at
// L3K10, ~8k at L2K8), 0.08 us at 3.35 TB/s.  What sets its time is
// latency: the launch, the chain of prefixes between tiles, and each
// survivor's dependent loads (three word-row words, then its table rank).
//
// Design: one pass over a grid of tiles.  A tile is 256 threads with
// four keep words each (one 16-byte load a thread, coalesced), 1024
// words: 64 tiles, one wave, at the main path's 65,536 words.  A tile
//   1. scans (block scan) its flagged-group and survivor counts;
//   2. takes its exclusive prefix (Gp, Sp) over the earlier tiles by
//      decoupled look-back: tile ids come from an atomic ticket, so a
//      tile only waits on tiles that already run; each tile publishes
//      its aggregate, then its inclusive prefix, as a 64-bit value
//      (survivors << 32 | groups) written before a release-stored flag
//      (epoch << 2 | state); warp 0 reads 32 predecessors' flags at a
//      time with acquire loads and sums back to the nearest prefix;
//   3. ranks: in sparse mode a tile with Gp >= g_cap writes nothing;
//      otherwise every earlier group ranks below g_cap, so the uncapped
//      Sp is exact, and only the tile that holds the cut (Gp < g_cap <=
//      Gp + its groups) scans its capped survivor counts again;
//   4. writes its survivors in order while their rank is below cap,
//      each recomputed from the word rows (stream_hash.cuh), its rank
//      from `table`, its reduced hash composed as in sketch.cpp:524.
// One writer each for the outputs: the last tile writes overflow, and
// count unless the group cut happened; then the cut tile writes count.
// The flags carry a per-launch epoch from the wrapper, so no launch
// clears the scratch; the last tile resets the ticket.
//
// Occupancy (nvcc -Xptxas -v, sm_90a): 32 registers, 8 bytes of stack
// (one spilled 64-bit value), 80 bytes of static shared memory; 64
// blocks of 256 threads at the main path's shape, so one wave on 64 SMs.
//
// Plain C interface for ctypes; launches on the caller's stream, does not
// synchronise and allocates nothing.  Returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "stream_hash.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWordsPerThread = 4;  // one 16-byte load
constexpr int kTileWords = kThreads * kWordsPerThread;
constexpr unsigned kAggregate = 1u;
constexpr unsigned kPrefix = 2u;

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ uint64_t ld_relaxed(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// exclusive prefix sum of v over the block; *total gets the block's sum
__device__ __forceinline__ uint64_t block_exclusive_scan(
    uint64_t v, uint64_t* total, uint64_t* warp_sums) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint64_t x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint64_t y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  uint64_t before = 0, sum = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) before += warp_sums[w];
    sum += warp_sums[w];
  }
  *total = sum;
  __syncthreads();  // warp_sums is reused by the next scan
  return before + x - v;
}

// warp 0: the sum of the tile's predecessors' (survivors << 32 | groups)
// by decoupled look-back
__device__ uint64_t look_back(int tile, unsigned epoch,
                              const unsigned* flags, const uint64_t* agg,
                              const uint64_t* inc) {
  const int lane = threadIdx.x & 31;
  uint64_t excl = 0;
  for (int last = tile - 1; last >= 0; last -= 32) {
    const int j = last - lane;  // lane 0 reads the nearest tile
    unsigned state = 0;
    uint64_t v = 0;
    if (j >= 0) {
      unsigned f;
      do {
        f = ld_acquire(flags + j);
      } while ((f >> 2) != epoch);
      state = f & 3u;
      v = ld_relaxed(state == kPrefix ? inc + j : agg + j);
    }
    const unsigned prefix = __ballot_sync(0xffffffffu, state == kPrefix);
    // sum up to and including the nearest prefix in this window
    if (prefix && lane > __ffs(prefix) - 1) v = 0;
#pragma unroll
    for (int d = 16; d; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
    excl += v;
    if (prefix) break;
  }
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
    int buf_cap, unsigned* ticket, uint64_t* agg, uint64_t* inc,
    unsigned* flags, unsigned epoch) {
  __shared__ uint64_t warp_sums[kWarps];
  __shared__ int s_tile;
  __shared__ uint64_t s_excl;
  const int t = threadIdx.x;
  if (t == 0) s_tile = (int)atomicAdd(ticket, 1u);
  __syncthreads();
  const int tile = s_tile;
  const int tiles = (int)((G + kTileWords - 1) / kTileWords);

  // 1. this thread's four keep words, its flagged groups and survivors
  const long long g0 = (long long)tile * kTileWords + t * kWordsPerThread;
  uint32_t w[kWordsPerThread];
  if (g0 + kWordsPerThread <= G &&
      (reinterpret_cast<uintptr_t>(keep) & 15u) == 0) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(keep + g0));
    w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
  } else {
#pragma unroll
    for (int i = 0; i < kWordsPerThread; ++i)
      w[i] = g0 + i < G ? __ldg(keep + g0 + i) : 0u;
  }
  uint32_t flagged = 0, surv = 0;
#pragma unroll
  for (int i = 0; i < kWordsPerThread; ++i) {
    flagged += w[i] != 0u;
    surv += __popc(w[i]);
  }
  uint64_t tile_sum;
  const uint64_t mine =
      block_exclusive_scan(((uint64_t)surv << 32) | flagged, &tile_sum,
                           warp_sums);

  // 2. the tile's exclusive prefix over the earlier tiles
  if (tile == 0) {
    if (t == 0) {
      s_excl = 0;
      st_relaxed(inc, tile_sum);
      st_release(flags, (epoch << 2) | kPrefix);
    }
  } else {
    if (t == 0) {
      st_relaxed(agg + tile, tile_sum);
      st_release(flags + tile, (epoch << 2) | kAggregate);
    }
    if (t < 32) {
      const uint64_t excl = look_back(tile, epoch, flags, agg, inc);
      if (t == 0) {
        s_excl = excl;
        st_relaxed(inc + tile, excl + tile_sum);
        st_release(flags + tile, (epoch << 2) | kPrefix);
      }
    }
  }
  __syncthreads();
  const uint64_t excl = s_excl;
  const long long Gp = (long long)(uint32_t)excl;
  const long long Sp = (long long)(excl >> 32);
  const long long Gt = (long long)(uint32_t)tile_sum;
  const long long St = (long long)(tile_sum >> 32);

  // 3. ranks: the groups of this tile that count, and this thread's
  // first survivor rank
  const int c = *count;
  const int start = min(c, buf_cap - cap);
  const bool cut_tile = sparse && Gp < g_cap && g_cap <= Gp + Gt;
  long long grank = Gp + (long long)(uint32_t)mine;  // first group's rank
  long long r = Sp + (long long)(mine >> 32);
  long long counted = St;  // this tile's counted survivors
  if (cut_tile && Gp + Gt > g_cap) {  // uniform over the block
    uint32_t mine_c = 0;
    long long gr = grank;
#pragma unroll
    for (int i = 0; i < kWordsPerThread; ++i) {
      if (w[i] && gr < g_cap) mine_c += __popc(w[i]);
      gr += w[i] != 0u;
    }
    uint64_t tile_c;
    r = Sp + (long long)block_exclusive_scan(mine_c, &tile_c, warp_sums);
    counted = (long long)tile_c;
  }
  if (t == 0) {
    if (cut_tile) *out_count = start + (int)min(Sp + counted, (long long)cap);
    if (tile == tiles - 1) {
      const long long n_sel = Gp + Gt;
      const long long total = Sp + St;  // uncapped: exact unless the cut
      *out_overflow = (uint8_t)((*overflow != 0) ||
                                (sparse && n_sel > g_cap) || total > cap ||
                                c > buf_cap - cap);
      if (!sparse || n_sel < g_cap)
        *out_count = start + (int)min(total, (long long)cap);
    }
  }
  if (tile == tiles - 1 && t == 0) atomicExch(ticket, 0u);  // next launch
  if (sparse && Gp >= g_cap) return;

  // 4. write this thread's survivors in window order
  const uint64_t outer = hoc2 > 0 ? (1ull << hoc2) - 1ull : 0ull;
#pragma unroll
  for (int i = 0; i < kWordsPerThread; ++i) {
    uint32_t x = w[i];
    if (!x) continue;
    if (sparse && grank >= g_cap) break;
    ++grank;
    for (; x && r < cap; x &= x - 1u, ++r) {
      const long long p = (g0 + i) * 32 + (__ffs(x) - 1);
      const int row = (int)(p / block);
      const int s = (int)(p - (long long)row * block) + halo - (K - 1);
      const uint32_t* wr = words + (size_t)row * nw + (s >> 4);
      const uint64_t uni = kssd_canonical(__ldg(wr), __ldg(wr + 1),
                                          __ldg(wr + 2), 2 * (s & 15), 2 * K);
      uint64_t h = (uint32_t)__ldg(table + kssd_dim_id(uni, hoc2, dim_size));
      if (hoc2 > 0) {
        h |= (uni & outer) << pf_bits;
        h |= ((uni >> (hoc2 + subk4)) & outer) << (pf_bits + hoc2);
      }
      const int slot = start + (int)r;
      buf_lo[slot] = (int32_t)(uint32_t)h;
      buf_hi[slot] = (int32_t)(uint32_t)(h >> 32);
      buf_pos[slot] = (int32_t)p;
      buf_batch[slot] = batch_idx;
    }
    if (r >= cap) break;
  }
}

}  // namespace

// keep words a tile: the wrapper sizes the scratch from it
extern "C" int kssd_stream_compact_tile_words() { return kTileWords; }

// keep: u32[G] keep words over the flattened payload; words: u32[nb, nw]
// rows; table: int32[dim_size]; buf_*: int32[buf_cap]; count: int32 and
// overflow: bool device scalars in; out_count, out_overflow: the same,
// out.  scratch: the look-back state of >= ceil(G / tile words) tiles,
// as int64 words: [ticket][aggregate x T][inclusive x T][flag u32 x T],
// zeroed once when made; epoch in [1, 2^30), a new one each launch.
extern "C" int kssd_stream_compact(
    const void* keep, long long G, int sparse, int g_cap, const void* words,
    int nw, int halo, int K, int hoc2, int subk4, int pf_bits,
    int32_t dim_size, const void* table, void* buf_lo, void* buf_hi,
    void* buf_pos, void* buf_batch, const void* count, const void* overflow,
    void* out_count, void* out_overflow, int batch_idx, int cap,
    int buf_cap, void* scratch, long long scratch_tiles, unsigned epoch,
    void* stream) {
  const int block = 16 * (nw - 2) - halo;
  const long long tiles = (G + kTileWords - 1) / kTileWords;
  if (G <= 0 || tiles > scratch_tiles || epoch == 0 || epoch >= (1u << 30))
    return (int)cudaErrorInvalidValue;
  uint64_t* base = (uint64_t*)scratch;
  stream_compact_kernel<<<(unsigned)tiles, kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const uint32_t*)keep, G, sparse, g_cap, (const uint32_t*)words, nw,
      halo, block, K, hoc2, subk4, pf_bits, dim_size, (const int32_t*)table,
      (int32_t*)buf_lo, (int32_t*)buf_hi, (int32_t*)buf_pos,
      (int32_t*)buf_batch, (const int32_t*)count, (const uint8_t*)overflow,
      (int32_t*)out_count, (uint8_t*)out_overflow, batch_idx, cap, buf_cap,
      (unsigned*)base, base + 1, base + 1 + scratch_tiles,
      (unsigned*)(base + 1 + 2 * scratch_tiles), epoch);
  return (int)cudaGetLastError();
}
