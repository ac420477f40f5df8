// The sketch stream step's window hash and keep test, fused: one thread per
// window, one keep bit per window, 32 windows to a word.
//
// Replaces, on the port's stream step, the eager window hash
// (ops/kmer.py:StreamHasher.windows, the port of the JAX
// hash_windows_stream), the bitmap keep test member.cu (which replaced the
// Pallas TPU kernel _member_kernel, rabbitkssd_tpu/ops/pallas_member.py:78),
// the `ok & hit` and the 32-window group flags
// (rabbitkssd_tpu/engine/sketcher.py:192-233).  The TPU step kept them
// apart because it was bound elsewhere; on the H100 the eager version was
// ~60 int64 torch ops a batch, each a pass over 16 MB, dispatched from the
// host at 6.4 ms a batch.  Here a batch is one launch that reads the
// packed words (0.5 MB) and the valid mask (2 MB) once and writes
// G = nb*block/32 keep words (256 KB): no per-window intermediate reaches
// device memory.
//
// Work: a block of 256 threads takes 256 consecutive windows of one row.
// It stages the words they span (cp.async) and the validity of their
// positions and of the 32 before (one __ballot_sync per 32 positions)
// in shared memory.  Each thread then computes its window's canonical
// code in native uint64 (stream_hash.cuh), its dim_id, the K-window
// all-valid test (a funnel shift of the validity bits, replacing the
// eager cumsum), the `payload coordinate < valid_upto` test and the
// bitmap bit (member.cuh), and a warp packs its 32 keep bits with
// __ballot_sync.  Keep words are over the flattened payload
// (p = row*block + q): where block % 32 == 0 a warp's 32 windows are one
// word, stored as is; otherwise a word straddles two warps (or two rows)
// and each warp ORs its bits in atomically into words zeroed first.
//
// Bound: ~26 32-bit operations a window are what the keep test needs
// (forward and reverse-complement codes rolled along the row; counted in
// chip_smoke.py, KEEP_OPS_PER_WINDOW): 1.6 us a batch of 2.1M windows at
// 132 SMs x 128 lanes x 1.98 GHz, just above the ~5 MB the batch must
// move (1.5 us at 3.35 TB/s).  A thread that hashes its window alone
// cannot roll the codes, so it spends about twice that count on the
// funnel shift and the 64-bit 2-bit-group reversal.
//
// Plain C interface for ctypes; launches on the caller's stream, does not
// synchronise and allocates nothing.  Returns the first CUDA error.

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "member.cuh"
#include "stream_hash.cuh"

namespace {

constexpr int kThreads = 256;
// words the block's windows span: oldest bases over kThreads positions,
// plus the two words after the last one's
constexpr int kWords = kThreads / 16 + 4;
// validity bits of the 32 positions before the first window end and of
// the kThreads window ends, plus one zero word the funnel shift may read
constexpr int kValidWords = kThreads / 32 + 2;

__global__ void __launch_bounds__(kThreads) stream_keep_kernel(
    const uint32_t* __restrict__ words, int nw,
    const uint8_t* __restrict__ valid, int L, int halo, int block,
    long long valid_upto, int K, int hoc2,
    const uint32_t* __restrict__ bitmap, int32_t dim_size,
    uint32_t* __restrict__ out, long long G, int aligned) {
  __shared__ uint32_t sw[kWords];
  __shared__ uint32_t vb[kValidWords];
  const int t = threadIdx.x;
  const int row = blockIdx.y;
  const int q0 = blockIdx.x * kThreads;  // first payload offset in the row
  const uint32_t* wrow = words + (size_t)row * nw;
  const uint8_t* vrow = valid + (size_t)row * L;

  // the word holding the oldest base of the block's first window
  const int w0 = (q0 + halo - (K - 1)) >> 4;
  if (t < kWords) {
    if (w0 + t < nw) {
      __pipeline_memcpy_async(&sw[t], wrow + w0 + t, sizeof(uint32_t));
    } else {
      sw[t] = 0u;
    }
  }
  __pipeline_commit();

  // vb bit i = validity of row position base + i
  const int base = q0 + halo - 32;
  for (int i = t; i < kThreads + 32; i += kThreads) {
    const int pos = base + i;
    const bool v = pos >= 0 && pos < L && vrow[pos] != 0;
    const unsigned bits = __ballot_sync(0xffffffffu, v);
    if ((i & 31) == 0) vb[i >> 5] = bits;
  }
  if (t == 0) vb[kValidWords - 1] = 0u;
  __pipeline_wait_prior(0);
  __syncthreads();

  const int q = q0 + t;
  bool keep = false;
  if (q < block) {
    const int s = q + halo - (K - 1);  // oldest base of the window
    const int lw = (s >> 4) - w0;
    const uint64_t uni =
        kssd_canonical(sw[lw], sw[lw + 1], sw[lw + 2], 2 * (s & 15), 2 * K);
    // all K positions s .. s + K - 1 valid
    const int i = s - base;
    const uint32_t run = __funnelshift_r(vb[i >> 5], vb[(i >> 5) + 1], i & 31);
    const uint32_t km = K >= 32 ? 0xffffffffu : ((1u << K) - 1u);
    keep = (run & km) == km && (long long)row * block + q < valid_upto &&
           kssd_bitmap_hit(bitmap, kssd_dim_id(uni, hoc2, dim_size), dim_size);
  }

  const unsigned bits = __ballot_sync(0xffffffffu, keep);
  const int qw = q0 + (t & ~31);  // lane 0's payload offset
  if ((t & 31) == 0 && qw < block) {
    const long long p0 = (long long)row * block + qw;
    const long long w = p0 >> 5;
    if (aligned) {
      out[w] = bits;
    } else if (bits) {
      const int off = (int)(p0 & 31);
      atomicOr(out + w, bits << off);
      if (off && w + 1 < G) atomicOr(out + w + 1, bits >> (32 - off));
    }
  }
}

}  // namespace

// words: u32[nb, nw] rows; valid: bool[>= nb * L] (row-major, L =
// 16 * (nw - 2)); out: u32[G], G = ceil(nb * block / 32).
extern "C" int kssd_stream_keep(const void* words, int nb, int nw,
                                const void* valid, int halo,
                                long long valid_upto, int K, int hoc2,
                                const void* bitmap, int32_t dim_size,
                                void* out, long long G, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int L = 16 * (nw - 2);
  const int block = L - halo;
  if (nb <= 0 || block <= 0) return (int)cudaGetLastError();
  const int aligned = block % 32 == 0;
  if (!aligned) {
    const cudaError_t e = cudaMemsetAsync(out, 0, (size_t)G * 4, st);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)((block + kThreads - 1) / kThreads),
                  (unsigned)nb);
  stream_keep_kernel<<<grid, kThreads, 0, st>>>(
      (const uint32_t*)words, nw, (const uint8_t*)valid, L, halo, block,
      valid_upto, K, hoc2, (const uint32_t*)bitmap, dim_size,
      (uint32_t*)out, G, aligned);
  return (int)cudaGetLastError();
}
