// Kept-dims keep test as a bitmap lookup: the stand-alone keep test of
// ops/member.py.
//
// Replaces the Pallas TPU kernel `_member_kernel`
// (rabbitkssd_tpu/ops/pallas_member.py:78, launched by `_member_call`).
// It computes the same function, not the same blocks: for every dim_id d,
// whether 0 <= shuffled_dim[d] < dim_end.  The TPU kernel partitioned the
// kept set into an [R, 128] lane table because its only fast
// data-dependent load was a lane-local gather, and needed R rounds of
// gather+compare per tile.  On Hopper the kept set is one bitmap of
// dim_size bits (bit d set iff d is kept, 2 MiB at half_subk = 6, resident
// in the 50 MB L2), so one kernel serves every kept-set size.
//
// Bound on the H100: bytes.  At the stream step's shape (2,097,669 dims)
// the kernel must read 8.39 MB of dims and the 2 MiB bitmap and write 2.10
// MB of 0/1 bytes: 0.00376 ms at 3.35 TB/s.  What held the first version
// (one dim a thread, no filter) back was one random 32-byte L2 sector
// read a dim: 0.0178 ms a launch by device time.
//
// Design:
// - A summary of the bitmap in shared memory, as stream_keep.cu has it: a
//   bit for each run of 2^sum_shift bitmap words, set iff one of them is
//   nonzero (32 KB at half_subk = 6, a bit for 64 dims; built by
//   ops/member.py:summary_np and uploaded with the bitmap).  A dim probes
//   the bitmap in L2 only under a set summary bit: ~1.6 % of dims at an
//   L3 kept set (4096 kept dims), ~22 % at L2 (65,536).
// - Thread 0 of each block loads the summary with one TMA bulk copy
//   (cp.async.bulk, completion on an mbarrier) while every thread's first
//   dims loads are in flight.
// - A persistent grid of one wave (SMs x resident blocks of 1024 threads),
//   so a block loads the summary once; at the step's shape that is 129
//   blocks and one chunk a thread.
// - A chunk is 16 dims: four 16-byte loads, every summary-gated probe in
//   flight before any bit is tested, then the 16 0/1 bytes in one 16-byte
//   store.  `member` accepts any contiguous int32 view, so the dims and the
//   output may be misaligned relative to each other: the host picks a head
//   of at most 15 dims up to where the dims are 16-byte aligned, and the
//   widest store (16, 2 or 1 bytes) the output then allows; block 0's
//   first 32 threads do the head and the tail (at most 15 dims) one each.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py phase 3 (a),
// device time a launch from a torch.profiler trace, 2,097,669 dims):
// 0.0056 ms at L3, two thirds of the bound (the first version 0.0178,
// the one PyTorch call kept_lut[d] 0.021); 0.0071 ms at L2; 0.0053 ms at
// (16, 4, 1), whose 8 KB bitmap gives a 0.0031 ms bound.  Without the
// summary it takes 0.0178 ms again at L3 (the probes); with blocks of 512
// threads, so twice the summary copies, 0.0005 ms more.  One elementwise
// PyTorch kernel on the same bytes (dims != 0) takes 0.0026 ms.
//
// The sketch stream step does not call this kernel: stream_keep.cu fuses
// the same lookup (member.cuh) into the window hash.
//
// Plain C interface for ctypes; launches on the caller's stream, does not
// synchronise and allocates nothing.  Returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "member.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kVec = 16;  // dims a thread a chunk
// the summary's size for the grid's occupancy (ops/member.py:SUMMARY_BYTES)
constexpr int kSummaryBytes = 32 << 10;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// thread 0: one bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) into shared memory, completion on `bar` (phase 0)
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  const uint32_t b = smem_addr(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(b), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes),
      "r"(b) : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t phase) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(phase) : "memory");
  } while (!done);
}

// 1 iff 0 <= d < dim_size and d's summary bit is set (a 0 bit: d's bitmap
// word is 0, so d is not kept)
__device__ __forceinline__ uint32_t summary_bit(const uint32_t* s_sum,
                                                int sum_shift, int32_t d,
                                                int32_t dim_size) {
  if ((uint32_t)d >= (uint32_t)dim_size) return 0u;
  const uint32_t i = (uint32_t)d >> (5 + sum_shift);
  return (s_sum[i >> 5] >> (i & 31)) & 1u;
}

// 16 0/1 bytes (byte j = bits[j >> 2] >> 8 (j & 3)) at p, SW bytes a store
template <int SW>
__device__ __forceinline__ void store16(uint8_t* p, const uint32_t* bits) {
  if constexpr (SW == 16) {
    *reinterpret_cast<uint4*>(p) = make_uint4(bits[0], bits[1], bits[2],
                                              bits[3]);
  } else if constexpr (SW == 2) {
#pragma unroll
    for (int k = 0; k < 8; ++k)
      reinterpret_cast<uint16_t*>(p)[k] =
          (uint16_t)(bits[k >> 1] >> (16 * (k & 1)));
  } else {
#pragma unroll
    for (int k = 0; k < 16; ++k)
      p[k] = (uint8_t)(bits[k >> 2] >> (8 * (k & 3)));
  }
}

// dims [h, h + 16 nv) in chunks (dims + h 16-byte aligned, out + h
// SW-byte aligned); block 0 also does the head [0, h) and the tail
// [h + 16 nv, n)
template <int SW>
__global__ void __launch_bounds__(kThreads) member_bitmap_kernel(
    const int32_t* __restrict__ dims, long long n, long long h,
    long long nv, const uint32_t* __restrict__ bitmap, int32_t dim_size,
    const uint32_t* __restrict__ summary, uint32_t sum_bytes, int sum_shift,
    uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t s_sum[];
  __shared__ __align__(8) uint64_t bar;
  if (threadIdx.x == 0) bulk_load(s_sum, summary, sum_bytes, &bar);
  const int4* src = reinterpret_cast<const int4*>(dims + h);
  const long long stride = (long long)gridDim.x * kThreads;
  long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
  int4 v[4];
  if (c < nv) {
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = __ldg(src + 4 * c + k);
  }
  __syncthreads();  // the barrier is initialised before anyone waits on it
  bar_wait(&bar, 0);
  while (c < nv) {
    const int32_t d[kVec] = {v[0].x, v[0].y, v[0].z, v[0].w,
                             v[1].x, v[1].y, v[1].z, v[1].w,
                             v[2].x, v[2].y, v[2].z, v[2].w,
                             v[3].x, v[3].y, v[3].z, v[3].w};
    // every probe in flight before any bit is read
    uint32_t word[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      word[j] = summary_bit(s_sum, sum_shift, d[j], dim_size)
                    ? kssd_bitmap_word(bitmap, d[j]) : 0u;
    uint32_t bits[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      bits[j >> 2] |= kssd_bitmap_bit(word[j], d[j]) << (8 * (j & 3));
    store16<SW>(out + h + kVec * c, bits);
    c += stride;
    if (c < nv) {
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = __ldg(src + 4 * c + k);
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < 32) {  // head (t < 16), tail
    const int t = threadIdx.x;
    const long long tail0 = h + kVec * nv;
    const long long e = t < 16 ? t : tail0 + (t - 16);
    if (t < 16 ? t < h : e < n) {
      const int32_t x = dims[e];
      out[e] = summary_bit(s_sum, sum_shift, x, dim_size)
                   ? (uint8_t)kssd_bitmap_bit(kssd_bitmap_word(bitmap, x), x)
                   : (uint8_t)0;
    }
  }
}

template <int SW>
int launch(const int32_t* dims, long long n, long long h, long long nv,
           const uint32_t* bitmap, int32_t dim_size, const uint32_t* summary,
           uint32_t sum_bytes, int sum_shift, uint8_t* out,
           cudaStream_t stream) {
  // one wave: SMs x resident blocks, found once a device
  static int max_blocks[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (max_blocks[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, member_bitmap_kernel<SW>, kThreads, kSummaryBytes);
    if (err != cudaSuccess) return (int)err;
    max_blocks[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  long long blocks = (nv + kThreads - 1) / kThreads;
  if (blocks > max_blocks[dev]) blocks = max_blocks[dev];
  if (blocks < 1) blocks = 1;  // block 0 does the head and the tail
  member_bitmap_kernel<SW><<<(unsigned)blocks, kThreads, sum_bytes,
                             stream>>>(dims, n, h, nv, bitmap, dim_size,
                                       summary, sum_bytes, sum_shift, out);
  return (int)cudaGetLastError();
}

}  // namespace

// dims: int32[n], 4-byte aligned; bitmap: the kept set, u32[>= dim_size /
// 32]; summary: u32[sum_words], bit i set iff any of bitmap words [i <<
// sum_shift, (i + 1) << sum_shift) is nonzero, 16-byte aligned, sum_words a
// multiple of 4 and at most 48 KB; out: u8[n], out[i] = 0 <= dims[i] <
// dim_size and bit dims[i] of the bitmap.
extern "C" int kssd_member_bitmap(const void* dims, int64_t n,
                                  const void* bitmap, int32_t dim_size,
                                  const void* summary, int sum_words,
                                  int sum_shift, void* out, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const uintptr_t dp = (uintptr_t)dims, op = (uintptr_t)out;
  if (dp % 4 || (uintptr_t)summary % 16 || dim_size <= 0 ||
      sum_words <= 0 || sum_words % 4 || sum_words > (48 << 10) / 4 ||
      sum_shift < 0 || sum_shift > 26 ||
      ((long long)sum_words * 32 << (5 + sum_shift)) < dim_size)
    return (int)cudaErrorInvalidValue;
  // head: dims from h on 16-byte aligned, out from h on aligned to the
  // widest store that the two offsets allow
  const int d_a = (int)((16 - dp % 16) % 16) / 4;
  const int o_a = (int)((16 - op % 16) % 16);
  const int rel = (o_a - d_a) & 3;
  long long h = rel == 0 ? o_a : d_a;
  if (h > n) h = n;
  const long long nv = (n - h) / kVec;
  const auto* d = (const int32_t*)dims;
  const auto* bm = (const uint32_t*)bitmap;
  const auto* sm = (const uint32_t*)summary;
  const uint32_t bytes = (uint32_t)sum_words * 4;
  auto* o = (uint8_t*)out;
  auto* st = (cudaStream_t)stream;
  if (rel == 0)
    return launch<16>(d, n, h, nv, bm, dim_size, sm, bytes, sum_shift, o, st);
  if (rel == 2)
    return launch<2>(d, n, h, nv, bm, dim_size, sm, bytes, sum_shift, o, st);
  return launch<1>(d, n, h, nv, bm, dim_size, sm, bytes, sum_shift, o, st);
}
