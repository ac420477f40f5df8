// Kept-dims keep test for the sketch stream step, as a bitmap lookup.
//
// Replaces the Pallas TPU kernel `_member_kernel`
// (rabbitkssd_tpu/ops/pallas_member.py:78, launched by `_member_call`).
// It computes the same function, not the same blocks: for every window's
// substring-space dim_id d, whether 0 <= shuffled_dim[d] < dim_end.  The
// TPU kernel partitioned the kept set into an [R, 128] lane table because
// its only fast data-dependent load was a lane-local gather, and needed R
// rounds of gather+compare per tile.  On Hopper a random 4-byte load that
// hits L2 is cheap, so the kept set becomes one bitmap of dim_size bits
// (bit d set iff d is kept): 2 MiB at half_subk = 6, which stays resident
// in the 50 MB L2.  One kernel serves every kept-set size.
//
// Bound: not DRAM.  Each window costs a coalesced 4-byte dim_id load and a
// coalesced 1-byte mask store (~5 B of DRAM traffic, ~3 us for one stream
// step batch of 2.1M windows at HBM3 bandwidth) plus one random bitmap
// read that hits L2 (a 32-byte sector per window).  chip_smoke.py measured
// 24-37 us per batch on an NVIDIA H100 80GB HBM3 at a 700 W power limit,
// about 10x the DRAM figure, so the random L2 sector reads (and launch
// overhead at this size) set its time.  Not tuned.
//
// The sketch stream step no longer calls this kernel: stream_keep.cu
// fuses the same lookup (member.cuh) into the window hash.  It stays as
// the stand-alone keep test of ops/member.py.
//
// Plain C interface for ctypes; launches on the caller's stream, does not
// synchronise and allocates nothing.  Returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

#include "member.cuh"

namespace {

__global__ void member_bitmap_kernel(const int32_t* __restrict__ dims,
                                     int64_t n,
                                     const uint32_t* __restrict__ bitmap,
                                     int32_t dim_size,
                                     uint8_t* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = (uint8_t)kssd_bitmap_hit(bitmap, dims[i], dim_size);
  }
}

}  // namespace

extern "C" int kssd_member_bitmap(const void* dims, int64_t n,
                                  const void* bitmap, int32_t dim_size,
                                  void* out, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  int64_t blocks = (n + threads - 1) / threads;
  // grid-stride beyond ~32 resident blocks per SM on 132 SMs
  if (blocks > 132 * 32) blocks = 132 * 32;
  member_bitmap_kernel<<<(unsigned)blocks, threads, 0,
                         (cudaStream_t)stream>>>(
      (const int32_t*)dims, n, (const uint32_t*)bitmap, dim_size,
      (uint8_t*)out);
  return (int)cudaGetLastError();
}
