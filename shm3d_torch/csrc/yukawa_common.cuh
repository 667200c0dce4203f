// Device code and launch geometry shared by the Yukawa kernel (yukawa.cu)
// and its speed-of-light probe (yukawa_skeleton.cu): the MUFU wrappers, the
// clamped squared distance, and the split of the source axis into chunks
// that fill the card.

#pragma once

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace yukawa {

constexpr int THREADS = 256;            // threads per block = sources per stage
constexpr int QPT = 4;                  // queries per thread
constexpr int QBLOCK = THREADS * QPT;   // queries per block
constexpr int MAX_CHUNKS = 65535;       // gridDim.y
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rsqrt_approx(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// r^2 + FLT_MIN: a query on a source keeps a finite rsqrt and the
// coincident source dominates, as in the TPU kernel
__device__ __forceinline__ float dist2(float dx, float dy, float dz) {
  return fmaf(dz, dz, fmaf(dy, dy, fmaf(dx, dx, FLT_MIN)));
}

// Sources a chunk of `kernel`'s (query block, source chunk) grid holds for Q
// queries and S sources on CUDA device `device` (a multiple of THREADS, at
// least THREADS): the chunking that minimizes the waves of blocks times the
// stages a block runs (plus one stage of fixed cost a block), from the SM
// count and the kernel's occupancy.  Returns -1 on a CUDA error.
template <typename Kernel>
int64_t chunk_len(Kernel kernel, int64_t Q, int64_t S, int device) {
  int sms = 0, per_sm = 0;
  if (cudaSetDevice(device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0) != cudaSuccess)
    return -1;
  const int64_t slots = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int64_t qblocks = (Q + QBLOCK - 1) / QBLOCK;
  const int64_t stages = (S + THREADS - 1) / THREADS;
  int64_t best_len = stages, best_cost = -1;
  for (int64_t c = 1; c <= stages; ++c) {
    const int64_t len = (stages + c - 1) / c;          // stages a chunk
    const int64_t chunks = (stages + len - 1) / len;
    if (chunks > MAX_CHUNKS) continue;
    const int64_t waves = (qblocks * chunks + slots - 1) / slots;
    const int64_t cost = waves * (len + 1);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best_len = len;
    }
  }
  return best_len * THREADS;
}

}  // namespace yukawa
