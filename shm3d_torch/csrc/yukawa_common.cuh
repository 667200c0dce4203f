// Device code and launch geometry shared by the Yukawa kernel (yukawa.cu)
// and its speed-of-light probe (yukawa_skeleton.cu): the MUFU wrappers, the
// precision trait that picks a pair's exp2, rsqrt and r^2 floor for each
// scalar type, the clamped squared distance, and the split of the source
// axis into chunks that fill the card.

#pragma once

#include <cfloat>
#include <cmath>
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

// A pair's transcendental functions and r^2 floor in each precision.  The
// float32 pair runs on the MUFU approximations (.approx.ftz, ~2 ulp).  The
// float64 pair takes libdevice's IEEE exp2 and rsqrt (1 ulp; rsqrt from
// MUFU.RSQ64H's 20-bit seed and Newton steps on the FP64 pipe): MUFU has no
// float64 exponential, and a float32 approximation would leave ~7 of the 16
// digits the float64 path is held to.
template <typename T>
struct Precision;

template <>
struct Precision<float> {
  static constexpr float tiny = FLT_MIN;
  static __device__ __forceinline__ float exp2(float x) { return ex2_approx(x); }
  static __device__ __forceinline__ float rsqrt(float x) { return rsqrt_approx(x); }
  static __device__ __forceinline__ float fma(float a, float b, float c) { return fmaf(a, b, c); }
  static __device__ __forceinline__ float max(float a, float b) { return fmaxf(a, b); }
  static __device__ __forceinline__ float min(float a, float b) { return fminf(a, b); }
  static __device__ __forceinline__ float sqrt(float x) { return sqrtf(x); }
};

template <>
struct Precision<double> {
  static constexpr double tiny = DBL_MIN;
  static __device__ __forceinline__ double exp2(double x) { return ::exp2(x); }
  static __device__ __forceinline__ double rsqrt(double x) { return ::rsqrt(x); }
  static __device__ __forceinline__ double fma(double a, double b, double c) { return ::fma(a, b, c); }
  static __device__ __forceinline__ double max(double a, double b) { return ::fmax(a, b); }
  static __device__ __forceinline__ double min(double a, double b) { return ::fmin(a, b); }
  static __device__ __forceinline__ double sqrt(double x) { return ::sqrt(x); }
};

// r^2 + the type's smallest normal (torch.finfo(dtype).tiny in the plain
// version): a query on a source keeps a finite rsqrt and the coincident
// source dominates, as in the TPU kernel
template <typename T>
__device__ __forceinline__ T dist2(T dx, T dy, T dz) {
  using F = Precision<T>;
  return F::fma(dz, dz, F::fma(dy, dy, F::fma(dx, dx, F::tiny)));
}

// Sources a chunk of `kernel`'s (query block, source chunk) grid holds for Q
// queries and S sources on CUDA device `device` (a multiple of THREADS, at
// least THREADS), for a kernel of `qblock` queries a block: the chunking
// that minimizes the waves of blocks times the stages a block runs (plus
// one stage of fixed cost a block), from the SM count and the kernel's
// occupancy.  Returns -1 on a CUDA error.
template <typename Kernel>
int64_t chunk_len(Kernel kernel, int64_t Q, int64_t S, int device, int64_t qblock = QBLOCK) {
  int sms = 0, per_sm = 0;
  if (cudaSetDevice(device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0) != cudaSuccess)
    return -1;
  const int64_t slots = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int64_t qblocks = (Q + qblock - 1) / qblock;
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
