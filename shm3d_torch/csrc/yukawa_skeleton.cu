// Speed-of-light probe for the Yukawa kernel (csrc/yukawa.cu) on Hopper:
//
//   out(q) = sum_s exp(-lam |q - p_s|) / |q - p_s|
//
// over every (query, source) pair: only the per-pair work that the Yukawa
// kernel cannot avoid -- the differences, r^2, rsqrt and the exponential --
// and a row sum.  No running minimum, no rescale, no vector accumulation.
//
// Replaces the Pallas TPU kernel bench_kernels.py:_skeleton_pallas (its inner
// ``kernel``), which streams (1024-query x 1024-source) tiles through VMEM,
// carries the row sum in scratch across the sequential source axis and needs
// the sources padded to a multiple of 1024 with far points.  Here the launch
// geometry is the Yukawa kernel's own: one thread per query, the block stages
// TILE source points at a time (as float4) in shared memory and every thread
// walks them, the row sum in registers.  So the time of the Yukawa kernel
// over the time of this probe measures the Yukawa kernel's bookkeeping and
// nothing else.  The ragged source tail is bounded by S: no padding.  r^2 is
// clamped to FLT_MIN and rsqrtf / expf are the ones the Yukawa kernel
// compiles to (no fast-math it lacks); the TPU probe has no clamp, and its
// inputs never put a query on a source.  Each stage's terms are summed into
// a partial that is then added to the row sum (one add a stage): a single
// float32 running sum over ~52k positive terms drifts ~1e-5 from the
// pairwise sum of the plain version.
//
// What bounds it on the card: two special-function (MUFU) operations per
// pair, rsqrt and the exponential's ex2; 132 SMs x 16 MUFU results per clock
// give ~2.1e12 pairs/s at 1.98 GHz.  The FP32 work (~14 operations a pair)
// and the bytes (q and out once, p once per block from L2) are far below
// that.  The kernel is the yardstick for the Yukawa kernel's later
// performance work, not part of any solve.
//
// Built with nvcc into a shared library with a plain C interface, loaded
// with ctypes by shm3d_torch/_build.py.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 256;  // threads per block = sources per stage

__global__ void __launch_bounds__(TILE)
skeleton_kernel(const float* __restrict__ q, const float* __restrict__ p,
                float* __restrict__ out, int64_t Q, int64_t S, float lam) {
  __shared__ float4 sp[TILE];

  const int64_t i = static_cast<int64_t>(blockIdx.x) * TILE + threadIdx.x;
  const bool active = i < Q;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = q[3 * i];
    qy = q[3 * i + 1];
    qz = q[3 * i + 2];
  }
  float acc = 0.f;

  for (int64_t s0 = 0; s0 < S; s0 += TILE) {
    const int cnt = static_cast<int>(S - s0 < TILE ? S - s0 : TILE);
    __syncthreads();  // the previous stage has been read by every thread
    if (threadIdx.x < cnt) {
      const int64_t s = s0 + threadIdx.x;
      sp[threadIdx.x] = make_float4(p[3 * s], p[3 * s + 1], p[3 * s + 2], 0.f);
    }
    __syncthreads();
    float part = 0.f;
    for (int k = 0; k < cnt; ++k) {
      const float4 P = sp[k];
      const float dx = qx - P.x, dy = qy - P.y, dz = qz - P.z;
      const float r2 = fmaxf(dx * dx + dy * dy + dz * dz, FLT_MIN);
      const float inv = rsqrtf(r2);
      part += expf(-(lam * r2) * inv) * inv;
    }
    acc += part;
  }

  if (active) out[i] = acc;
}

}  // namespace

extern "C" {

// queries (Q, 3), points (S, 3), out (Q,): contiguous float32 arrays on CUDA
// device `device`.  Launches on `stream` and returns cudaGetLastError() (0 on
// success); does not synchronize.
int shm3d_yukawa_skeleton_f32(const float* queries, const float* points,
                              float* out, int64_t Q, int64_t S, float lam,
                              int device, void* stream) {
  if (Q <= 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int64_t blocks = (Q + TILE - 1) / TILE;
  skeleton_kernel<<<static_cast<unsigned int>(blocks), TILE, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      queries, points, out, Q, S, lam);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
