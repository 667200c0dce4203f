// Steps 1-2 of the Signed Heat Method on Hopper: the Yukawa vector sum
//
//   X(q) = sum_s v_s * exp(-lam |q - p_s|) / |q - p_s|
//
// over every (query, source) pair, written out as X / |X| (normalize = 1)
// or X (normalize = 0).
//
// Replaces the Pallas TPU kernel shm3d/ops/yukawa.py:_yukawa_kernel.  The
// TPU kernel streams (1024-query x 1024-source) tiles through VMEM and keeps
// a per-tile running minimum of lam*r in scratch across the sequential grid.
// Here one thread owns one query and keeps q, the running minimum m and the
// three accumulators in registers; the block stages TILE sources at a time
// (point and vector as float4) in shared memory, and every thread of the
// block walks them.  The minimum is kept per pair (online form): when
// b = lam*r drops below m the accumulator is rescaled by exp(b - m) before
// the pair is added, which is the TPU kernel's per-block rescale taken one
// source at a time -- the same sum up to rounding.  The ragged source tail
// is bounded by S, so no far-point padding or (3, S) transpose is needed,
// and every query row is independent, so no query-chunk split either.
//
// What bounds it on the card: two special-function (MUFU) operations per
// pair, rsqrt and the exponential, plus about fifteen FP32 FMA/ALU
// operations.  The main path (128^3 grid, 52,290 sources, about 0.25M shell
// and coarse queries) has ~1.3e10 pairs, i.e. milliseconds at the SFU
// limit of an H100.  The contraction over the 3-wide vector is far too
// narrow for wgmma; making the kernel fast (several queries per thread,
// source tiles shared through TMA, fast-math exponentials) is later work.
//
// Built with nvcc into a shared library with a plain C interface, loaded
// with ctypes by shm3d_torch/_build.py.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 256;        // threads per block = sources per stage
constexpr float BIG = 3e38f;     // "no minimum seen yet" (finite in f32)

__global__ void __launch_bounds__(TILE)
yukawa_kernel(const float* __restrict__ q, const float* __restrict__ p,
              const float* __restrict__ v, float* __restrict__ out,
              int64_t Q, int64_t S, float lam, int normalize) {
  __shared__ float4 sp[TILE];
  __shared__ float4 sv[TILE];

  const int64_t i = static_cast<int64_t>(blockIdx.x) * TILE + threadIdx.x;
  const bool active = i < Q;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = q[3 * i];
    qy = q[3 * i + 1];
    qz = q[3 * i + 2];
  }
  float m = BIG;
  float ax = 0.f, ay = 0.f, az = 0.f;

  for (int64_t s0 = 0; s0 < S; s0 += TILE) {
    const int cnt = static_cast<int>(S - s0 < TILE ? S - s0 : TILE);
    __syncthreads();  // the previous stage has been read by every thread
    if (threadIdx.x < cnt) {
      const int64_t s = s0 + threadIdx.x;
      sp[threadIdx.x] = make_float4(p[3 * s], p[3 * s + 1], p[3 * s + 2], 0.f);
      sv[threadIdx.x] = make_float4(v[3 * s], v[3 * s + 1], v[3 * s + 2], 0.f);
    }
    __syncthreads();
    for (int k = 0; k < cnt; ++k) {
      const float4 P = sp[k];
      const float dx = qx - P.x, dy = qy - P.y, dz = qz - P.z;
      // r2 == 0 (a query on a source): clamp so rsqrt stays finite and the
      // coincident source dominates, as the TPU kernel does
      const float r2 = fmaxf(dx * dx + dy * dy + dz * dz, FLT_MIN);
      const float inv = rsqrtf(r2);
      const float b = (lam * r2) * inv;  // lam * r
      if (b < m) {
        // new minimum: rescale what was summed relative to the old one
        // (the first source finds the sentinel and an empty accumulator)
        const float scale = (m >= BIG) ? 0.f : expf(b - m);
        ax *= scale;
        ay *= scale;
        az *= scale;
        m = b;
      }
      const float w = expf(m - b) * inv;
      const float4 V = sv[k];
      ax += w * V.x;
      ay += w * V.y;
      az += w * V.z;
    }
  }

  if (active) {
    float ox, oy, oz;
    if (normalize) {
      const float nrm = sqrtf(ax * ax + ay * ay + az * az);
      ox = ax / nrm;
      oy = ay / nrm;
      oz = az / nrm;
    } else {
      const float e = expf(-m);
      ox = ax * e;
      oy = ay * e;
      oz = az * e;
    }
    out[3 * i] = ox;
    out[3 * i + 1] = oy;
    out[3 * i + 2] = oz;
  }
}

}  // namespace

extern "C" {

// queries (Q, 3), points (S, 3), vectors (S, 3), out (Q, 3): contiguous
// float32 arrays on CUDA device `device`.  Launches on `stream` and
// returns cudaGetLastError() (0 on success); does not synchronize.
int shm3d_yukawa_f32(const float* queries, const float* points,
                     const float* vectors, float* out, int64_t Q, int64_t S,
                     float lam, int normalize, int device, void* stream) {
  if (Q <= 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int64_t blocks = (Q + TILE - 1) / TILE;
  yukawa_kernel<<<static_cast<unsigned int>(blocks), TILE, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      queries, points, vectors, out, Q, S, lam, normalize);
  return static_cast<int>(cudaGetLastError());
}

const char* shm3d_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
