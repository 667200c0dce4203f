// Steps 1-2 of the Signed Heat Method on Hopper: the Yukawa vector sum
//
//   X(q) = sum_s v_s * exp(-lam |q - p_s|) / |q - p_s|
//
// over every (query, source) pair, written out as X / |X| (normalize = 1)
// or X (normalize = 0).
//
// The port of the Pallas TPU kernel shm3d/ops/yukawa.py:_yukawa_kernel.
// The TPU kernel streams (1024-query x 1024-source) tiles through VMEM and
// keeps a per-tile running minimum of lam*r in scratch across a sequential
// grid axis.  CUDA blocks run in no order, so the source axis is cut into
// chunks instead, and two kernels compute the sum:
//
// 1. yukawa_partial_kernel: block (i, k) takes 1024 queries (four a
//    thread, at i*1024 + j*256 + threadIdx.x) against source chunk k.  The
//    block stages 256 sources at a time in shared memory as float4 (point,
//    vector); one broadcast load of a staged source serves four pairs.
//    Every exponent is in log2 units: lam2 = lam * log2(e) is folded into
//    one constant, and each pair costs one rsqrt and one ex2 (MUFU, both
//    .approx.ftz) and 13 FP32 operations.  A query keeps a reference m
//    (lam2 times a distance) and sums a = sum v exp2(m - lam2 r) / r.  The
//    reference moves at most once a stage, not on every new minimum: the
//    stage runs with the m it starts with, tracking the largest exponent
//    (one max a pair, no branch); after the stage, an exponent above 0 (a
//    source closer than m) rebases a and m once.  An exponent above TAU
//    means the stage's weights may have reached 2^TAU * rsqrt(FLT_MIN), so
//    the stage is summed again from the saved accumulators with the new m
//    (the first stage of a chunk starts from the chunk's first source, so
//    this happens there and where a much nearer source turns up).  Weights
//    thus stay below 2^TAU, and a far row, whose every exp(-lam r)
//    underflows in float32, keeps its nearest sources at weight ~1.
//    The block writes (m, a) per query and chunk.
// 2. yukawa_merge_kernel: one thread a query merges the chunks in chunk
//    order, m = min m_k and a = sum a_k exp2(m - m_k), and writes X / |X|
//    or a exp2(-m).  The sum is deterministic.
//
// The chunk length (yukawa_chunk_len) fills the card: the main path's
// coarse launch (35,937 queries = 36 query blocks) and shell launch
// (211,563 = 207) would otherwise leave most of the 132 SMs idle or run
// one ragged wave.
//
// What bounds it on the card: two MUFU operations a pair at 16 a clock an
// SM, with ~13 FP32 operations a pair on the side (128 lanes a clock an
// SM, so ~0.8 of the MUFU time).  No tensor cores: the contraction runs
// over sources into a 3-wide output, far too narrow for wgmma, and TF32 or
// f16 inputs keep ~3 digits against a direction tolerance of 1e-4.
//
// Built with nvcc into a shared library with a plain C interface, loaded
// with ctypes by shm3d_torch/_build.py.

#include <cmath>

#include "yukawa_common.cuh"

namespace {

using namespace yukawa;

constexpr float TAU = 32.f;             // log2 margin before a stage is summed again

struct Acc {
  float qx[QPT], qy[QPT], qz[QPT];
  float m[QPT];                  // lam2 * (reference distance)
  float ax[QPT], ay[QPT], az[QPT];
  float amax[QPT];               // largest exponent of the stage
};

// One stage: cnt staged sources against the thread's queries.
__device__ __forceinline__ void stage(Acc& A, const float4* sp, const float4* sv,
                                      int cnt, float lam2) {
#pragma unroll
  for (int j = 0; j < QPT; ++j) A.amax[j] = -INFINITY;
#pragma unroll 2
  for (int k = 0; k < cnt; ++k) {
    const float4 P = sp[k];
    const float4 V = sv[k];
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      const float r2 = dist2(P.x - A.qx[j], P.y - A.qy[j], P.z - A.qz[j]);
      const float inv = rsqrt_approx(r2);
      const float arg = fmaf(-lam2, r2 * inv, A.m[j]);  // m - lam2 r
      A.amax[j] = fmaxf(A.amax[j], arg);
      const float w = ex2_approx(arg) * inv;
      A.ax[j] = fmaf(w, V.x, A.ax[j]);
      A.ay[j] = fmaf(w, V.y, A.ay[j]);
      A.az[j] = fmaf(w, V.z, A.az[j]);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
yukawa_partial_kernel(const float* __restrict__ q, const float* __restrict__ p,
                      const float* __restrict__ v, float4* __restrict__ part,
                      int64_t Q, int64_t S, int64_t chunk, float lam2) {
  __shared__ float4 sp[THREADS];
  __shared__ float4 sv[THREADS];

  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * QBLOCK + threadIdx.x;
  const int64_t s_begin = static_cast<int64_t>(blockIdx.y) * chunk;
  const int64_t s_end = S - s_begin < chunk ? S : s_begin + chunk;
  // a warp whose queries all lie past Q only helps stage the sources
  const bool live = __any_sync(0xffffffffu, q0 < Q);

  Acc A;
  const float p0x = p[3 * s_begin], p0y = p[3 * s_begin + 1], p0z = p[3 * s_begin + 2];
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int64_t i = q0 + j * THREADS;
    A.qx[j] = i < Q ? q[3 * i] : 0.f;
    A.qy[j] = i < Q ? q[3 * i + 1] : 0.f;
    A.qz[j] = i < Q ? q[3 * i + 2] : 0.f;
    // the reference starts at the chunk's first source
    const float r2 = dist2(p0x - A.qx[j], p0y - A.qy[j], p0z - A.qz[j]);
    A.m[j] = lam2 * (r2 * rsqrt_approx(r2));
    A.ax[j] = A.ay[j] = A.az[j] = 0.f;
  }

  for (int64_t s0 = s_begin; s0 < s_end; s0 += THREADS) {
    const int cnt = static_cast<int>(s_end - s0 < THREADS ? s_end - s0 : THREADS);
    __syncthreads();  // the previous stage has been read by every thread
    if (threadIdx.x < cnt) {
      const int64_t s = s0 + threadIdx.x;
      sp[threadIdx.x] = make_float4(p[3 * s], p[3 * s + 1], p[3 * s + 2], 0.f);
      sv[threadIdx.x] = make_float4(v[3 * s], v[3 * s + 1], v[3 * s + 2], 0.f);
    }
    __syncthreads();
    if (!live) continue;

    float sx[QPT], sy[QPT], sz[QPT];
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      sx[j] = A.ax[j];
      sy[j] = A.ay[j];
      sz[j] = A.az[j];
    }
    stage(A, sp, sv, cnt, lam2);
    bool again = false;
#pragma unroll
    for (int j = 0; j < QPT; ++j) again |= A.amax[j] > TAU;
    if (again) {
      // sum the stage again from the saved accumulators, every query of
      // this thread with the reference its first pass found
#pragma unroll
      for (int j = 0; j < QPT; ++j) {
        const float shift = A.amax[j] > 0.f ? A.amax[j] : 0.f;
        const float scale = ex2_approx(-shift);
        A.m[j] -= shift;
        A.ax[j] = sx[j] * scale;
        A.ay[j] = sy[j] * scale;
        A.az[j] = sz[j] * scale;
      }
      stage(A, sp, sv, cnt, lam2);
    }
    // a nearer source: rebase once for the stage
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      if (A.amax[j] > 0.f) {
        const float scale = ex2_approx(-A.amax[j]);
        A.m[j] -= A.amax[j];
        A.ax[j] *= scale;
        A.ay[j] *= scale;
        A.az[j] *= scale;
      }
    }
  }

  float4* out = part + static_cast<int64_t>(blockIdx.y) * Q;
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int64_t i = q0 + j * THREADS;
    if (i < Q) out[i] = make_float4(A.m[j], A.ax[j], A.ay[j], A.az[j]);
  }
}

__global__ void __launch_bounds__(THREADS)
yukawa_merge_kernel(const float4* __restrict__ part, float* __restrict__ out,
                    int64_t Q, int chunks, int normalize) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= Q) return;
  float m = part[i].x;
  for (int k = 1; k < chunks; ++k) m = fminf(m, part[k * Q + i].x);
  float ax = 0.f, ay = 0.f, az = 0.f;
  for (int k = 0; k < chunks; ++k) {
    const float4 P = part[k * Q + i];
    const float scale = ex2_approx(m - P.x);
    ax = fmaf(P.y, scale, ax);
    ay = fmaf(P.z, scale, ay);
    az = fmaf(P.w, scale, az);
  }
  float ox, oy, oz;
  if (normalize) {
    const float nrm = sqrtf(ax * ax + ay * ay + az * az);
    ox = ax / nrm;
    oy = ay / nrm;
    oz = az / nrm;
  } else {
    const float e = ex2_approx(-m);
    ox = ax * e;
    oy = ay * e;
    oz = az * e;
  }
  out[3 * i] = ox;
  out[3 * i + 1] = oy;
  out[3 * i + 2] = oz;
}

}  // namespace

extern "C" {

// Sources a chunk of the partial kernel holds for Q queries and S sources
// on CUDA device `device` (yukawa::chunk_len).  Returns -1 on a CUDA error.
int64_t shm3d_yukawa_chunk_len(int64_t Q, int64_t S, int device) {
  return yukawa::chunk_len(yukawa_partial_kernel, Q, S, device);
}

// The partial kernel alone: part (ceil(S / chunk), Q) float4 receives, per
// source chunk and query, (m, a) with m = lam2 * (reference distance) and
// a = sum v exp2(m - lam2 r) / r.  queries (Q, 3), points (S, 3), vectors
// (S, 3): contiguous float32 arrays on CUDA device `device`; chunk a
// multiple of 256 (shm3d_yukawa_chunk_len); lam2 = lam * log2(e).
// Launches on `stream` and returns cudaGetLastError() (0 on success); does
// not synchronize.
int shm3d_yukawa_partials_f32(const float* queries, const float* points,
                              const float* vectors, float* part, int64_t Q, int64_t S,
                              int64_t chunk, float lam2, int device, void* stream) {
  if (Q <= 0 || S <= 0) return 0;
  if (chunk <= 0 || chunk % THREADS != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t chunks = (S + chunk - 1) / chunk;
  if (chunks > MAX_CHUNKS) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid(static_cast<unsigned int>((Q + QBLOCK - 1) / QBLOCK),
                  static_cast<unsigned int>(chunks));
  yukawa_partial_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      queries, points, vectors, reinterpret_cast<float4*>(part), Q, S, chunk, lam2);
  return static_cast<int>(cudaGetLastError());
}

// The merge kernel alone: part (chunks, Q) float4 from any number of
// partial launches over disjoint sources, stacked in the order to merge;
// out (Q, 3) float32 receives X / |X| (normalize = 1) or X.  Same stream
// and error contract as shm3d_yukawa_partials_f32.
int shm3d_yukawa_merge_f32(const float* part, float* out, int64_t Q, int64_t chunks,
                           int normalize, int device, void* stream) {
  if (Q <= 0) return 0;
  if (chunks <= 0 || chunks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  yukawa_merge_kernel<<<static_cast<unsigned int>((Q + THREADS - 1) / THREADS), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(part), out, Q, static_cast<int>(chunks), normalize);
  return static_cast<int>(cudaGetLastError());
}

// queries (Q, 3), points (S, 3), vectors (S, 3), out (Q, 3): contiguous
// float32 arrays on CUDA device `device`; part: (ceil(S / chunk), Q) float4
// scratch, chunk a multiple of 256 (shm3d_yukawa_chunk_len); lam2 = lam *
// log2(e).  Launches the partial and the merge kernel on `stream` and
// returns cudaGetLastError() (0 on success); does not synchronize.
int shm3d_yukawa_f32(const float* queries, const float* points,
                     const float* vectors, float* out, float* part, int64_t Q,
                     int64_t S, int64_t chunk, float lam2, int normalize,
                     int device, void* stream) {
  const int err = shm3d_yukawa_partials_f32(queries, points, vectors, part, Q, S, chunk,
                                            lam2, device, stream);
  if (err != 0 || Q <= 0 || S <= 0) return err;
  return shm3d_yukawa_merge_f32(part, out, Q, (S + chunk - 1) / chunk, normalize, device,
                                stream);
}

const char* shm3d_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
