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
// Both kernels are templates on the scalar, instantiated for float32 (the
// default path) and float64 (dtype="float64", the reference's precision),
// with one algorithm: the float64 pair keeps the log2 exponents, the
// running reference and the rebase, with a wider TAU (Kernel<double>) and
// 32-byte records in shared memory and in the partials.  The precision
// trait (yukawa_common.cuh) keeps the float64 pair off the MUFU
// approximations: MUFU has no float64 exp2, and its float32 ex2 and rsqrt
// would round every weight to ~2e-7, where the float64 solve is held to
// 1e-12.  The float64 pair takes libdevice's exp2 (a range reduction and a
// polynomial of DFMAs) and rsqrt (MUFU.RSQ64H and Newton steps): some 30-40
// FP64 instructions, at 64 lanes a clock an SM, so it is bound by the FP64
// pipe, not by MUFU.
//
// Built with nvcc into a shared library with a plain C interface, loaded
// with ctypes by shm3d_torch/_build.py.

#include <cmath>

#include "yukawa_common.cuh"

namespace {

using namespace yukawa;

// A per-precision record of four scalars (a staged source's point or
// vector, one query's (m, a) partial) and the log2 margin TAU before a
// stage is summed again.  float32: weights stay below 2^TAU rsqrt(FLT_MIN)
// = 2^95.  float64: rsqrt(DBL_MIN) = 2^511, so a margin of 2^256 keeps the
// weights below 2^767 and a sum of 2^26 of them finite, and a stage is
// summed again only where a source turns up 256/lam2 nearer than the
// reference.
template <typename T>
struct Kernel;

template <>
struct Kernel<float> {
  using Rec = float4;
  static constexpr float TAU = 32.f;
};

// double4 is deprecated in CUDA 13 for its ambiguous alignment: an explicit
// 32-byte record
struct alignas(32) Double4 {
  double x, y, z, w;
};

template <>
struct Kernel<double> {
  using Rec = Double4;
  static constexpr double TAU = 256.0;
};

template <typename T>
__device__ __forceinline__ typename Kernel<T>::Rec make_rec(T x, T y, T z, T w) {
  return {x, y, z, w};
}

template <typename T>
struct Acc {
  T qx[QPT], qy[QPT], qz[QPT];
  T m[QPT];                      // lam2 * (reference distance)
  T ax[QPT], ay[QPT], az[QPT];
  T amax[QPT];                   // largest exponent of the stage
};

// One stage: cnt staged sources against the thread's queries.
template <typename T>
__device__ __forceinline__ void stage(Acc<T>& A, const typename Kernel<T>::Rec* sp,
                                      const typename Kernel<T>::Rec* sv, int cnt, T lam2) {
  using F = Precision<T>;
#pragma unroll
  for (int j = 0; j < QPT; ++j) A.amax[j] = -INFINITY;
#pragma unroll 2
  for (int k = 0; k < cnt; ++k) {
    const typename Kernel<T>::Rec P = sp[k];
    const typename Kernel<T>::Rec V = sv[k];
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      const T r2 = dist2(P.x - A.qx[j], P.y - A.qy[j], P.z - A.qz[j]);
      const T inv = F::rsqrt(r2);
      const T arg = F::fma(-lam2, r2 * inv, A.m[j]);  // m - lam2 r
      A.amax[j] = F::max(A.amax[j], arg);
      const T w = F::exp2(arg) * inv;
      A.ax[j] = F::fma(w, V.x, A.ax[j]);
      A.ay[j] = F::fma(w, V.y, A.ay[j]);
      A.az[j] = F::fma(w, V.z, A.az[j]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
yukawa_partial_kernel(const T* __restrict__ q, const T* __restrict__ p,
                      const T* __restrict__ v, typename Kernel<T>::Rec* __restrict__ part,
                      int64_t Q, int64_t S, int64_t chunk, T lam2) {
  using F = Precision<T>;
  using Rec = typename Kernel<T>::Rec;
  constexpr T TAU = Kernel<T>::TAU;
  __shared__ Rec sp[THREADS];
  __shared__ Rec sv[THREADS];

  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * QBLOCK + threadIdx.x;
  const int64_t s_begin = static_cast<int64_t>(blockIdx.y) * chunk;
  const int64_t s_end = S - s_begin < chunk ? S : s_begin + chunk;
  // a warp whose queries all lie past Q only helps stage the sources
  const bool live = __any_sync(0xffffffffu, q0 < Q);

  Acc<T> A;
  const T p0x = p[3 * s_begin], p0y = p[3 * s_begin + 1], p0z = p[3 * s_begin + 2];
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int64_t i = q0 + j * THREADS;
    A.qx[j] = i < Q ? q[3 * i] : T(0);
    A.qy[j] = i < Q ? q[3 * i + 1] : T(0);
    A.qz[j] = i < Q ? q[3 * i + 2] : T(0);
    // the reference starts at the chunk's first source
    const T r2 = dist2(p0x - A.qx[j], p0y - A.qy[j], p0z - A.qz[j]);
    A.m[j] = lam2 * (r2 * F::rsqrt(r2));
    A.ax[j] = A.ay[j] = A.az[j] = T(0);
  }

  for (int64_t s0 = s_begin; s0 < s_end; s0 += THREADS) {
    const int cnt = static_cast<int>(s_end - s0 < THREADS ? s_end - s0 : THREADS);
    __syncthreads();  // the previous stage has been read by every thread
    if (threadIdx.x < cnt) {
      const int64_t s = s0 + threadIdx.x;
      sp[threadIdx.x] = make_rec<T>(p[3 * s], p[3 * s + 1], p[3 * s + 2], T(0));
      sv[threadIdx.x] = make_rec<T>(v[3 * s], v[3 * s + 1], v[3 * s + 2], T(0));
    }
    __syncthreads();
    if (!live) continue;

    T sx[QPT], sy[QPT], sz[QPT];
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
        const T shift = A.amax[j] > T(0) ? A.amax[j] : T(0);
        const T scale = F::exp2(-shift);
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
      if (A.amax[j] > T(0)) {
        const T scale = F::exp2(-A.amax[j]);
        A.m[j] -= A.amax[j];
        A.ax[j] *= scale;
        A.ay[j] *= scale;
        A.az[j] *= scale;
      }
    }
  }

  Rec* out = part + static_cast<int64_t>(blockIdx.y) * Q;
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int64_t i = q0 + j * THREADS;
    if (i < Q) out[i] = make_rec<T>(A.m[j], A.ax[j], A.ay[j], A.az[j]);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
yukawa_merge_kernel(const typename Kernel<T>::Rec* __restrict__ part, T* __restrict__ out,
                    int64_t Q, int chunks, int normalize) {
  using F = Precision<T>;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= Q) return;
  T m = part[i].x;
  for (int k = 1; k < chunks; ++k) m = F::min(m, part[k * Q + i].x);
  T ax = T(0), ay = T(0), az = T(0);
  for (int k = 0; k < chunks; ++k) {
    const typename Kernel<T>::Rec P = part[k * Q + i];
    const T scale = F::exp2(m - P.x);
    ax = F::fma(P.y, scale, ax);
    ay = F::fma(P.z, scale, ay);
    az = F::fma(P.w, scale, az);
  }
  T ox, oy, oz;
  if (normalize) {
    const T nrm = F::sqrt(ax * ax + ay * ay + az * az);
    ox = ax / nrm;
    oy = ay / nrm;
    oz = az / nrm;
  } else {
    const T e = F::exp2(-m);
    ox = ax * e;
    oy = ay * e;
    oz = az * e;
  }
  out[3 * i] = ox;
  out[3 * i + 1] = oy;
  out[3 * i + 2] = oz;
}

template <typename T>
int partials(const T* queries, const T* points, const T* vectors, T* part, int64_t Q,
             int64_t S, int64_t chunk, T lam2, int device, void* stream) {
  if (Q <= 0 || S <= 0) return 0;
  if (chunk <= 0 || chunk % THREADS != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t chunks = (S + chunk - 1) / chunk;
  if (chunks > MAX_CHUNKS) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid(static_cast<unsigned int>((Q + QBLOCK - 1) / QBLOCK),
                  static_cast<unsigned int>(chunks));
  yukawa_partial_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      queries, points, vectors, reinterpret_cast<typename Kernel<T>::Rec*>(part), Q, S,
      chunk, lam2);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int merge(const T* part, T* out, int64_t Q, int64_t chunks, int normalize, int device,
          void* stream) {
  if (Q <= 0) return 0;
  if (chunks <= 0 || chunks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  yukawa_merge_kernel<T><<<static_cast<unsigned int>((Q + THREADS - 1) / THREADS), THREADS,
                           0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const typename Kernel<T>::Rec*>(part), out, Q,
      static_cast<int>(chunks), normalize);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int field(const T* queries, const T* points, const T* vectors, T* out, T* part, int64_t Q,
          int64_t S, int64_t chunk, T lam2, int normalize, int device, void* stream) {
  const int err = partials<T>(queries, points, vectors, part, Q, S, chunk, lam2, device,
                              stream);
  if (err != 0 || Q <= 0 || S <= 0) return err;
  return merge<T>(part, out, Q, (S + chunk - 1) / chunk, normalize, device, stream);
}

}  // namespace

extern "C" {

// Sources a chunk of the partial kernel holds for Q queries and S sources
// on CUDA device `device` (yukawa::chunk_len).  Returns -1 on a CUDA error.
int64_t shm3d_yukawa_chunk_len(int64_t Q, int64_t S, int device) {
  return yukawa::chunk_len(yukawa_partial_kernel<float>, Q, S, device);
}

// The same for the float64 partial kernel (its own registers, so its own
// occupancy).
int64_t shm3d_yukawa_chunk_len_f64(int64_t Q, int64_t S, int device) {
  return yukawa::chunk_len(yukawa_partial_kernel<double>, Q, S, device);
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
  return partials<float>(queries, points, vectors, part, Q, S, chunk, lam2, device, stream);
}

// float64: the same contract, with float64 arrays, a (ceil(S / chunk), Q)
// array of 32-byte (m, a) records, and chunk from shm3d_yukawa_chunk_len_f64.
int shm3d_yukawa_partials_f64(const double* queries, const double* points,
                              const double* vectors, double* part, int64_t Q, int64_t S,
                              int64_t chunk, double lam2, int device, void* stream) {
  return partials<double>(queries, points, vectors, part, Q, S, chunk, lam2, device, stream);
}

// The merge kernel alone: part (chunks, Q) float4 from any number of
// partial launches over disjoint sources, stacked in the order to merge;
// out (Q, 3) float32 receives X / |X| (normalize = 1) or X.  Same stream
// and error contract as shm3d_yukawa_partials_f32.
int shm3d_yukawa_merge_f32(const float* part, float* out, int64_t Q, int64_t chunks,
                           int normalize, int device, void* stream) {
  return merge<float>(part, out, Q, chunks, normalize, device, stream);
}

// float64: the same contract on float64 records and output.
int shm3d_yukawa_merge_f64(const double* part, double* out, int64_t Q, int64_t chunks,
                           int normalize, int device, void* stream) {
  return merge<double>(part, out, Q, chunks, normalize, device, stream);
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
  return field<float>(queries, points, vectors, out, part, Q, S, chunk, lam2, normalize,
                      device, stream);
}

// float64: the same contract with float64 arrays and scratch of 32-byte
// records (shm3d_yukawa_chunk_len_f64).
int shm3d_yukawa_f64(const double* queries, const double* points,
                     const double* vectors, double* out, double* part, int64_t Q,
                     int64_t S, int64_t chunk, double lam2, int normalize,
                     int device, void* stream) {
  return field<double>(queries, points, vectors, out, part, Q, S, chunk, lam2, normalize,
                       device, stream);
}

const char* shm3d_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
