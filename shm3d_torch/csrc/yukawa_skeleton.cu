// Speed-of-light probe for the Yukawa kernel (csrc/yukawa.cu) on Hopper:
//
//   out(q) = sum_s exp(-lam |q - p_s|) / |q - p_s|
//
// over every (query, source) pair: only the per-pair work that the Yukawa
// kernel cannot avoid -- the differences, r^2, rsqrt and the exponential --
// and a row sum.  No running reference, no rescale, no vector accumulation.
//
// Replaces the Pallas TPU kernel bench_kernels.py:_skeleton_pallas (its inner
// ``kernel``), which streams (1024-query x 1024-source) tiles through VMEM,
// carries the row sum in scratch across the sequential source axis and needs
// the sources padded to a multiple of 1024 with far points.  What the probe
// is for on this card is the least time that function can take here, so it
// has the Yukawa kernel's launch geometry and none of its bookkeeping:
//
// 1. skeleton_partial_kernel: block (i, k) takes 1024 queries (four a
//    thread, at i*1024 + j*256 + threadIdx.x) against source chunk k, staging
//    256 source points at a time in shared memory as float4; one broadcast
//    load of a staged source serves four pairs.  lam * log2(e) is folded into
//    one constant, so a pair costs one rsqrt and one ex2 (MUFU, both
//    .approx.ftz) and 9 FP32 operations.  Each stage's terms are summed into
//    a partial that is then added to the row sum (one add a stage): a single
//    float32 running sum over ~52k positive terms drifts ~1e-5 from the
//    pairwise sum of the plain version.  The ragged source tail is bounded
//    by S: no padding.  A far row, whose every exp(-lam r) underflows in
//    float32, sums to 0: that is the function (the Yukawa kernel's running
//    reference is what keeps such rows alive).
// 2. skeleton_merge_kernel: one thread a query adds the chunks' partial row
//    sums in chunk order, so the sum is deterministic.  A launch of one
//    chunk writes its row sums straight to the output.
//
// The chunk length is the Yukawa kernel's rule (yukawa::chunk_len) with this
// kernel's occupancy: it fills the card where 36 or 207 query blocks would
// leave most of the 132 SMs idle or run one ragged wave.
//
// What bounds it on the card: two special-function (MUFU) operations per
// pair; 132 SMs x 16 MUFU results per clock give ~2.1e12 pairs/s at
// 1.98 GHz.  The FP32 work and the bytes (q and out once, p once per block
// from L2) are below that.  So the time of the Yukawa kernel over the time
// of this probe reads the Yukawa kernel's bookkeeping.  The kernel is a
// yardstick, not part of any solve.
//
// Built with nvcc into a shared library with a plain C interface, loaded
// with ctypes by shm3d_torch/_build.py.

#include "yukawa_common.cuh"

namespace {

using namespace yukawa;

__global__ void __launch_bounds__(THREADS)
skeleton_partial_kernel(const float* __restrict__ q, const float* __restrict__ p,
                        float* __restrict__ part, int64_t Q, int64_t S,
                        int64_t chunk, float nlam2) {
  __shared__ float4 sp[THREADS];

  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * QBLOCK + threadIdx.x;
  const int64_t s_begin = static_cast<int64_t>(blockIdx.y) * chunk;
  const int64_t s_end = S - s_begin < chunk ? S : s_begin + chunk;
  // a warp whose queries all lie past Q only helps stage the sources
  const bool live = __any_sync(0xffffffffu, q0 < Q);

  float qx[QPT], qy[QPT], qz[QPT], acc[QPT];
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int64_t i = q0 + j * THREADS;
    qx[j] = i < Q ? q[3 * i] : 0.f;
    qy[j] = i < Q ? q[3 * i + 1] : 0.f;
    qz[j] = i < Q ? q[3 * i + 2] : 0.f;
    acc[j] = 0.f;
  }

  for (int64_t s0 = s_begin; s0 < s_end; s0 += THREADS) {
    const int cnt = static_cast<int>(s_end - s0 < THREADS ? s_end - s0 : THREADS);
    __syncthreads();  // the previous stage has been read by every thread
    if (threadIdx.x < cnt) {
      const int64_t s = s0 + threadIdx.x;
      sp[threadIdx.x] = make_float4(p[3 * s], p[3 * s + 1], p[3 * s + 2], 0.f);
    }
    __syncthreads();
    if (!live) continue;

    float part_sum[QPT];
#pragma unroll
    for (int j = 0; j < QPT; ++j) part_sum[j] = 0.f;
#pragma unroll 2
    for (int k = 0; k < cnt; ++k) {
      const float4 P = sp[k];
#pragma unroll
      for (int j = 0; j < QPT; ++j) {
        const float r2 = dist2(P.x - qx[j], P.y - qy[j], P.z - qz[j]);
        const float inv = rsqrt_approx(r2);
        // exp(-lam r) / r, the exponent in log2 units
        part_sum[j] = fmaf(ex2_approx(nlam2 * (r2 * inv)), inv, part_sum[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < QPT; ++j) acc[j] += part_sum[j];
  }

  float* out = part + static_cast<int64_t>(blockIdx.y) * Q;
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int64_t i = q0 + j * THREADS;
    if (i < Q) out[i] = acc[j];
  }
}

__global__ void __launch_bounds__(THREADS)
skeleton_merge_kernel(const float* __restrict__ part, float* __restrict__ out,
                      int64_t Q, int chunks) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= Q) return;
  float acc = 0.f;
  for (int k = 0; k < chunks; ++k) acc += part[k * Q + i];
  out[i] = acc;
}

}  // namespace

extern "C" {

// Sources a chunk of the probe's partial kernel holds for Q queries and S
// sources on CUDA device `device` (yukawa::chunk_len).  Returns -1 on a
// CUDA error.
int64_t shm3d_yukawa_skeleton_chunk_len(int64_t Q, int64_t S, int device) {
  return yukawa::chunk_len(skeleton_partial_kernel, Q, S, device);
}

// queries (Q, 3), points (S, 3), out (Q,): contiguous float32 arrays on CUDA
// device `device`; part: (ceil(S / chunk), Q) float32 scratch (not read when
// S <= chunk), chunk a multiple of 256 (shm3d_yukawa_skeleton_chunk_len).
// Launches the partial kernel and, for more than one chunk, the merge kernel
// on `stream` and returns cudaGetLastError() (0 on success); does not
// synchronize.
int shm3d_yukawa_skeleton_f32(const float* queries, const float* points,
                              float* out, float* part, int64_t Q, int64_t S,
                              int64_t chunk, float lam, int device,
                              void* stream) {
  if (Q <= 0 || S <= 0) return 0;
  if (chunk <= 0 || chunk % THREADS != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t chunks = (S + chunk - 1) / chunk;
  if (chunks > MAX_CHUNKS) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned int>((Q + QBLOCK - 1) / QBLOCK),
                  static_cast<unsigned int>(chunks));
  skeleton_partial_kernel<<<grid, THREADS, 0, st>>>(
      queries, points, chunks == 1 ? out : part, Q, S, chunk, -lam * LOG2E);
  const cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess || chunks == 1) return static_cast<int>(launched);
  skeleton_merge_kernel<<<static_cast<unsigned int>((Q + THREADS - 1) / THREADS), THREADS,
                          0, st>>>(part, out, Q, static_cast<int>(chunks));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
