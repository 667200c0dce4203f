// Products with a lower-triangular factor held as packed tiles: y = T x and
// z = T^T x, one launch each, for the full-row projector of
// shm3d_torch/solve/projection.py (``project_t``: four products a
// projection).
//
// A port-only kernel, not the port of a TPU kernel.  shm3d applies its
// whitening factor T = L^-1 D^-1/2 with two dense matmuls over the whole
// (m, m) square (shm3d/solve/projection.py: make_projector), and so did the
// port through cuBLAS.  T inverts a lower Cholesky factor, so its strict
// upper triangle is zero: the square streams twice the bytes the product
// needs (987 MB against 493 MB a product at m = 15,706) and holds 0.49 GB of
// zeros on the card.
//
// Layout (``projection.tri_pack``): square tiles of TILE x TILE floats,
// row-major inside a tile; tile (I, J), J <= I, at I (I + 1) / 2 + J, so a
// tile row is contiguous.  Diagonal tiles keep their zero upper half and
// the last tile row and column are zero-padded past m.  nb = ceil(m / TILE)
// tile rows, nb (nb + 1) / 2 tiles.
//
// What bounds it on the card: device-memory bandwidth.  Each product reads
// every stored tile once (4 bytes a float, 0.498 GB at m = 15,706: 0.149 ms
// at 3.35 TB/s) and the two vectors; x stays in L2.  No tensor cores: a
// matrix-vector product does 2 operations a 4-byte element.  What the
// design does about it:
//
// - work units of equal size: tile row r and tile row nb - 1 - r together
//   (nb + 1 tiles) in one block for y = T x, tile column c and nb - 1 - c
//   for z = T^T x; ceil(nb / 2) blocks, 123 at m = 15,706, one an SM;
// - every tile is read once, 16 bytes a thread, consecutive threads on
//   consecutive addresses, streamed past L1 and marked evict-first in L2
//   (__ldcs), so the vectors keep their lines;
// - enough bytes in flight: a thread loads a batch of BATCH tiles into
//   registers (2 float4 a tile) while it computes on the previous batch,
//   two batches in flight a block: up to 128 KB an SM;
// - fixed summation order and no atomics: a thread sums its products over
//   the unit's tiles in tile order; the partial sums of a row (y) meet in a
//   butterfly over the 16 lanes that share it, those of a column (z) in a
//   butterfly over the two half-warps and then in warp order through
//   shared memory.  Each output element is written by one thread once, so
//   repeated calls give the same bits.
//
// Launches on the caller's stream and allocates nothing, so it is captured
// into CUDA graphs as it is.  Built with nvcc into the kernel library
// (shm3d_torch/_build.py), plain C interface, loaded with ctypes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;                        // tile side (projection.TRI_TILE)
constexpr int THREADS = 512;                    // 16 warps
constexpr int V4_TILE = TILE * TILE / 4;        // float4s a tile: 1024
constexpr int PER = V4_TILE / THREADS;          // float4s a thread a tile: 2
constexpr int ROW_STEP = THREADS / (TILE / 4);  // tile rows between a thread's float4s: 32
constexpr int BATCH = 4;                        // tiles a batch
constexpr int WARPS = THREADS / 32;

// the unit's k-th tile: which of its two rows or columns (s), and the
// tile's index in the packed buffer and in the other dimension (for y = T x
// the tile column J, for z = T^T x the tile row I)
struct Unit {
  int nb, a, b, na, n;

  __device__ Unit(int nb_, int p, bool trans) : nb(nb_), a(p), b(nb_ - 1 - p) {
    na = trans ? nb - a : a + 1;
    const int nbb = b == a ? 0 : (trans ? nb - b : b + 1);
    n = na + nbb;
  }

  __device__ __forceinline__ void tile(int k, bool trans, int& s, int64_t& off,
                                       int& other) const {
    s = k >= na;
    const int j = s ? k - na : k;
    const int line = s ? b : a;
    if (trans) {
      other = line + j;  // tile row I >= line, tile column `line`
      off = static_cast<int64_t>(other) * (other + 1) / 2 + line;
    } else {
      other = j;  // tile column J <= line, tile row `line`
      off = static_cast<int64_t>(line) * (line + 1) / 2 + j;
    }
  }
};

__device__ __forceinline__ void load_batch(float4 (&buf)[BATCH][PER],
                                           const float4* __restrict__ tiles,
                                           const Unit& u, int k0, bool trans) {
#pragma unroll
  for (int t = 0; t < BATCH; ++t) {
    const int k = k0 + t;
    if (k < u.n) {
      int s, other;
      int64_t off;
      u.tile(k, trans, s, off, other);
      const float4* src = tiles + off * V4_TILE + threadIdx.x;
#pragma unroll
      for (int q = 0; q < PER; ++q) buf[t][q] = __ldcs(src + q * THREADS);
    }
  }
}

// x[i..i+3], zero past m
__device__ __forceinline__ float4 x_chunk(const float* __restrict__ x, int i, int m) {
  if (i + 4 <= m) return __ldg(reinterpret_cast<const float4*>(x + i));
  float4 v;
  v.x = i < m ? __ldg(x + i) : 0.f;
  v.y = i + 1 < m ? __ldg(x + i + 1) : 0.f;
  v.z = i + 2 < m ? __ldg(x + i + 2) : 0.f;
  v.w = i + 3 < m ? __ldg(x + i + 3) : 0.f;
  return v;
}

// y = T x: thread t holds columns 4 c .. 4 c + 3 (c = t % 16) of tile rows
// t / 16 + 32 q, and sums each row's dot products over the tiles of the
// unit's two tile rows
__device__ __forceinline__ void mv_batch(const float4 (&buf)[BATCH][PER],
                                         const float* __restrict__ x, const Unit& u,
                                         int k0, int m, float (&acc)[2][PER]) {
  const int c = threadIdx.x % (TILE / 4);
#pragma unroll
  for (int t = 0; t < BATCH; ++t) {
    const int k = k0 + t;
    if (k < u.n) {
      int s, J;
      int64_t off;
      u.tile(k, false, s, off, J);
      const float4 xv = x_chunk(x, J * TILE + 4 * c, m);
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const float4 e = buf[t][q];
        const float d = e.x * xv.x + e.y * xv.y + e.z * xv.z + e.w * xv.w;
        if (s) acc[1][q] += d; else acc[0][q] += d;
      }
    }
  }
}

// z = T^T x: thread t sums column chunk c of its two tile rows, weighted by
// x at those rows, over the tiles of the unit's two tile columns
__device__ __forceinline__ void tmv_batch(const float4 (&buf)[BATCH][PER],
                                          const float* __restrict__ x, const Unit& u,
                                          int k0, int m, float4 (&acc)[2]) {
  const int r = threadIdx.x / (TILE / 4);
#pragma unroll
  for (int t = 0; t < BATCH; ++t) {
    const int k = k0 + t;
    if (k < u.n) {
      int s, I;
      int64_t off;
      u.tile(k, true, s, off, I);
      float4 a = s ? acc[1] : acc[0];
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const int i = I * TILE + r + q * ROW_STEP;
        const float w = i < m ? __ldg(x + i) : 0.f;
        const float4 e = buf[t][q];
        a.x += e.x * w;
        a.y += e.y * w;
        a.z += e.z * w;
        a.w += e.w * w;
      }
      if (s) acc[1] = a; else acc[0] = a;
    }
  }
}

template <bool TRANS>
__global__ void __launch_bounds__(THREADS, 1)
tri_gemv_kernel(const float4* __restrict__ tiles, const float* __restrict__ x,
                float* __restrict__ y, int m, int nb) {
  const Unit u(nb, blockIdx.x, TRANS);
  float4 buf0[BATCH][PER], buf1[BATCH][PER];
  float acc_mv[2][PER] = {};
  float4 acc_tmv[2] = {};

  // two batches in flight: the next one loads while this one is summed
  load_batch(buf0, tiles, u, 0, TRANS);
  for (int k0 = 0; k0 < u.n; k0 += 2 * BATCH) {
    load_batch(buf1, tiles, u, k0 + BATCH, TRANS);
    if (TRANS) tmv_batch(buf0, x, u, k0, m, acc_tmv);
    else mv_batch(buf0, x, u, k0, m, acc_mv);
    load_batch(buf0, tiles, u, k0 + 2 * BATCH, TRANS);
    if (TRANS) tmv_batch(buf1, x, u, k0 + BATCH, m, acc_tmv);
    else mv_batch(buf1, x, u, k0 + BATCH, m, acc_mv);
  }

  const int lanes = u.b == u.a ? 1 : 2;
  if (!TRANS) {
    // a row's 16 partial sums sit in the 16 lanes of a half-warp
    const int c = threadIdx.x % (TILE / 4);
    const int r = threadIdx.x / (TILE / 4);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        float v = acc_mv[s][q];
#pragma unroll
        for (int d = TILE / 8; d >= 1; d /= 2) v += __shfl_xor_sync(0xffffffffu, v, d);
        const int i = (s ? u.b : u.a) * TILE + r + q * ROW_STEP;
        if (s < lanes && c == 0 && i < m) y[i] = v;
      }
    }
    return;
  }

  // a column chunk's partial sums: lanes l and l + 16 of each warp, then
  // the 16 warps in order
  __shared__ float4 red[2][WARPS][TILE / 4];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    float4 v = acc_tmv[s];
    v.x += __shfl_xor_sync(0xffffffffu, v.x, 16);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, 16);
    v.z += __shfl_xor_sync(0xffffffffu, v.z, 16);
    v.w += __shfl_xor_sync(0xffffffffu, v.w, 16);
    if (lane < TILE / 4) red[s][warp][lane] = v;
  }
  __syncthreads();
  if (threadIdx.x < 2 * TILE) {
    const int s = threadIdx.x / TILE;
    const int j = threadIdx.x % TILE;
    const float* part = reinterpret_cast<const float*>(&red[s][0][0]) + j;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) v += part[w * TILE];
    const int i = (s ? u.b : u.a) * TILE + j;
    if (s < lanes && i < m) y[i] = v;
  }
}

template <bool TRANS>
int launch(const float* tiles, const float* x, float* y, int64_t m, int64_t tile,
           int device, void* stream) {
  if (tile != TILE || m <= 0 || m > (int64_t{1} << 30)) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(tiles) % 16 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return cudaErrorMisalignedAddress;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int nb = static_cast<int>((m + TILE - 1) / TILE);
  const int units = (nb + 1) / 2;
  tri_gemv_kernel<TRANS><<<units, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(tiles), x, y, static_cast<int>(m), nb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// y = T x for T (m, m) lower triangular in packed tiles of side `tile`
// (which must be TILE), x and y (m,) float32, on CUDA device `device`.
// tiles and x 16-byte aligned.  Launches one kernel on `stream` and
// returns cudaGetLastError() (0 on success); does not synchronize.
int shm3d_tri_gemv_n_f32(const float* tiles, const float* x, float* y, int64_t m,
                         int64_t tile, int device, void* stream) {
  return launch<false>(tiles, x, y, m, tile, device, stream);
}

// z = T^T x; the rest as shm3d_tri_gemv_n_f32.
int shm3d_tri_gemv_t_f32(const float* tiles, const float* x, float* z, int64_t m,
                         int64_t tile, int device, void* stream) {
  return launch<true>(tiles, x, z, m, tile, device, stream);
}

}  // extern "C"
