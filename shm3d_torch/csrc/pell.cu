// Paged-ELL SpMV on Hopper: y = P x over the pass-packed operator of
// shm3d_torch/solve/pell.py.
//
// Replaces the Pallas TPU kernel shm3d/solve/pell.py:_pipe_kernel.  The
// operator is a stream of passes; a pass pairs one output tile (1024 rows)
// with one source page (1024 entries of x) and holds at most one entry per
// row: slot s of the pass is row (tile * 1024 + s), with value vals[s] and
// column (page * 1024 + idx[s]).  Passes are sorted by tile.  The TPU kernel
// walks them in one sequential loop, double-buffering values, indices and
// meta words through manual DMA, prefetching x pages eight deep and doing
// the in-page gather as an 8-sublane select, and flushes its VMEM
// accumulator tile on every tile change.  Those all answer TPU problems
// (no fast random gather, a sequential grid).  Here:
//
// - one block per output tile, its pass range [tile_ptr[t], tile_ptr[t+1])
//   computed on the host at upload (the passes of a tile are contiguous);
// - 256 threads, each owning four consecutive rows: it reads the pass's
//   values and indices as one float4 and one int4 (the block reads 8 KB per
//   pass, fully coalesced, streamed past L1), keeps its four sums in
//   registers, and gathers x[page * 1024 + idx] through the read-only path
//   only for occupied slots (value != 0; ~16% of slots on the CR operators);
// - each row is written once, by its thread, with no atomics.
//
// What bounds it on the card: device-memory bandwidth.  Every pass streams
// 8 KB of values and indices whatever its occupancy (the knot_dec CR face
// operator: ~97k passes, ~0.8 GB per matvec); the x gathers mostly hit L2,
// since a tile's pages are few and neighbouring tiles share them under the
// Morton face order.  Each block's pass loop is a chain of dependent loads,
// so latency, not bandwidth, bounds a tile with few passes.  A denser
// layout for Hopper (CSR or sliced ELL, ~0.13 GB at the same nnz) is later
// work.
//
// Built with nvcc into a shared library with a plain C interface, loaded
// with ctypes by shm3d_torch/_build.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int PAGE = 1024;                 // rows per tile, entries per page
constexpr int THREADS = PAGE / 4;          // four rows per thread
constexpr int PAGE_MASK = (1 << 20) - 1;   // meta word: local_tile << 20 | page

__global__ void __launch_bounds__(THREADS)
pell_kernel(const float4* __restrict__ vals, const int4* __restrict__ idx,
            const int* __restrict__ meta, const int64_t* __restrict__ tile_ptr,
            const float* __restrict__ x, float4* __restrict__ y) {
  const int64_t tile = blockIdx.x;
  const int64_t p0 = tile_ptr[tile];
  const int64_t p1 = tile_ptr[tile + 1];
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 2
  for (int64_t p = p0; p < p1; ++p) {
    // slot offsets in 64 bits: a large operator exceeds 2^31 slots
    const int64_t slot = p * THREADS + threadIdx.x;
    const float* xp = x + static_cast<int64_t>(__ldg(meta + p) & PAGE_MASK) * PAGE;
    const float4 v = __ldcs(vals + slot);
    const int4 c = __ldcs(idx + slot);
    if (v.x != 0.f) a0 = fmaf(v.x, __ldg(xp + c.x), a0);
    if (v.y != 0.f) a1 = fmaf(v.y, __ldg(xp + c.y), a1);
    if (v.z != 0.f) a2 = fmaf(v.z, __ldg(xp + c.z), a2);
    if (v.w != 0.f) a3 = fmaf(v.w, __ldg(xp + c.w), a3);
  }
  y[tile * THREADS + threadIdx.x] = make_float4(a0, a1, a2, a3);
}

}  // namespace

extern "C" {

// One segment of a paged operator on CUDA device `device`: vals (T, 1024)
// float32, idx (T, 1024) int32, meta (T,) int32, tile_ptr (n_tiles + 1,)
// int64, x the source vector, y the segment's first output row (n_tiles *
// 1024 floats are written).  All pointers 16-byte aligned.  Launches on
// `stream` and returns cudaGetLastError() (0 on success); does not
// synchronize.
int shm3d_pell_f32(const float* vals, const int* idx, const int* meta,
                   const int64_t* tile_ptr, const float* x, float* y,
                   int64_t n_tiles, int device, void* stream) {
  if (n_tiles <= 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  pell_kernel<<<static_cast<unsigned int>(n_tiles), THREADS, 0,
                static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(vals), reinterpret_cast<const int4*>(idx),
      meta, tile_ptr, x, reinterpret_cast<float4*>(y));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
