// Sliced-ELL SpMV on Hopper: y = S x over the SellMat of
// shm3d_torch/solve/pell.py.
//
// The port of the Pallas TPU kernel shm3d/solve/pell.py:_pipe_kernel.  The
// TPU kernel walks a pass-packed operator (each pass one 1024-row output
// tile against one 1024-entry page of x, at most one entry a row) in one
// sequential loop, double-buffering values, indices and meta words through
// manual DMA and doing the in-page gather as an 8-sublane select.  That
// layout answers the TPU's slow random gathers.  On the card it streams
// every slot of every pass whatever its occupancy: ~16% of the slots hold
// an entry on the Crouzeix-Raviart face operators, so the paged kernel
// moved 0.744 GB a matvec on knot_dec for a product that needs 0.143 GB.
// The host keeps the paged form (the JAX package's artifact); the upload
// turns it into sliced ELL:
//
// - slices of 32 rows (one warp), rows in their Morton order (no sorting);
//   slice s holds its rows in a (w_s, 32) panel at slice_ptr[s], slot j of
//   row l at slice_ptr[s] + 32 j + l, w_s the slice's longest row;
// - each row's entries in ascending column order; padding slots have value
//   0 and repeat a column of their row.
//
// The kernel runs one thread per row.  A warp walks its slice's panel with
// coalesced 128-byte loads of values and columns, streamed past L1
// (__ldcs), gathers x through the read-only path for every nonzero slot and
// sums a = fmaf(v, x[c], a) from 0 in slot order -- the arithmetic and the
// order of the paged kernel, which visits a row's entries page by page,
// then by multiplicity, that is in ascending column order.  So y is bitwise
// the paged kernel's.  Each row is written once by its thread: no atomics,
// and one launch a matvec.
//
// What bounds it on the card: device-memory bandwidth, 8 bytes a slot
// (value and column) plus x and y once.  x (9 MB on knot_dec) stays in the
// 50 MB L2, and the Morton order keeps a slice's gathers on few lines.  No
// tensor cores: there is no dense product here.  No TMA: TMA copies tiles
// and cannot gather x, and the panel stream is already coalesced; what
// keeps the card busy is enough independent loads in flight, which the
// unrolled slot loop and one thread a row (70k warps on knot_dec) give.
//
// Built with nvcc into a shared library with a plain C interface, loaded
// with ctypes by shm3d_torch/_build.py.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int SLICE = 32;     // rows per slice, one warp
constexpr int THREADS = 256;  // eight slices a block

__global__ void __launch_bounds__(THREADS)
sell_kernel(const float* __restrict__ vals, const int* __restrict__ cols,
            const int64_t* __restrict__ slice_ptr, const float* __restrict__ x,
            float* __restrict__ y, int64_t n_slices) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  const int64_t s = row / SLICE;
  if (s >= n_slices) return;
  // slot offsets in 64 bits: a large operator exceeds 2^31 slots
  const int64_t p0 = slice_ptr[s] + (row % SLICE);
  const int64_t p1 = slice_ptr[s + 1];
  float a = 0.f;
#pragma unroll 4
  for (int64_t p = p0; p < p1; p += SLICE) {
    const float v = __ldcs(vals + p);
    const int c = __ldcs(cols + p);
    if (v != 0.f) a = fmaf(v, __ldg(x + c), a);
  }
  y[row] = a;
}

}  // namespace

extern "C" {

// A SellMat on CUDA device `device`: vals and cols (n_slots,) float32 and
// int32, slice_ptr (n_slices + 1,) int64, x the source vector, y the
// output (n_slices * 32 floats are written; rows past the matrix's are 0).
// Launches on `stream` and returns cudaGetLastError() (0 on success); does
// not synchronize.
int shm3d_sell_f32(const float* vals, const int* cols, const int64_t* slice_ptr,
                   const float* x, float* y, int64_t n_slices, int device,
                   void* stream) {
  if (n_slices <= 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int64_t blocks = (n_slices * SLICE + THREADS - 1) / THREADS;
  sell_kernel<<<static_cast<unsigned int>(blocks), THREADS, 0,
                static_cast<cudaStream_t>(stream)>>>(vals, cols, slice_ptr, x, y,
                                                     n_slices);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
