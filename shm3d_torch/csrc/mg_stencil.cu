// The pin-aware V-cycle's stencil arithmetic on one level of the grid
// (shm3d_torch/solve/multigrid.py), one launch each:
//
// - L u, the mirrored 7-point Laplacian (``stencil.laplacian_apply``);
// - the residual r = b - (H u + w u), H = -L, w = mask * 6 / cell^2
//   (``b - _Hp_apply(u, cell, w)``; no mask: w = 0);
// - a weighted Jacobi sweep u' = u + omega (b - (H u + w u)) / (6 / cell^2
//   + w) (``_jacobi``), from u or from zero; where the level fits one block
//   (ONE_MAX_NODES), all of a level's sweeps in one launch.
//
// A port-only kernel, not the port of a TPU kernel.  shm3d runs the
// V-cycle under jit, where XLA fuses each of these chains; the port ran
// them op by op: 16 elementwise kernels a sweep, each reading and writing
// the whole level (the replicate pad, -6 u, six strided slice-adds, the
// scaling, the penalty, the update), and 40 such sweeps on the coarsest
// level's 512 nodes, where every kernel is launch latency alone.
//
// Every node takes exactly the IEEE operations of the plain ops, in their
// order, so the result is the same to the bit: no contraction into FMAs
// (the _rn intrinsics), the six neighbours added in the order of
// ``laplacian_apply`` (z+1, z-1, y+1, y-1, x+1, x-1, clamped at the faces
// as the replicate pad clamps), and each Python scalar of the plain ops in
// the form ATen's CUDA kernels use it: a factor cast to the tensor's type,
// a division by a scalar a product with its reciprocal, taken in float64
// and cast (the wrapper computes them; Scalars).  Negation is exact.
//
// What bounds it on the card: device-memory bandwidth at the fine levels
// (a sweep or a residual streams u, b and the mask in and one array out:
// 4 x 8.39 MB at 128^3 in float32, 10.0 us at 3.35 TB/s; a Laplacian 2 x
// 8.39 MB), launch latency at the coarse ones.  What the design does about
// it:
//
// - one thread a (y, x) column of BX x BY blocks, marching ZC planes along
//   z with the z neighbours in registers: every array is read once from
//   device memory, the y and x neighbours come from L1, consecutive
//   threads read consecutive addresses;
// - the penalty w and the diagonal 6 / cell^2 + w are formed at each node
//   from the mask, so no level-sized temporaries are written;
// - the coarsest level's sweeps run in one block, u double-buffered in
//   shared memory with a barrier between sweeps: 40 sweeps one launch.
//
// Launches on the caller's stream and allocates nothing, so it is captured
// into CUDA graphs as it is.  Built with nvcc into the kernel library
// (shm3d_torch/_build.py), plain C interface, loaded with ctypes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int LAPLACIAN = 0, RESIDUAL = 1, SWEEP = 2;  // multigrid._OPS
constexpr int BX = 32, BY = 8, ZC = 8;                 // a block's columns and planes
constexpr int ONE_THREADS = 512;
constexpr int ONE_MAX_NODES = 4096;                    // multigrid.ONE_LAUNCH_NODES
constexpr int ONE_PER = ONE_MAX_NODES / ONE_THREADS;   // nodes a thread
constexpr int MAX_N = 4096;

// the plain ops' scalars, as ATen's kernels use them (see above)
template <typename T>
struct Scalars {
  T inv_c2;    // 1 / cell^2: laplacian_apply's division by cell^2
  T pen;       // 6 / cell^2: the penalty's scale and the smoother's diagonal
  T omega;     // the Jacobi weight 2/3
  T inv_diag;  // 1 / (6 / cell^2): the unpinned sweep's division by the diagonal
};

// round-to-nearest arithmetic that the compiler may not contract
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

// L u at a node: -6 u, then the neighbours in laplacian_apply's order
template <typename T>
__device__ __forceinline__ T laplacian_at(T c, T zp, T zm, T yp, T ym, T xp, T xm, T inv_c2) {
  T acc = mul_rn(T(-6), c);
  acc = add_rn(acc, zp);
  acc = add_rn(acc, zm);
  acc = add_rn(acc, yp);
  acc = add_rn(acc, ym);
  acc = add_rn(acc, xp);
  acc = add_rn(acc, xm);
  return mul_rn(acc, inv_c2);
}

// b - (H u + w u) at a node, given L u there: _Hp_apply's -L u, + w * u
template <typename T, bool PINNED>
__device__ __forceinline__ T residual_at(T lu, T c, T b, T m, const Scalars<T>& k) {
  T hp = -lu;
  if constexpr (PINNED) hp = add_rn(hp, mul_rn(mul_rn(m, k.pen), c));
  return sub_rn(b, hp);
}

// u + omega (b - (H u + w u)) / d at a node, d = 6 / cell^2 + w
template <typename T, bool PINNED>
__device__ __forceinline__ T sweep_at(T lu, T c, T b, T m, const Scalars<T>& k) {
  const T t = mul_rn(residual_at<T, PINNED>(lu, c, b, m, k), k.omega);
  T step;
  if constexpr (PINNED) step = div_rn(t, add_rn(mul_rn(m, k.pen), k.pen));
  else step = mul_rn(t, k.inv_diag);
  return add_rn(c, step);
}

template <typename T, int OP, bool PINNED>
__device__ __forceinline__ T node_out(T lu, T c, T b, T m, const Scalars<T>& k) {
  if constexpr (OP == LAPLACIAN) return lu;
  else if constexpr (OP == RESIDUAL) return residual_at<T, PINNED>(lu, c, b, m, k);
  else return sweep_at<T, PINNED>(lu, c, b, m, k);
}

// one op over a level: a thread marches its (y, x) column through ZC
// planes; ZERO: u is zero (the first sweep of a level), and is not read
template <typename T, int OP, bool PINNED, bool ZERO>
__global__ void __launch_bounds__(BX * BY)
level_kernel(const T* __restrict__ u, const T* __restrict__ b, const T* __restrict__ mask,
             T* __restrict__ out, int n, Scalars<T> k) {
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  if (x >= n || y >= n) return;
  const int z0 = blockIdx.z * ZC;
  const int z1 = min(z0 + ZC, n);
  const int64_t plane = static_cast<int64_t>(n) * n;
  // neighbour offsets, 0 where the face clamps
  const int64_t xp = x + 1 < n ? 1 : 0, xm = x > 0 ? -1 : 0;
  const int64_t yp = y + 1 < n ? n : 0, ym = y > 0 ? -static_cast<int64_t>(n) : 0;
  int64_t i = z0 * plane + static_cast<int64_t>(y) * n + x;
  T below = T(0), here = T(0);
  if constexpr (!ZERO) {
    below = u[z0 > 0 ? i - plane : i];
    here = u[i];
  }
  for (int z = z0; z < z1; ++z, i += plane) {
    T above = T(0), lu;
    if constexpr (ZERO) {
      lu = laplacian_at(here, above, below, T(0), T(0), T(0), T(0), k.inv_c2);
    } else {
      above = u[z + 1 < n ? i + plane : i];
      lu = laplacian_at(here, above, below, u[i + yp], u[i + ym], u[i + xp], u[i + xm],
                        k.inv_c2);
    }
    T bi = T(0), mi = T(0);
    if constexpr (OP != LAPLACIAN) bi = b[i];
    if constexpr (PINNED) mi = mask[i];
    out[i] = node_out<T, OP, PINNED>(lu, here, bi, mi, k);
    below = here;
    here = above;
  }
}

// ``sweeps`` Jacobi sweeps over a level of at most ONE_MAX_NODES nodes in
// one block: u (from u0, or zero) double-buffered in shared memory, a
// thread's b and mask in registers, a barrier between sweeps
template <typename T, bool PINNED>
__global__ void __launch_bounds__(ONE_THREADS)
sweeps_kernel(const T* __restrict__ u0, const T* __restrict__ b, const T* __restrict__ mask,
              T* __restrict__ out, int n, int sweeps, Scalars<T> k) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nn = n * n, N = nn * n;
  T* cur = reinterpret_cast<T*>(smem);
  T* nxt = cur + N;
  T bq[ONE_PER], mq[ONE_PER];
  int xyz[ONE_PER];  // x | y << 8 | z << 16 (n <= 16)
#pragma unroll
  for (int q = 0; q < ONE_PER; ++q) {
    const int i = threadIdx.x + q * ONE_THREADS;
    if (i < N) {
      bq[q] = b[i];
      mq[q] = T(0);
      if constexpr (PINNED) mq[q] = mask[i];
      xyz[q] = i % n | (i / n % n) << 8 | (i / nn) << 16;
      cur[i] = u0 != nullptr ? u0[i] : T(0);
    }
  }
  __syncthreads();
  for (int s = 0; s < sweeps; ++s) {
#pragma unroll
    for (int q = 0; q < ONE_PER; ++q) {
      const int i = threadIdx.x + q * ONE_THREADS;
      if (i < N) {
        const int x = xyz[q] & 0xff, y = xyz[q] >> 8 & 0xff, z = xyz[q] >> 16;
        const T c = cur[i];
        const T lu = laplacian_at(c, cur[z + 1 < n ? i + nn : i], cur[z > 0 ? i - nn : i],
                                  cur[y + 1 < n ? i + n : i], cur[y > 0 ? i - n : i],
                                  cur[x + 1 < n ? i + 1 : i], cur[x > 0 ? i - 1 : i], k.inv_c2);
        nxt[i] = sweep_at<T, PINNED>(lu, c, bq[q], mq[q], k);
      }
    }
    __syncthreads();
    T* t = cur;
    cur = nxt;
    nxt = t;
  }
#pragma unroll
  for (int q = 0; q < ONE_PER; ++q) {
    const int i = threadIdx.x + q * ONE_THREADS;
    if (i < N) out[i] = cur[i];
  }
}

template <typename T, int OP, bool PINNED, bool ZERO>
void level(const T* u, const T* b, const T* mask, T* out, int n, const Scalars<T>& k,
           cudaStream_t stream) {
  const dim3 grid((n + BX - 1) / BX, (n + BY - 1) / BY, (n + ZC - 1) / ZC);
  level_kernel<T, OP, PINNED, ZERO><<<grid, dim3(BX, BY), 0, stream>>>(u, b, mask, out, n, k);
}

template <typename T, bool PINNED>
int one_block(const T* u, const T* b, const T* mask, T* out, int n, int sweeps,
              const Scalars<T>& k, cudaStream_t stream) {
  const size_t bytes = 2 * sizeof(T) * n * n * n;
  if (bytes > 48 * 1024) {
    const cudaError_t set = cudaFuncSetAttribute(
        sweeps_kernel<T, PINNED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(2 * sizeof(T) * ONE_MAX_NODES));
    if (set != cudaSuccess) return static_cast<int>(set);
  }
  sweeps_kernel<T, PINNED><<<1, ONE_THREADS, bytes, stream>>>(u, b, mask, out, n, sweeps, k);
  return 0;
}

template <typename T>
int launch(int op, const T* u, const T* b, const T* mask, T* out, int64_t n64, Scalars<T> k,
           int sweeps, int device, void* stream_ptr) {
  if (n64 < 1 || n64 > MAX_N || out == nullptr) return cudaErrorInvalidValue;
  if (op == LAPLACIAN ? (u == nullptr || sweeps != 1)
      : op == RESIDUAL ? (u == nullptr || b == nullptr || sweeps != 1)
      : op == SWEEP ? (b == nullptr || sweeps < 1 || (sweeps > 1 && n64 * n64 * n64 > ONE_MAX_NODES))
      : true)
    return cudaErrorInvalidValue;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int n = static_cast<int>(n64);
  const auto stream = static_cast<cudaStream_t>(stream_ptr);
  const bool pinned = mask != nullptr;
  if (op == LAPLACIAN) {
    level<T, LAPLACIAN, false, false>(u, b, mask, out, n, k, stream);
  } else if (op == RESIDUAL) {
    if (pinned) level<T, RESIDUAL, true, false>(u, b, mask, out, n, k, stream);
    else level<T, RESIDUAL, false, false>(u, b, mask, out, n, k, stream);
  } else if (sweeps > 1) {
    const int err = pinned ? one_block<T, true>(u, b, mask, out, n, sweeps, k, stream)
                           : one_block<T, false>(u, b, mask, out, n, sweeps, k, stream);
    if (err != 0) return err;
  } else if (u == nullptr) {
    if (pinned) level<T, SWEEP, true, true>(u, b, mask, out, n, k, stream);
    else level<T, SWEEP, false, true>(u, b, mask, out, n, k, stream);
  } else {
    if (pinned) level<T, SWEEP, true, false>(u, b, mask, out, n, k, stream);
    else level<T, SWEEP, false, false>(u, b, mask, out, n, k, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One op on an (n, n, n) level of C-order (z, y, x) arrays on CUDA device
// `device`: op 0 out = L u; op 1 out = b - (H u + w u); op 2 `sweeps`
// Jacobi sweeps from u (null: zero), more than one only for n^3 <=
// ONE_MAX_NODES.  mask null: w = 0.  The scalars as the wrapper forms them
// (multigrid._scalars).  Launches one kernel on `stream` and returns
// cudaGetLastError() (0 on success); does not synchronize.
int shm3d_mg_stencil_f32(int op, const float* u, const float* b, const float* mask, float* out,
                         int64_t n, float inv_c2, float pen, float omega, float inv_diag,
                         int sweeps, int device, void* stream) {
  return launch<float>(op, u, b, mask, out, n, Scalars<float>{inv_c2, pen, omega, inv_diag},
                       sweeps, device, stream);
}

// The same on float64 arrays.
int shm3d_mg_stencil_f64(int op, const double* u, const double* b, const double* mask,
                         double* out, int64_t n, double inv_c2, double pen, double omega,
                         double inv_diag, int sweeps, int device, void* stream) {
  return launch<double>(op, u, b, mask, out, n, Scalars<double>{inv_c2, pen, omega, inv_diag},
                        sweeps, device, stream);
}

}  // extern "C"
