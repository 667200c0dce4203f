// The Krylov loops' stop test on the device, and the conditional graphs
// that run a solve's iterations under it: one thread, launched on the
// current stream, inside the CUDA graphs of shm3d_torch/solve/graphs.py.
//
// A port-only kernel, not the port of a TPU kernel.  shm3d runs each Krylov
// solve as one compiled program whose stop test is the cond of a
// lax.while_loop on the device (shm3d/solve/krylov.py: cg, minres).  The
// port runs the loop as one graph: a WHILE conditional node whose body is
// one iteration (a graph captured by torch) ending in this kernel, which
// reads the iteration's scalars, updates the stop state, writes the bool
// predicate `go` and sets the WHILE node's condition to go.  A small kernel
// before the node (chunk_start_kernel) sets the condition from go, so a
// solve that stopped in its setup runs no iteration.  The host reads the
// state once, after the loop.  MINRES's iteration 0 (its own body) runs
// under an IF node of a graph of its own, built the same way.
//
// The arithmetic is the port's host test (shm3d_torch/solve/krylov.py: cg
// and minres), not shm3d's float32 cond, so a graphed solve stops where the
// eager loop does, bit for bit:
//
//   CG:      rn = sqrt(|(double) rz|)
//            since = rn < 0.98 * best ? 0 : since + 1
//            best = rn < best ? rn : best          (Python's min(best, rn))
//            k += 1
//            go = rn > threshold && k < maxiter && since < window
//   MINRES:  k += 1
//            go = (double) phibar > threshold && k < maxiter && (double) beta > 0
//
// With `start` set the kernel writes the state before the first iteration
// instead (k = 0, best = rn, since = 0) and the threshold:
//   CG:      rhs = sqrt(|(double) bmb|) (or the host's rhs_mnorm), threshold =
//            tol * max(rhs, tiny), in double as Python computes it;
//   MINRES:  threshold = (double) (tol * clamp_min(ref, tiny)) in the vectors'
//            precision, as torch computes it there, widened exactly.
// tol, maxiter, window and tiny are slots of the state that the host writes
// before each solve, never constants of a graph: one graph serves solves of
// other tolerances and iteration caps.
//
// Every operation is an explicit round-to-nearest intrinsic (__dsqrt_rn,
// __dmul_rn, __fmul_rn), so no multiply is contracted into anything else,
// whatever nvcc's -fmad setting.  What bounds it: launch latency (one
// thread, a few loads and stores); as torch ops the same test would be
// about twelve launches an iteration.
//
// The conditional node is written by hand (cudaGraphConditionalHandleCreate,
// cudaGraphAddNode with cudaGraphCondTypeWhile or cudaGraphCondTypeIf,
// cudaGraphSetConditional in the kernels): the torch on the card has no
// conditional-node API.  The body is cloned into the node as a child graph,
// so its tensors keep the addresses of torch's capture, in that capture's
// memory pool.
//
// Built with nvcc into the kernel library (shm3d_torch/_build.py), plain C
// interface, loaded with ctypes.  shm3d_graph_node_counts counts the nodes
// and the conditional nodes of a graph (cudaGraphGetNodes and libcuda's
// cuGraphNodeGetType: the runtime of a toolkit older than the installed
// libcuda cannot name a conditional node), so a graph that lost its
// conditional node is caught.  A failed runtime call clears the runtime's
// last error before it returns, so the next launch's cudaGetLastError() is
// its own.

#include <cstdint>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <vector>

namespace {

// slots of the float64 stop state (shm3d_torch/solve/stop.py: the same
// names); MINRES keeps phibar in RN and beta in BEST
enum Slot { TOL = 0, MAXITER, WINDOW, TINY, RHS, THR, RN, BEST, SINCE, K, GO, NSLOTS };

// the condition of the loop's WHILE node: the solve goes on (`use` 0: not
// inside a WHILE body, no condition)
__device__ __forceinline__ void set_condition(cudaGraphConditionalHandle handle, int use,
                                              bool g) {
  if (use) cudaGraphSetConditional(handle, g ? 1u : 0u);
}

// the first node of a chunk graph: its conditional node's condition from go
__global__ void chunk_start_kernel(cudaGraphConditionalHandle handle, const bool* go) {
  cudaGraphSetConditional(handle, *go ? 1u : 0u);
}

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

template <typename T>
__global__ void cg_stop_kernel(const T* __restrict__ rz, const T* __restrict__ bmb,
                               double* __restrict__ st, bool* __restrict__ go, int start,
                               cudaGraphConditionalHandle handle, int use) {
  const double rn = __dsqrt_rn(fabs(static_cast<double>(*rz)));
  double best, since, k;
  if (start) {
    if (bmb != nullptr) st[RHS] = __dsqrt_rn(fabs(static_cast<double>(*bmb)));
    const double rhs = st[RHS];
    const double floor = st[TINY] > rhs ? st[TINY] : rhs;  // Python's max(rhs, tiny)
    st[THR] = __dmul_rn(st[TOL], floor);
    best = rn;
    since = 0.0;
    k = 0.0;
  } else {
    const double prev = st[BEST];
    since = rn < __dmul_rn(0.98, prev) ? 0.0 : __dadd_rn(st[SINCE], 1.0);
    best = rn < prev ? rn : prev;
    k = __dadd_rn(st[K], 1.0);
  }
  const bool g = rn > st[THR] && k < st[MAXITER] && since < st[WINDOW];
  st[RN] = rn;
  st[BEST] = best;
  st[SINCE] = since;
  st[K] = k;
  st[GO] = g ? 1.0 : 0.0;
  *go = g;
  set_condition(handle, use, g);
}

template <typename T>
__global__ void minres_stop_kernel(const T* __restrict__ phibar, const T* __restrict__ beta,
                                   const T* __restrict__ ref, double* __restrict__ st,
                                   bool* __restrict__ go, int start,
                                   cudaGraphConditionalHandle handle, int use) {
  double k;
  if (start) {
    const T tiny = static_cast<T>(st[TINY]);
    const T r = *ref;
    const T floor = isnan(r) ? r : (r > tiny ? r : tiny);  // torch.clamp_min
    st[THR] = static_cast<double>(mul_rn(static_cast<T>(st[TOL]), floor));
    k = 0.0;
  } else {
    k = __dadd_rn(st[K], 1.0);
  }
  const double pb = static_cast<double>(*phibar);
  const double bt = static_cast<double>(*beta);
  const bool g = pb > st[THR] && k < st[MAXITER] && bt > 0.0;
  st[RN] = pb;
  st[BEST] = bt;
  st[K] = k;
  st[GO] = g ? 1.0 : 0.0;
  *go = g;
  set_condition(handle, use, g);
}

template <typename T>
int cg_stop(const T* rz, const T* bmb, double* st, bool* go, int start,
            unsigned long long handle, int use, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cg_stop_kernel<T><<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(rz, bmb, st, go, start,
                                                                      handle, use);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int minres_stop(const T* phibar, const T* beta, const T* ref, double* st, bool* go,
                int start, unsigned long long handle, int use, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  minres_stop_kernel<T><<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      phibar, beta, ref, st, go, start, handle, use);
  return static_cast<int>(cudaGetLastError());
}

// a failed runtime call's error, cleared from the runtime's last error (so
// a later launch's cudaGetLastError() does not report it again), plus 1000
// times the step that failed
int failed(int step, cudaError_t err) {
  cudaGetLastError();
  return 1000 * step + static_cast<int>(err);
}

// libcuda's cuGraphNodeGetType (CUresult (CUgraphNode, CUgraphNodeType*)),
// from the libcuda.so.1 the process has loaded
typedef int (*NodeGetType)(cudaGraphNode_t, int*);
constexpr int CU_GRAPH_NODE_TYPE_CONDITIONAL = 13;

NodeGetType libcuda_node_type() {
  static NodeGetType fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr) fn = reinterpret_cast<NodeGetType>(dlsym(lib, "cuGraphNodeGetType"));
  }
  return fn;
}

}  // namespace

extern "C" {

// CG's stop test on CUDA device `device`: rz the 0-dim r.z of the
// iteration (float32 or float64), st the (NSLOTS,) float64 stop state, go
// the bool predicate.  With start != 0: the state before the first
// iteration, rz then being the first residual's; bmb (r.z of the right-hand
// side, for rhs_mnorm) may be null, and st[RHS] is then the host's.  With
// use != 0 the launch also sets the condition `handle` of the chunk graph
// it is captured into (shm3d_chunk_graph_create).  Launches on `stream` and
// returns cudaGetLastError() (0 on success); does not synchronize.
int shm3d_cg_stop_f32(const float* rz, const float* bmb, double* st, bool* go, int start,
                      unsigned long long handle, int use, int device, void* stream) {
  return cg_stop<float>(rz, bmb, st, go, start, handle, use, device, stream);
}

int shm3d_cg_stop_f64(const double* rz, const double* bmb, double* st, bool* go, int start,
                      unsigned long long handle, int use, int device, void* stream) {
  return cg_stop<double>(rz, bmb, st, go, start, handle, use, device, stream);
}

// MINRES's stop test: phibar and beta the 0-dim scalars of the iteration,
// ref (read only with start != 0) the reference norm of the threshold; the
// rest as shm3d_cg_stop_f32.
int shm3d_minres_stop_f32(const float* phibar, const float* beta, const float* ref,
                          double* st, bool* go, int start, unsigned long long handle,
                          int use, int device, void* stream) {
  return minres_stop<float>(phibar, beta, ref, st, go, start, handle, use, device, stream);
}

int shm3d_minres_stop_f64(const double* phibar, const double* beta, const double* ref,
                          double* st, bool* go, int start, unsigned long long handle,
                          int use, int device, void* stream) {
  return minres_stop<double>(phibar, beta, ref, st, go, start, handle, use, device, stream);
}

// A new empty graph (the chunk graph) and the condition handle of its
// conditional node, default 0, on CUDA device `device`.  Returns the first
// error.
int shm3d_chunk_graph_create(void** graph, unsigned long long* handle, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return failed(0, err);
  cudaGraph_t g = nullptr;
  err = cudaGraphCreate(&g, 0);
  if (err != cudaSuccess) return failed(0, err);
  cudaGraphConditionalHandle h = 0;
  err = cudaGraphConditionalHandleCreate(&h, g, 0, 0);
  if (err != cudaSuccess) {
    cudaGraphDestroy(g);
    return failed(0, err);
  }
  *graph = g;
  *handle = h;
  return 0;
}

// Fill the chunk graph: chunk_start_kernel (the condition from go), then a
// conditional node on `handle` whose body is a clone of `body`: a WHILE node
// (loop != 0; `body` one iteration whose stop kernel sets `handle`) or an
// IF node (loop == 0; `body` runs once if go).  Instantiate it into *exec.
// Returns the first error.
int shm3d_chunk_graph_build(void* graph, unsigned long long handle, void* body,
                            const bool* go, int loop, void** exec) {
  const cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  cudaGraphConditionalHandle h = handle;
  void* args[] = {&h, &go};
  cudaKernelNodeParams kp = {};
  kp.func = reinterpret_cast<void*>(chunk_start_kernel);
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(1);
  kp.sharedMemBytes = 0;
  kp.kernelParams = args;
  kp.extra = nullptr;
  cudaGraphNode_t setter = nullptr;
  cudaError_t err = cudaGraphAddKernelNode(&setter, g, nullptr, 0, &kp);
  if (err != cudaSuccess) return failed(0, err);
  cudaGraphNodeParams cp = {};
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.handle = h;
  cp.conditional.type = loop ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  cp.conditional.size = 1;
  cudaGraphNode_t node = nullptr;
  err = cudaGraphAddNode(&node, g, &setter, 1, &cp);
  if (err != cudaSuccess) return failed(0, err);
  cudaGraphNode_t child = nullptr;
  err = cudaGraphAddChildGraphNode(&child, cp.conditional.phGraph_out[0], nullptr, 0,
                                   static_cast<cudaGraph_t>(body));
  if (err != cudaSuccess) return failed(0, err);
  cudaGraphExec_t e = nullptr;
  err = cudaGraphInstantiate(&e, g, 0);
  if (err != cudaSuccess) return failed(0, err);
  *exec = e;
  return 0;
}

// Launch an instantiated graph on `stream`; does not synchronize.
int shm3d_graph_launch(void* exec, void* stream) {
  return static_cast<int>(cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                                          static_cast<cudaStream_t>(stream)));
}

// Free a chunk graph and its instantiation (either may be null).
int shm3d_chunk_graph_destroy(void* graph, void* exec) {
  cudaError_t err = cudaSuccess;
  if (exec != nullptr) err = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
  if (graph != nullptr) {
    const cudaError_t e2 = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
    if (err == cudaSuccess) err = e2;
  }
  return static_cast<int>(err);
}

// The nodes of a graph (a cudaGraph_t) and how many of them are
// conditional nodes.  A node's type comes from libcuda
// (cuGraphNodeGetType): a runtime older than libcuda cannot name a
// conditional node.  Returns 0 on success, else the error of the step that
// failed plus 1000 times that step (1: counting, 2: listing, 3: finding the
// cuGraphNodeGetType in libcuda, 4: a node's type).
int shm3d_graph_node_counts(void* graph, int64_t* total, int64_t* conditional) {
  const cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(g, nullptr, &n);
  if (err != cudaSuccess) return failed(1, err);
  std::vector<cudaGraphNode_t> nodes(n);
  if (n > 0) {
    err = cudaGraphGetNodes(g, nodes.data(), &n);
    if (err != cudaSuccess) return failed(2, err);
  }
  const NodeGetType node_type = libcuda_node_type();
  if (node_type == nullptr) return 3000;
  int64_t cond = 0;
  for (size_t i = 0; i < n; ++i) {
    int type = -1;
    const int res = node_type(nodes[i], &type);
    if (res != 0) return 4000 + res;
    if (type == CU_GRAPH_NODE_TYPE_CONDITIONAL) ++cond;
  }
  *total = static_cast<int64_t>(n);
  *conditional = cond;
  return 0;
}

}  // extern "C"
