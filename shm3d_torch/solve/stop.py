"""The Krylov loops' stop test on the device (``csrc/krylov_stop.cu``), the
counterpart of the ``cond`` of shm3d's ``lax.while_loop`` in
shm3d.solve.krylov, with the port's own arithmetic: the host test of
``krylov.cg`` and ``krylov.minres``, so a graphed solve stops where the
eager loop does, bit for bit.

The state is a float64 vector of ``NSLOTS`` slots (names below) and a bool
predicate ``go``, which the conditional nodes of a chunk graph read
(``graphs.ChunkGraph``).  The host writes ``TOL``, ``MAXITER``, ``WINDOW``,
``TINY`` (and ``RHS``, when the caller gives rhs_mnorm) before a solve; the
start call writes the threshold and the state before the first iteration;
each iteration's call updates ``RN``, ``BEST``, ``SINCE``, ``K`` and
``GO``.  MINRES keeps phibar in ``RN`` and beta in ``BEST``.  A launch
captured into the body of a chunk graph's WHILE node (``chunk_condition``)
also sets the node's condition to go.

- ``cg_stop`` / ``minres_stop``: dispatch on the device (CPU tensors take
  the plain version, CUDA tensors launch the kernel or raise);
- ``cg_stop_torch`` / ``minres_stop_torch``: the plain versions on 0-dim
  tensors, the same arithmetic in Python floats (a host read: the CPU's
  and the card's reference);
- ``cg_stop_cuda`` / ``minres_stop_cuda``: the kernel's wrappers;
  ``KERNEL_LAUNCHES`` counts their launches (a call while a CUDA graph is
  captured counts at each run of the body that holds it);
- ``CondGraph``, the graphs written by hand of ``graphs.ChunkGraph``: its
  start kernel sets the conditional node's condition from go, plain
  version ``chunk_start_torch``; ``START_LAUNCHES`` counts the launches
  of chunk graphs, one start kernel each.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
from typing import Optional

import torch

from . import graphs

TOL, MAXITER, WINDOW, TINY, RHS, THR, RN, BEST, SINCE, K, GO = range(11)
NSLOTS = 11

KERNEL_LAUNCHES = 0
START_LAUNCHES = 0
# the condition handle of the WHILE node whose body is being captured
# (``graphs.ChunkGraph``): a launch captured there also sets it
_HANDLE = None


@contextlib.contextmanager
def chunk_condition(handle: int):
    """Launches of the stop kernel inside the block set the WHILE condition
    ``handle`` of a chunk graph (its body's capture): go."""
    global _HANDLE
    prev, _HANDLE = _HANDLE, handle
    try:
        yield
    finally:
        _HANDLE = prev


def _count() -> None:
    global KERNEL_LAUNCHES
    if not graphs.note_launch(__name__, "KERNEL_LAUNCHES"):
        KERNEL_LAUNCHES += 1


def new_state(device) -> tuple:
    """A zero stop state and a false predicate on ``device``."""
    return (torch.zeros(NSLOTS, dtype=torch.float64, device=device),
            torch.zeros((), dtype=torch.bool, device=device))


def params(tol: float, maxiter: int, window: int, tiny: float,
           rhs: Optional[float] = None) -> torch.Tensor:
    """The host's slots TOL..RHS of a solve (RHS 0 when it is computed on
    the device)."""
    return torch.tensor([tol, maxiter, window, tiny, 0.0 if rhs is None else rhs],
                        dtype=torch.float64)


# --- the plain versions -------------------------------------------------------


def _store(st: torch.Tensor, go: torch.Tensor, s: list, g: bool) -> None:
    s[GO] = 1.0 if g else 0.0
    st.copy_(torch.tensor(s, dtype=torch.float64))
    go.fill_(g)


def cg_stop_torch(rz: torch.Tensor, bmb: Optional[torch.Tensor], st: torch.Tensor,
                  go: torch.Tensor, start: bool) -> None:
    """CG's stop test on 0-dim tensors, writing ``st`` and ``go`` in place:
    the eager loop's host arithmetic, in Python floats (IEEE double, sqrt
    correctly rounded as the kernel's ``__dsqrt_rn``; torch's CPU sqrt is
    not), its scalars read from the tensors."""
    s = st.tolist()
    rn = math.sqrt(abs(rz.item()))
    if start:
        if bmb is not None:
            s[RHS] = math.sqrt(abs(bmb.item()))
        s[THR] = s[TOL] * max(s[RHS], s[TINY])
        best, since, k = rn, 0.0, 0.0
    else:
        since = 0.0 if rn < 0.98 * s[BEST] else s[SINCE] + 1.0
        best = min(s[BEST], rn)
        k = s[K] + 1.0
    s[RN], s[BEST], s[SINCE], s[K] = rn, best, since, k
    _store(st, go, s, rn > s[THR] and k < s[MAXITER] and since < s[WINDOW])


def minres_stop_torch(phibar: torch.Tensor, beta: torch.Tensor, ref: Optional[torch.Tensor],
                      st: torch.Tensor, go: torch.Tensor, start: bool) -> None:
    """MINRES's stop test on 0-dim tensors: the threshold as
    ``krylov.minres`` computes it (in the vectors' dtype), the test in
    Python floats."""
    s = st.tolist()
    if start:
        s[THR] = float(s[TOL] * torch.clamp_min(ref, s[TINY]))
        k = 0.0
    else:
        k = s[K] + 1.0
    pb, bt = phibar.item(), beta.item()
    s[RN], s[BEST], s[K] = pb, bt, k
    _store(st, go, s, pb > s[THR] and k < s[MAXITER] and bt > 0)


def chunk_start_torch(go: torch.Tensor) -> bool:
    """The start kernel's plain version: the condition a chunk graph's
    conditional node starts with, go (a host read)."""
    return bool(go.item())


# --- the kernel ---------------------------------------------------------------


def _check(name: str, t: torch.Tensor, device, dtype) -> None:
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: the stop kernel takes {dtype}, got {t.dtype}")
    if t.numel() != (NSLOTS if name == "st" else 1) or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor of "
                         f"{NSLOTS if name == 'st' else 1} element(s)")


def _launch(entry: str, scalars, st, go, start: bool) -> None:
    device = st.device
    dtype = scalars[0].dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the stop kernel takes float32 or float64 scalars, got {dtype}")
    for i, t in enumerate(scalars):
        if t is not None:
            _check(f"scalar {i}", t, device, dtype)
    _check("st", st, device, torch.float64)
    _check("go", go, device, torch.bool)
    from .._build import load_library

    lib = load_library()
    suffix = "f64" if dtype == torch.float64 else "f32"
    ptr = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())
    index = device.index if device.index is not None else torch.cuda.current_device()
    with torch.cuda.device(device):
        err = getattr(lib, f"{entry}_{suffix}")(
            *map(ptr, scalars), ptr(st), ptr(go), ctypes.c_int(1 if start else 0),
            ctypes.c_uint64(_HANDLE or 0), ctypes.c_int(0 if _HANDLE is None else 1),
            ctypes.c_int(index),
            ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    if err != 0:
        msg = lib.shm3d_cuda_error_string(err).decode()
        raise RuntimeError(f"Krylov stop kernel launch failed: {msg} ({err})")
    _count()


def cg_stop_cuda(rz, bmb, st, go, start: bool) -> None:
    """Launch CG's stop kernel on the current stream; does not synchronize."""
    _launch("shm3d_cg_stop", (rz, bmb), st, go, start)


def minres_stop_cuda(phibar, beta, ref, st, go, start: bool) -> None:
    """Launch MINRES's stop kernel on the current stream (``ref`` is read
    only at the start); does not synchronize."""
    _launch("shm3d_minres_stop", (phibar, beta, ref if start else phibar), st, go, start)


def _route(t: torch.Tensor):
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"unsupported device {t.device}")


def cg_stop(rz, bmb, st, go, start: bool = False) -> None:
    """CG's stop test: the plain version for CPU tensors, the kernel for
    CUDA tensors."""
    (cg_stop_cuda if _route(st) else cg_stop_torch)(rz, bmb, st, go, start)


def minres_stop(phibar, beta, ref, st, go, start: bool = False) -> None:
    """MINRES's stop test: the plain version for CPU tensors, the kernel for
    CUDA tensors."""
    (minres_stop_cuda if _route(st) else minres_stop_torch)(phibar, beta, ref, st, go, start)


def _check_err(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.shm3d_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed: {msg} ({err})")


def graph_node_counts(graph: int) -> tuple:
    """(nodes, conditional nodes) of a graph (a cudaGraph_t), read with
    cudaGraphGetNodes / cudaGraphNodeGetType."""
    from .._build import load_library

    lib = load_library()
    total, cond = ctypes.c_int64(0), ctypes.c_int64(0)
    err = lib.shm3d_graph_node_counts(ctypes.c_void_p(graph), ctypes.byref(total),
                                      ctypes.byref(cond))
    _check_err(lib, err, "reading a graph's nodes")
    return int(total.value), int(cond.value)


class CondGraph:
    """A graph written by hand: a start kernel (the condition from ``go``),
    then a conditional node whose body is a clone of a captured graph: a
    WHILE node (``loop``), whose body is one iteration ending in the stop
    kernel that sets the condition (captured under
    ``chunk_condition(handle)``), or an IF node, whose body runs once if
    go.  Create it, capture the body (with its ``handle`` for a WHILE
    node), then ``build``."""

    def __init__(self, device: torch.device, loop: bool = True):
        from .._build import load_library

        self.lib = load_library()
        self.loop = loop
        self.graph, self.exec = ctypes.c_void_p(), ctypes.c_void_p()
        handle = ctypes.c_uint64(0)
        index = device.index if device.index is not None else torch.cuda.current_device()
        err = self.lib.shm3d_chunk_graph_create(ctypes.byref(self.graph), ctypes.byref(handle),
                                                ctypes.c_int(index))
        _check_err(self.lib, err, "creating a chunk graph's conditional handle")
        self.handle = int(handle.value)

    def build(self, body: int, go: torch.Tensor) -> None:
        err = self.lib.shm3d_chunk_graph_build(
            self.graph, ctypes.c_uint64(self.handle), ctypes.c_void_p(body),
            ctypes.c_void_p(go.data_ptr()), ctypes.c_int(1 if self.loop else 0),
            ctypes.byref(self.exec))
        _check_err(self.lib, err, "building a chunk graph's conditional node")

    def node_counts(self) -> tuple:
        return graph_node_counts(self.graph.value)

    def launch(self, stream: torch.cuda.Stream) -> None:
        global START_LAUNCHES
        err = self.lib.shm3d_graph_launch(self.exec, ctypes.c_void_p(stream.cuda_stream))
        _check_err(self.lib, err, "launching a chunk graph")
        START_LAUNCHES += 1

    def __del__(self):
        try:
            self.lib.shm3d_chunk_graph_destroy(self.graph, self.exec)
        except Exception:  # noqa: BLE001 (interpreter shutdown)
            pass
