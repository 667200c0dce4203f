"""CUDA graphs of the solvers' loops: the port's counterpart of the jitted
Krylov chunks of shm3d (``_pinned_pcg_chunk``, ``_kkt_minres_chunk`` in
shm3d.solvers.grid; the tet ``_zeroset_chunk``, ``_none_chunk`` and
``_multiple_chunk``), where a chunk of iterations is one device program, of
the host-projected loop's three device programs (``_hp_step1/2/3``) and of
the wavefront's ``_sweep_chunk``.

Eager PyTorch makes one launch per op: ~1,300 an iteration of the grid's
projected MG-PCG at 128^3, ~430 of the tet face CG, 348 of the vertex CG.
Here an iteration is one replay of a ``torch.cuda.CUDAGraph`` captured from
the in-place iteration body of ``krylov`` (``cg_body``, ``minres_body``),
and the host reads the stop test's scalars once an iteration, as the eager
loop does.  The graph reads and writes a fixed set of state buffers
(``IterationGraph.state``): a solve copies its start state in, replays, and
copies x out.

- ``runner(cache, key, b)``: how a Krylov loop over ``b`` runs its
  iterations.  None (the eager loop) for CPU tensors and for z-slabs
  (``Shards``); for one CUDA tensor or a pair of them (the grid's
  ``KKTPair``), a ``Cached`` that captures the graph on first use and keeps
  it in ``cache[key]``, beside the discretization whose tensors it reads.
  Its siblings ``hostproj_runner`` (the grid's host-projected loop: three
  graphs an iteration, the host's two Gram solves between them) and
  ``wavefront_runner`` (the greedy wavefront: one graph a chunk of sweeps)
  follow the same rule for one tensor.
- ``IterationGraph``: warm-up of the bodies on scratch copies of the state
  on a side stream (under ``torch.cuda.set_sync_debug_mode("error")``, so a
  hidden host sync raises there and names its op), capture of each body,
  one replay a step.  A capture error raises; nothing falls back to the
  eager loop.  A loop with host work between its bodies (a segmented
  stepper) names the state buffers the host exchanges (``exchange``): each
  gets a pinned host mirror, read (``read``) and written (``write``) with
  plain copies between replays, so the graphs' addresses never change.
- ``note_launch`` / ``LaunchCounts``: a kernel wrapper called while a body
  is captured launches nothing; it notes its launch, and every replay adds
  the noted launches to the wrapper's counter (``pell.KERNEL_LAUNCHES``,
  ``yukawa.KERNEL_LAUNCHES``...), so the counters count what runs.
"""

from __future__ import annotations

import collections
import contextlib
import sys
from typing import Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# the launch counts of the body being captured: (module, counter) ->
# launches; None outside a capture
_recording: Optional[collections.Counter] = None


def note_launch(module: str, counter: str) -> bool:
    """A kernel wrapper's launch: while a body is captured, note it for
    the graph's replays to count and return True; else return False (the
    wrapper counts its launch itself)."""
    if _recording is None:
        return False
    _recording[(module, counter)] += 1
    return True


class LaunchCounts:
    """The kernel launches one captured body makes: noted while it is
    recorded, added to the wrappers' counters at each replay."""

    def __init__(self):
        self.counts: collections.Counter = collections.Counter()

    @contextlib.contextmanager
    def recording(self):
        global _recording
        prev, _recording = _recording, self.counts
        try:
            yield self
        finally:
            _recording = prev

    def add(self) -> None:
        for (module, counter), n in self.counts.items():
            mod = sys.modules[module]
            setattr(mod, counter, getattr(mod, counter) + n)


class _LastOp(TorchDispatchMode):
    """Remembers the last aten op dispatched, to name the op that broke a
    warm-up or a capture."""

    last = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.last = func
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def _sync_debug_error():
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def _device(v) -> torch.device:
    return v.device if isinstance(v, torch.Tensor) else v.u.device


class IterationGraph:
    """A loop's bodies, each captured as one CUDA graph over the static
    state buffers ``state``, replayed once a step.

    ``make_bodies(state)`` returns the loop's bodies (CG one; MINRES two:
    its first iteration and the rest; the host-projected loop three
    segments; the wavefront a full and a last chunk), each reading and
    writing ``state`` in place.  Their closures are kept: they hold every
    tensor the graphs read (operators, hierarchies, masks).  ``exchange``:
    the state buffers the host reads or writes between replays."""

    def __init__(self, init: dict, make_bodies: Callable, exchange=()):
        device = _device(next(iter(init.values())))
        self.state = {k: v.clone() for k, v in init.items()}
        self.host = {k: torch.empty(self.state[k].shape, dtype=self.state[k].dtype,
                                    pin_memory=True) for k in exchange}
        self.bodies = make_bodies(self.state)
        current = torch.cuda.current_stream(device)
        stream = torch.cuda.Stream(device)
        # warm-up on scratch state (the real state does not advance) on the
        # capture stream: lazy initialisation (library handles, workspaces,
        # cached uploads) happens here, and a host sync raises here
        scratch = {k: v.clone() for k, v in init.items()}
        stream.wait_stream(current)
        op = _LastOp()
        try:
            with torch.cuda.stream(stream), _sync_debug_error(), op:
                for body in make_bodies(scratch):
                    body()
        except Exception as e:
            raise RuntimeError(f"a loop body failed at {op.last} in its warm-up "
                               f"before CUDA graph capture (a host sync raises here): "
                               f"{e}") from e
        current.wait_stream(stream)
        del scratch
        self.graphs, self.counts = [], []
        pool = None
        for body in self.bodies:
            graph, counts = torch.cuda.CUDAGraph(), LaunchCounts()
            op = _LastOp()
            try:
                with counts.recording(), torch.cuda.graph(graph, pool=pool, stream=stream), op:
                    body()
            except Exception as e:
                raise RuntimeError(f"CUDA graph capture of a loop body failed at "
                                   f"{op.last}: {e}") from e
            pool = graph.pool()  # the bodies run one at a time: one pool
            self.graphs.append(graph)
            self.counts.append(counts)

    def load(self, init: dict) -> None:
        for k, v in init.items():
            self.state[k].copy_(v)

    def step(self, i: int = 0) -> None:
        self.graphs[i].replay()
        self.counts[i].add()

    def read(self, name: str) -> torch.Tensor:
        """The state buffer ``name`` as the replays so far left it, in its
        pinned host mirror (a copy that waits for them; valid until the
        next ``read`` of ``name``)."""
        return self.host[name].copy_(self.state[name])

    def write(self, name: str, value: torch.Tensor) -> None:
        """Host ``value`` into the state buffer ``name`` through its pinned
        mirror, ordered before the next replay on the stream.  The mirror is
        free again once a ``read`` has waited for the device."""
        self.host[name].copy_(value)
        self.state[name].copy_(self.host[name], non_blocking=True)


class Cached:
    """A runner that keeps its stepper (``kind``: ``IterationGraph``, or a
    stand-in with its interface in the CPU tests) in ``cache[key]``, made on
    first use, and loads each solve's start state into it."""

    def __init__(self, cache: dict, key, kind=IterationGraph):
        self.cache, self.key, self.kind = cache, key, kind

    def __call__(self, init: dict, make_bodies: Callable, **kw):
        stepper = self.cache.get(self.key)
        if stepper is None:
            stepper = self.kind(init, make_bodies, **kw)
            self.cache[self.key] = stepper
        stepper.load(init)
        return stepper


def one_cuda_vector(b) -> bool:
    """``b`` is one CUDA tensor or a pair of them (``KKTPair``)."""
    if isinstance(b, torch.Tensor):
        return b.is_cuda
    u, mu = getattr(b, "u", None), getattr(b, "mu", None)
    return isinstance(u, torch.Tensor) and u.is_cuda and isinstance(mu, torch.Tensor)


def runner(cache: Optional[dict], key, b) -> Optional[Cached]:
    """How a Krylov loop over ``b`` runs its iterations: None, the eager
    loop (CPU tensors, z-slabs, or no ``cache``), or for one CUDA tensor or
    a pair of them, the graph kept in ``cache[key]``."""
    return _cached(cache, key, b)


def hostproj_runner(cache: Optional[dict], key, b) -> Optional[Cached]:
    """How the grid's host-projected loop over ``b`` runs its iterations:
    None, the eager loop (CPU tensors, z-slabs, or no ``cache``), or for one
    CUDA tensor its three segment graphs kept in ``cache[key]``, with the
    host's Gram solves between them through the exchange buffers."""
    return _cached(cache, key, b)


def wavefront_runner(cache: Optional[dict], key, Y) -> Optional[Cached]:
    """How the greedy wavefront over the field ``Y`` runs its sweeps: None,
    the eager loop (CPU tensors or no ``cache``), or for one CUDA tensor one
    replay of the chunk graph kept in ``cache[key]`` a chunk of sweeps."""
    return _cached(cache, key, Y)


def _cached(cache: Optional[dict], key, b) -> Optional[Cached]:
    if cache is None or not one_cuda_vector(b):
        return None
    return Cached(cache, key)
