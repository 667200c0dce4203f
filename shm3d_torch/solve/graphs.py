"""CUDA graphs of the solvers' device programs: the port's counterpart of
shm3d's jitted programs.  A Krylov solve is a setup graph and its loop
under conditional nodes that run to the stop (shm3d's
``_pinned_pcg_chunk`` and ``_kkt_minres_chunk`` in shm3d.solvers.grid, the
tet ``_zeroset_chunk``, ``_none_chunk`` and ``_multiple_chunk``, whose
``lax.while_loop`` tests the stop on the device, one program a solve off
the TPU); a stage around it (the grid's Steps 1-2, divergence and mean
shift) is one graph; the host-projected loop is three graphs an iteration
(``_hp_step1/2/3``) and the wavefront one graph a chunk of sweeps
(``_sweep_chunk``).

Eager PyTorch makes one launch per op: ~1,300 an iteration of the grid's
projected MG-PCG at 128^3, ~430 of the tet face CG, 348 of the vertex CG.

- ``runner(cache, key, b)``: how a Krylov loop over ``b`` runs.  None
  (the eager loop) for CPU tensors and for z-slabs (``Shards``); for one
  CUDA tensor or a pair of them (the grid's ``KKTPair``), a ``Cached``
  whose ``get`` makes the ``ChunkGraph`` on first use and keeps it in
  ``cache[key]``, beside the discretization whose tensors it reads.
- ``ChunkGraph``: the setup (the loop's first lines, rhs_mnorm, the stop
  state's start: ``krylov.cg_start`` / ``minres_start``) as one graph, and
  a chunk graph: a start kernel, then a WHILE conditional node whose body
  is one iteration ending in the stop kernel (``solve.stop``), which sets
  the node's condition to the predicate; MINRES's iteration 0 runs under
  an IF node of a chunk graph of its own before it.  A solve that stops in
  its setup runs no iteration.  The host writes the solve's tol, maxiter
  and stall window into the stop state, replays the setup, launches the
  chunk graphs and reads the stop state once (``HOST_READS``).  The nodes
  are written by hand (``stop.CondGraph``: the torch on the card has no
  conditional-node API): each body is captured once by torch and cloned
  into its node.  A failed capture or build, or a chunk graph without its
  conditional node (counted with cudaGraphGetNodes), raises: nothing falls
  back to one graph an iteration.
- ``StageGraph`` (``stage_runner``): a function of fixed input buffers,
  captured once a key and replayed; its outputs are copied out.
- ``IterationGraph`` (``hostproj_runner``, ``wavefront_runner``): a loop's
  bodies, one replay a step, the host's exchange buffers between them.
- Every graph is warmed up first under
  ``torch.cuda.set_sync_debug_mode("error")`` (a hidden host sync raises
  and names its op, ``_LastOp``), and a capture error raises.  The first
  call of a ``ChunkGraph`` or ``StageGraph`` runs its setup or stage
  eagerly (that is its result) before the capture, so a cold solve
  launches what an eager one does, plus one warm-up iteration.
- ``GRAPH_LAUNCHES`` counts every replay and launch of these graphs,
  ``CAPTURES`` every capture (a warm solve adds none).
- Spans (``utils.timing``): a ``ChunkGraph`` solve records its setup's
  replay and each chunk graph's launch (``launch``) and its read of the
  stop state (``wait``); an ``IterationGraph``'s replays are one tally.
- ``note_launch`` / ``LaunchCounts``: a kernel wrapper called while a
  graph is captured launches nothing; it notes its launch, and each run of
  what holds it adds the noted launches to the wrapper's counter
  (``pell.KERNEL_LAUNCHES``, ``yukawa.KERNEL_LAUNCHES``,
  ``stop.KERNEL_LAUNCHES``...): a Krylov solve adds the launches of the
  bodies that ran, read from the stop state's iteration count.
"""

from __future__ import annotations

import collections
import contextlib
import sys
from typing import Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..utils import timing

# the launch counts of the body being captured: (module, counter) ->
# launches; None outside a capture
_recording: Optional[collections.Counter] = None


def note_launch(module: str, counter: str, n: int = 1) -> bool:
    """A kernel wrapper's ``n`` launches: while a body is captured, note
    them for the graph's replays to count and return True; else return
    False (the wrapper counts its launches itself)."""
    if _recording is None:
        return False
    _recording[(module, counter)] += n
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

    def add(self, times: int = 1) -> None:
        for (module, counter), n in self.counts.items():
            mod = sys.modules[module]
            setattr(mod, counter, getattr(mod, counter) + n * times)


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

    ``make_bodies(state)`` returns the loop's bodies (the host-projected
    loop three segments; the wavefront a full and a last chunk), each
    reading and writing ``state`` in place.  Their closures are kept: they
    hold every tensor the graphs read (operators, hierarchies, masks).
    ``exchange``: the state buffers the host reads or writes between
    replays."""

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
            _captured()
            pool = graph.pool()  # the bodies run one at a time: one pool
            self.graphs.append(graph)
            self.counts.append(counts)

    def load(self, init: dict) -> None:
        for k, v in init.items():
            self.state[k].copy_(v)

    def step(self, i: int = 0) -> None:
        with timing.tally("loop body replays", timing.LAUNCH):
            self.graphs[i].replay()
        _launched()
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
    """A runner that keeps its stepper (``kind``: ``IterationGraph``,
    ``ChunkGraph``, ``StageGraph``, or a stand-in with its interface in the
    CPU tests) in ``cache[key]``, made on first use.  Called, it loads each
    solve's start state into an ``IterationGraph``; ``get`` returns the
    stepper as it is."""

    def __init__(self, cache: dict, key, kind=IterationGraph):
        self.cache, self.key, self.kind = cache, key, kind

    def get(self, *args, **kw):
        stepper = self.cache.get(self.key)
        if stepper is None:
            stepper = self.kind(*args, **kw)
            self.cache[self.key] = stepper
        return stepper

    def __call__(self, init: dict, make_bodies: Callable, **kw):
        stepper = self.get(init, make_bodies, **kw)
        stepper.load(init)
        return stepper


# the stop state's host reads in this process: one a solve on a ChunkGraph
HOST_READS = 0
# graph launches in this process: a replay of a stage, a Krylov setup or a
# loop body, a chunk graph's launch
GRAPH_LAUNCHES = 0
# graph captures in this process: a stage, a Krylov setup, a loop or chunk
# body (a solve at a new lambda or shape captures anew)
CAPTURES = 0


def _launched() -> None:
    global GRAPH_LAUNCHES
    GRAPH_LAUNCHES += 1


def _captured() -> None:
    global CAPTURES
    CAPTURES += 1

# one side stream a device for the warm-ups and captures of the chunk and
# stage graphs
_SIDE: dict = {}


def _side(device: torch.device) -> torch.cuda.Stream:
    if device not in _SIDE:
        _SIDE[device] = torch.cuda.Stream(device)
    return _SIDE[device]


def _clone(v):
    return v.clone()


class ChunkGraph:
    """A Krylov solve as a setup graph and its loop as chunk graphs, each a
    conditional node on the device stop test: CG one chunk graph, a WHILE
    node that runs to the stop; MINRES its iteration 0 under an IF node,
    then a WHILE node for the rest.

    ``setup(inputs)`` returns the state before the first iteration (vectors
    and 0-dim scalars) from the input buffers; ``start(state)`` launches the
    stop kernel's start on it; ``make_bodies(state)`` returns the loop's
    bodies (CG one; MINRES two: its iteration 0 and the rest), each an
    iteration in place on ``state`` ending in the stop kernel.  The state
    also holds ``stop`` (``solve.stop``'s float64 slots) and ``go`` (the
    bool predicate).  ``variant``: what shapes the setup (x0, rhs_mnorm
    given); a graph serves one.  Built on the first ``solve``: each body is
    captured once by torch and cloned into the conditional node of a graph
    written by hand (``stop.CondGraph``)."""

    def __init__(self, setup: Callable, start: Callable, make_bodies: Callable,
                 variant=None):
        self.setup, self.start, self.make_bodies = setup, start, make_bodies
        self.variant = variant
        self.inputs = self.state = self.bodies = None
        self.setup_counts = LaunchCounts()
        self.chunks: list = []       # (chunk graph, LaunchCounts of its body) a body
        self.node_counts: list = []  # (nodes, conditional nodes) a chunk graph
        self.reads = 0

    def solve(self, inputs: dict, params: torch.Tensor, variant=None) -> list:
        """Run the solve on ``inputs`` with the host's stop slots ``params``
        (``stop.params``); returns the stop state as the loop left it, as
        floats (the solution is ``state["x"]``)."""
        if variant != self.variant:
            raise ValueError(f"this graph's setup is {self.variant}, the solve's {variant}")
        if self.state is None:
            self._build(inputs, params)
        else:
            for k, v in inputs.items():
                if self.inputs[k] is not v:
                    self.inputs[k].copy_(v)
            self._write_params(params)
            with timing.span("setup graph", timing.LAUNCH):
                self._launch_setup()
        return self._run()

    def _kinds(self) -> list:
        """(body index, a WHILE node: else an IF node) of each chunk graph,
        in launch order: CG one loop; MINRES its iteration 0 once, then the
        loop of the rest."""
        if len(self.bodies) == 1:
            return [(0, True)]
        return [(0, False), (1, True)]

    def _run(self) -> list:
        global HOST_READS
        from . import stop

        for i in range(len(self.chunks)):
            with timing.span("chunk graph", timing.LAUNCH):
                self._launch_chunk(i)
        with timing.span("stop state read", timing.WAIT):
            host = self.state["stop"].tolist()  # the one host read of a solve
        self.reads += 1
        HOST_READS += 1
        left = int(host[stop.K])  # the iterations that ran, in body order
        for (_, loop), (_, counts) in zip(self._kinds(), self.chunks):
            ran = left if loop else min(left, 1)
            counts.add(ran)
            left -= ran
        return host

    # --- the device program: CUDA graphs (the CPU tests' stand-in
    # overrides these four)

    def _write_params(self, params: torch.Tensor) -> None:
        self.host_params.copy_(params)
        self.state["stop"][:params.shape[0]].copy_(self.host_params, non_blocking=True)

    def _launch_setup(self) -> None:
        self.setup_graph.replay()
        _launched()
        self.setup_counts.add()

    def _launch_chunk(self, i: int) -> None:
        self.chunks[i][0].launch(torch.cuda.current_stream(self.device))
        _launched()

    def _build(self, inputs: dict, params: torch.Tensor) -> None:
        from . import stop

        self.device = device = _device(next(iter(inputs.values())))
        current = torch.cuda.current_stream(device)
        side = _side(device)
        self.inputs = {k: _clone(v) for k, v in inputs.items()}
        self.host_params = params.pin_memory()
        side.wait_stream(current)
        op = _LastOp()
        try:
            # the first setup, eagerly on the side stream: the state of this
            # solve; then each body once on scratch state (lazy
            # initialisation there, not in a capture)
            with torch.cuda.stream(side), _sync_debug_error(), op:
                init = self.setup(self.inputs)
                self.state = {k: _clone(v) for k, v in init.items()}
                self.state["stop"], self.state["go"] = stop.new_state(device)
                self.state["stop"][:params.shape[0]].copy_(self.host_params, non_blocking=True)
                self.start(self.state)
                scratch = {k: _clone(v) for k, v in self.state.items()}
                for body in self.make_bodies(scratch):
                    body()
        except Exception as e:
            raise RuntimeError(f"a Krylov setup or body failed at {op.last} in its warm-up "
                               f"before CUDA graph capture (a host sync raises here): "
                               f"{e}") from e
        del scratch
        self.bodies = self.make_bodies(self.state)
        try:
            self.setup_graph = torch.cuda.CUDAGraph()
            with self.setup_counts.recording(), torch.cuda.graph(self.setup_graph,
                                                                 stream=side), op:
                for k, v in self.setup(self.inputs).items():
                    self.state[k].copy_(v)
                self.start(self.state)
            _captured()
            pool = self.setup_graph.pool()
            self.body_graphs = []
            for j, loop in self._kinds():
                chunk = stop.CondGraph(device, loop)
                body, counts = torch.cuda.CUDAGraph(keep_graph=True), LaunchCounts()
                cond = stop.chunk_condition(chunk.handle) if loop else contextlib.nullcontext()
                with counts.recording(), cond, torch.cuda.graph(body, pool=pool, stream=side), op:
                    self.bodies[j]()
                _captured()
                chunk.build(body.raw_cuda_graph(), self.state["go"])
                nodes = chunk.node_counts()
                if nodes[1] != 1:
                    raise RuntimeError(f"the chunk graph holds {nodes[1]} conditional nodes, "
                                       f"not its {'WHILE' if loop else 'IF'} node")
                # the body's torch graph keeps its memory pool for the clone
                self.body_graphs.append(body)
                self.node_counts.append(nodes)
                self.chunks.append((chunk, counts))
        except Exception as e:
            raise RuntimeError(f"CUDA graph capture of a Krylov chunk failed at {op.last}: "
                               f"{e}") from e
        current.wait_stream(side)


class StageGraph:
    """``fn(*inputs)`` (one tensor, or a tuple of them) as one CUDA graph
    over fixed input buffers: the first call runs ``fn`` eagerly (its
    result is that call's) and captures it; later calls copy their inputs
    in, replay, and return copies of the outputs.  ``fn``'s closure is kept:
    it holds every other tensor the graph reads."""

    def __init__(self, fn: Callable):
        self.fn = fn
        self.graph = None
        self.counts = LaunchCounts()

    def __call__(self, *inputs):
        if self.graph is None:
            return self._build(inputs)
        for buf, v in zip(self.inputs, inputs):
            if buf is not v:
                buf.copy_(v)
        self.graph.replay()
        _launched()
        self.counts.add()
        if isinstance(self.outputs, tuple):
            return tuple(o.clone() for o in self.outputs)
        return self.outputs.clone()

    def _build(self, inputs):
        device = torch.device("cuda", torch.cuda.current_device())
        if inputs:
            device = inputs[0].device
        current = torch.cuda.current_stream(device)
        side = _side(device)
        side.wait_stream(current)
        op = _LastOp()
        try:
            with torch.cuda.stream(side), _sync_debug_error(), op:
                out = self.fn(*inputs)
        except Exception as e:
            raise RuntimeError(f"a stage failed at {op.last} in its warm-up before CUDA "
                               f"graph capture (a host sync raises here): {e}") from e
        current.wait_stream(side)
        for o in out if isinstance(out, tuple) else (out,):
            o.record_stream(current)
        self.inputs = [v.clone() for v in inputs]
        graph = torch.cuda.CUDAGraph()
        try:
            with self.counts.recording(), torch.cuda.graph(graph, stream=side), op:
                self.outputs = self.fn(*self.inputs)
        except Exception as e:
            raise RuntimeError(f"CUDA graph capture of a stage failed at {op.last}: "
                               f"{e}") from e
        _captured()
        current.wait_stream(side)
        self.graph = graph
        return out


def one_cuda_vector(b) -> bool:
    """``b`` is one CUDA tensor or a pair of them (``KKTPair``)."""
    if isinstance(b, torch.Tensor):
        return b.is_cuda
    u, mu = getattr(b, "u", None), getattr(b, "mu", None)
    return isinstance(u, torch.Tensor) and u.is_cuda and isinstance(mu, torch.Tensor)


def runner(cache: Optional[dict], key, b) -> Optional[Cached]:
    """How a Krylov loop over ``b`` runs: None, the eager loop (CPU
    tensors, z-slabs, or no ``cache``), or for one CUDA tensor or a pair of
    them, the ``ChunkGraph`` kept in ``cache[key]``."""
    if cache is None or not one_cuda_vector(b):
        return None
    return Cached(cache, key, ChunkGraph)


def stage_runner(cache: Optional[dict], key, device) -> Optional[Cached]:
    """How a stage (a function of fixed inputs) runs on ``device``: None,
    eagerly (not a CUDA device, or no ``cache``), or the ``StageGraph``
    kept in ``cache[key]`` (``run.get(fn)(*inputs)``)."""
    if cache is None or torch.device(device).type != "cuda":
        return None
    return Cached(cache, key, StageGraph)


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
