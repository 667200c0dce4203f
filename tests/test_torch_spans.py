"""The span recorder (shm3d_torch.utils.timing) and the spans and counters
the solvers record with it, on the CPU:

- the recorder alone: nesting, parents, kinds, host offsets inside their
  parent, a tally's count and total, spans after the solve;
- small grid and tet CR solves: the spans under the root are the phases of
  ``last_stats["phases"]`` with their durations; the span count does not
  move with the iterations (two tolerances, eager and through the
  chunk-graph stand-in of ``torch_chunks``); a default-tier solve holds at
  most 100 spans; ``last_stats["counters"]`` is the counters' deltas, a
  warm solve captures no graph, and the full-row tier counts 4 (4 + 2
  iters) projector products;
- ``GridResult.phi`` adds its spans to its own solve's list; the
  host-projected loop's Gram solves are one tally;
- no CUDA event and no ``record_function`` range without a profiler; with
  a CPU profiler running the spans are ranges of its trace.
"""

import contextlib
import copy

import pytest
import torch

from shm3d_torch.config import SignedHeatOptions
from shm3d_torch.geometry.procedural import make_icosphere
from shm3d_torch.solve import graphs, projection
from shm3d_torch.solvers import grid as tgrid
from shm3d_torch.tet.solver import SignedHeatTetSolver
from shm3d_torch.utils import timing
from torch_chunks import EmulatedChunks

torch.set_num_threads(2)

CPU = torch.device("cpu")
FAST = SignedHeatOptions(dtype="float32", refine_steps=0, disk_cache=False)
DEFAULT = SignedHeatOptions(dtype="float32", disk_cache=False)
MAX_SPANS = 100


@contextlib.contextmanager
def chunked():
    """The Krylov solves through ``torch_chunks.EmulatedChunks`` (the host
    side of ``graphs.ChunkGraph``, the device program emulated)."""
    saved = graphs.runner

    def run(cache, key, b):
        if cache is None or not isinstance(getattr(b, "u", b), torch.Tensor):
            return None
        return graphs.Cached(cache, key, EmulatedChunks)

    graphs.runner = run
    try:
        yield
    finally:
        graphs.runner = saved


def _children(spans, parent):
    return [s for s in spans if s[1] == parent]


def _under(spans, name: str):
    """The spans with an ancestor whose name holds ``name``."""
    out = []
    for s in spans:
        p = s[1]
        while p >= 0 and name not in spans[p][0]:
            p = spans[p][1]
        if p >= 0:
            out.append(s)
    return out


def _check_tree(spans):
    """Parents precede their children, every kind is known, and each span
    lies inside its parent."""
    kinds = {timing.HOST, timing.WAIT, timing.LAUNCH, timing.GROUP}
    for i, (name, parent, kind, t0, t1, attrs) in enumerate(spans):
        assert kind in kinds and isinstance(name, str) and isinstance(attrs, tuple)
        assert 0 <= t0 <= t1
        assert parent < i
        if parent >= 0:
            p = spans[parent]
            assert p[3] <= t0 and t1 <= p[4], (spans[parent], spans[i])


def _phases_of(spans):
    """The group spans under the root, seconds by name."""
    out = {}
    for name, _, kind, t0, t1, _ in _children(spans, 0):
        if kind == timing.GROUP:
            out[name] = out.get(name, 0.0) + (t1 - t0) / 1e9
    return out


def test_recorder_nesting_kinds_and_tallies():
    tm = timing.PhaseTimer(CPU)
    stats = {}
    with tm.solve(stats, name="root"):
        with tm.phase("one"):
            with timing.span("host work", timing.HOST, bytes=12):
                with timing.span("inner wait", timing.WAIT) as sp:
                    sp.set(iters=3)
            for _ in range(5):
                with timing.tally("repeated", timing.LAUNCH):
                    pass
        with tm.phase("two"):
            with timing.span("grouped", timing.GROUP):
                pass
    assert timing.span("outside", timing.HOST) is timing._NULL
    with timing.after(tm, "after the solve", timing.HOST):
        pass
    spans = stats["spans"]
    _check_tree(spans[:-1])
    names = [s[0] for s in spans]
    assert names == ["root", "one", "host work", "inner wait", "repeated", "phase-end sync",
                     "two", "grouped", "phase-end sync", "after the solve"]
    parents = [s[1] for s in spans]
    assert parents == [-1, 0, 1, 2, 1, 1, 0, 6, 6, -1]
    assert dict(spans[2][5]) == {"bytes": 12} and dict(spans[3][5]) == {"iters": 3}
    tally = dict(spans[4][5])
    assert tally["count"] == 5 and 0 <= tally["total_ns"] <= spans[4][4] - spans[4][3]
    assert spans[-1][3] >= spans[0][4]
    assert _phases_of(spans) == pytest.approx(tm.as_dict(), abs=1e-9)
    assert set(stats["counters"]) == {f"{m}.{n}" for m, n in timing.COUNTERS}
    # the list and the counters copy as plain lists and dicts do
    dup = copy.deepcopy(stats)
    assert dup["spans"] == spans and dup["spans"] is not spans
    assert dup["counters"] == stats["counters"]


@pytest.fixture(scope="module")
def ico():
    return make_icosphere(1)


def _grid(geom, opts, n=2):
    s = tgrid.GridSolver(device="cpu")
    for _ in range(n):
        res = s.compute_distance(geom, opts)
    return s, res


def _tet(geom, opts, n=2):
    s = SignedHeatTetSolver(device="cpu")
    for _ in range(n):
        s.compute_distance(geom, opts)
    return s


@pytest.mark.parametrize("domain", ["grid", "tet"])
def test_top_level_spans_are_the_phases(ico, domain):
    if domain == "grid":
        s, res = _grid(ico, DEFAULT)
    else:
        s = _tet(ico, DEFAULT)
    st = s.last_stats
    spans = st["spans"]
    assert spans[0][0] == "compute_distance" and spans[0][1] == -1
    _check_tree(spans)
    assert _phases_of(spans) == pytest.approx(st["phases"], abs=1e-9)
    # each phase ends in its device sync
    for i, x in enumerate(spans):
        if x[1] == 0 and x[2] == timing.GROUP:
            assert _children(spans, i)[-1][0] == "phase-end sync"
    kinds = {x[2] for x in spans}
    assert {timing.HOST, timing.WAIT, timing.LAUNCH} <= kinds
    (lookup,) = [x for x in spans if x[0] == "cache lookup (geometry hash)"]
    assert lookup[2] == timing.HOST and spans[lookup[1]][1] == 0
    assert 0 < len(spans) <= MAX_SPANS


@pytest.mark.parametrize("domain", ["grid", "tet"])
@pytest.mark.parametrize("through", ["eager", "chunk graphs"])
def test_span_count_does_not_follow_iterations(ico, domain, through):
    counts, iters = [], []
    ctx = chunked if through == "chunk graphs" else contextlib.nullcontext
    for tol in (1e-2, 1e-6):
        opts = FAST.with_(solver_tol=tol)
        with ctx():
            s = _grid(ico, opts)[0] if domain == "grid" else _tet(ico, opts)
        st = s.last_stats
        counts.append(len(st["spans"]))
        iters.append(st["iters"])
        solves = [x for x in st["spans"] if x[0] == "cg solve"]
        assert [dict(x[5])["iters"] for x in solves][0] == st["iters"]
        if through == "chunk graphs":
            names = {x[0] for x in st["spans"]}
            assert {"setup graph", "chunk graph", "stop state read"} <= names
    assert iters[0] < iters[1]
    assert counts[0] == counts[1]


def test_default_tier_refine_spans(ico):
    s, _ = _grid(ico, DEFAULT)
    st = s.last_stats
    spans = st["spans"]
    refine = _under(spans, "float64 defect correction")
    passes = [x for x in refine if x[0] == "defect pass"]
    assert len(passes) == len(st["correction_iters"]) >= 1
    assert [dict(x[5])["pass"] for x in passes] == list(range(1, len(passes) + 1))
    assert {x[0] for x in refine if x[2] == timing.HOST} == {"Gram lu.solve"}
    assert "refine_detail" not in st


def test_counters_are_the_module_deltas(ico):
    s = tgrid.GridSolver(device="cpu")
    with chunked():
        s.compute_distance(ico, FAST)
        before = timing.read_counters()
        s.compute_distance(ico, FAST)
        after = timing.read_counters()
    got = s.last_stats["counters"]
    assert got == {k: after[k] - before[k] for k in after}
    assert got["shm3d_torch.solve.graphs.HOST_READS"] == 1


@pytest.mark.parametrize("domain", ["grid", "tet"])
def test_warm_solve_captures_no_graph(ico, domain):
    key = "shm3d_torch.solve.graphs.CAPTURES"
    with chunked():
        s = _grid(ico, FAST, n=1)[0] if domain == "grid" else _tet(ico, FAST, n=1)
        cold = s.last_stats["counters"][key]
        s.compute_distance(ico, FAST)
    assert cold >= 2  # a setup and a body a Krylov solve
    assert s.last_stats["counters"][key] == 0


def test_full_row_tier_counts_projector_products(monkeypatch):
    monkeypatch.setattr(projection, "ORTHO_GRAM_CAP", 0)
    s, _ = _grid(make_icosphere(2), FAST)
    st = s.last_stats
    assert st["tier"] == "full-row"
    assert st["counters"]["shm3d_torch.solve.projection.TMAT_PRODUCTS"] == \
        4 * (4 + 2 * st["iters"])
    with chunked():
        s.compute_distance(make_icosphere(2), FAST)
        s.compute_distance(make_icosphere(2), FAST)
    st = s.last_stats
    assert st["counters"]["shm3d_torch.solve.projection.TMAT_PRODUCTS"] == \
        4 * (4 + 2 * st["iters"])


def test_host_projected_gram_solves_are_one_tally(monkeypatch):
    monkeypatch.setattr(projection, "ORTHO_GRAM_CAP", 0)
    monkeypatch.setattr(projection, "TFORM_FULL_CAP", 0)
    s, _ = _grid(make_icosphere(2), FAST.with_(max_device_pins=None), n=1)
    st = s.last_stats
    assert st["tier"] == "host-projected"
    (gram,) = [x for x in st["spans"] if x[0] == "Gram lu.solve"]
    assert dict(gram[5])["count"] == st["host_loop"]["gram_solves"] > 2
    assert "gram_solve_s" not in st["host_loop"] and "loop_s" not in st["host_loop"]
    (solve,) = [x for x in st["spans"] if x[0] == "host-projected cg solve"]
    assert dict(solve[5])["iters"] == st["iters"]


def test_result_phi_adds_its_spans(ico):
    s, res = _grid(ico, FAST, n=1)
    spans = s.last_stats["spans"]
    n = len(spans)
    res.phi
    res.phi  # the copy is made once
    assert [x[0] for x in spans[n:]] == ["phi to host", "phi to float64"]
    assert [x[2] for x in spans[n:]] == [timing.WAIT, timing.HOST]
    assert all(x[1] == -1 and x[3] >= spans[0][4] for x in spans[n:])
    # a later solve's result writes to that solve's list
    res2 = s.compute_distance(ico, FAST)
    res2.phi
    assert len(spans) == n + 2 and s.last_stats["spans"][-1][0] == "phi to float64"


def test_nothing_recorded_for_a_profiler_without_one(ico, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("recorded with no profiler running")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    _grid(ico, DEFAULT)
    _tet(ico, FAST, n=1)


def test_spans_are_ranges_under_a_profiler(ico):
    from torch.profiler import ProfilerActivity, profile

    s = tgrid.GridSolver(device="cpu")
    s.compute_distance(ico, DEFAULT)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s.compute_distance(ico, DEFAULT)
    ranges = {e.name for e in prof.events()}
    names = {x[0] for x in s.last_stats["spans"] if x[1] != -1 or x[0] == "compute_distance"}
    assert names <= ranges
    assert {"compute_distance", "cg solve", "Gram lu.solve"} <= ranges
