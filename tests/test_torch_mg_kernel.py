"""The V-cycle's fused stencil kernels (csrc/mg_stencil.cu) and their
dispatch in shm3d_torch.solve.multigrid.

On the CPU: CPU tensors and z-slabs keep the plain ops (the kernels' twin),
bit for bit the V-cycle as it was written before the kernels, with
``STENCIL_LAUNCHES`` at 0; the wrapper refuses what the kernels do not take
before any launch; the kernel source builds into the kernel library and
declares what the wrapper binds.  On the card (marked ``cuda``): each
kernel against its plain version bit for bit, float32 and float64, levels
of 8, 16, 17, 64 and 128 nodes a side, without pins, with binary and with
fractional masks, boundary nodes included; the coarsest level's sweeps in
one launch; whole V-cycles; a captured graph's replays; a CUDA level the
kernels cannot take raises in the V-cycle and the CG matvec, with no
fallback to the plain ops.
"""

import re

import numpy as np
import pytest
import torch

from shm3d_torch import _build
from shm3d_torch.ops import stencil
from shm3d_torch.parallel import device_mesh
from shm3d_torch.parallel.shards import Shards
from shm3d_torch.solve import graphs, multigrid
from shm3d_torch.solvers import grid as tgrid
from shm3d_torch.utils import timing

CELLS = (0.3, 0.0173)  # an exact-ish and an inexact spacing


def _plain_v_cycle(b, cell, nu=1, coarsest=8, pins=None):
    """``multigrid.v_cycle`` as it was written before the fused kernels:
    the plain ops only."""
    n = b.shape[0]
    w = None
    if pins is not None and len(pins) > 0:
        w = pins[0] * (6.0 / (cell * cell))
        pins_c = pins[1:]
    else:
        pins_c = None if pins is None else ()
    if n <= coarsest:
        if n <= 16 and w is None:
            pinv = multigrid._coarse_pinv(n, b.dtype, b.device)
            return (cell * cell) * (pinv @ b.reshape(-1)).reshape(b.shape)
        return multigrid._jacobi(torch.zeros_like(b), b, cell, multigrid._H_diag(cell), 40, w)
    if n % 2:
        return multigrid._jacobi(torch.zeros_like(b), b, cell, multigrid._H_diag(cell), 20, w)
    diag = multigrid._H_diag(cell)
    u = multigrid._jacobi(torch.zeros_like(b), b, cell, diag, nu, w)
    r = b - multigrid._Hp_apply(u, cell, w)
    e = _plain_v_cycle(multigrid.restrict(r), 2.0 * cell, nu, coarsest, pins_c)
    u = u + multigrid.prolong(e)
    return multigrid._jacobi(u, b, cell, diag, nu, w)


def _pins(n, dtype, device="cpu", seed=0):
    rng = np.random.default_rng(seed)
    nodes8 = torch.as_tensor(rng.integers(0, n ** 3, size=(max(n ** 3 // 64, 4), 8)),
                             device=device)
    return multigrid.build_pin_masks(nodes8, (n, n, n), dtype)


def _lap(u, cell):
    """The CG matvec's Laplacian (``solvers.grid._lap``) of a level."""
    return tgrid._lap(u.reshape(-1), cell, tuple(u.shape)).reshape(u.shape)


def _field(n, dtype, device="cpu", seed=1):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal((n, n, n)), dtype=dtype, device=device)


@pytest.fixture
def no_launch(monkeypatch):
    """Fail the test if anything reaches the kernel library."""
    def refuse():
        raise AssertionError("the kernel library was loaded")
    monkeypatch.setattr(_build, "load_library", refuse)


# --- CPU ------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,pinned", [(32, True), (32, False), (17, True), (8, True)])
def test_cpu_v_cycle_keeps_the_plain_ops(no_launch, dtype, n, pinned):
    """On CPU tensors the V-cycle and the Laplacian take the plain ops:
    bit for bit the V-cycle written before the kernels, no launch
    counted."""
    b = _field(n, dtype)
    pins = _pins(n, dtype) if pinned else None
    before = multigrid.STENCIL_LAUNCHES
    for cell in CELLS:
        assert torch.equal(multigrid.v_cycle(b, cell, pins=pins),
                           _plain_v_cycle(b, cell, pins=pins))
        assert torch.equal(_lap(b, cell), stencil.laplacian_apply(b, cell))
    assert multigrid.STENCIL_LAUNCHES == before


def test_cpu_slabs_keep_the_plain_ops(no_launch):
    """The preconditioner on z-slabs (``Shards``) runs the slab V-cycle's
    plain ops and equals the single-device V-cycle; no launch counted."""
    n, cell = 32, 0.3
    b = _field(n, torch.float32)
    nodes8 = torch.as_tensor(np.random.default_rng(3).integers(0, n ** 3, size=(300, 8)))
    mesh = device_mesh(devices=["cpu"] * 4)
    pins = multigrid.build_pin_masks(nodes8, (n, n, n), torch.float32)
    spins = multigrid.build_slab_pin_masks(nodes8, n, mesh, torch.float32)
    pre = multigrid.make_node_preconditioner((n, n, n), cell, pins=spins)
    before = multigrid.STENCIL_LAUNCHES
    got = pre(Shards([p.reshape(-1) for p in b.chunk(4)], mesh))
    assert isinstance(got, Shards)
    assert torch.equal(torch.cat(got.parts), _plain_v_cycle(b, cell, pins=pins).reshape(-1))
    assert multigrid.STENCIL_LAUNCHES == before


def test_fused_takes_cuda_tensors_only():
    """``fused`` is the dispatch, by device alone: no CPU tensor, slab list
    or ``Shards`` takes the kernels, whatever its shape or layout."""
    b = _field(8, torch.float32)
    mesh = device_mesh(devices=["cpu"] * 2)
    assert not multigrid.fused(b)
    assert not multigrid.fused(list(b.chunk(2)))
    assert not multigrid.fused(Shards([p.reshape(-1) for p in b.chunk(2)], mesh))
    assert not multigrid.fused(b.reshape(-1))
    assert not multigrid.fused(b.transpose(0, 2))


@pytest.mark.parametrize("op", ["laplacian", "residual", "jacobi"])
def test_wrapper_refuses_before_any_launch(no_launch, op):
    """What the kernels do not take raises before the library is loaded:
    another dtype, a dtype unlike u's, a non-cubic or non-contiguous level,
    a CPU tensor; the wrapper never falls back to the plain ops."""
    u = _field(8, torch.float32)
    b = torch.ones_like(u)
    cases = [
        (TypeError, "float32 or float64", u.half(), b.half()),
        (TypeError, "float32 or float64", u.to(torch.int32), b.to(torch.int32)),
        (ValueError, r"\(n, n, n\)", u[:, :, :4].contiguous(), b[:, :, :4].contiguous()),
        (ValueError, "contiguous", u.transpose(0, 2), b.transpose(0, 2)),
        (ValueError, "CUDA tensor", u, b),
    ]
    if op != "laplacian":  # the operands must agree with u
        cases += [(TypeError, "like u", u, b.double()),
                  (ValueError, r"\(n, n, n\) level like u", u, _field(16, torch.float32))]
    before = multigrid.STENCIL_LAUNCHES
    for exc, match, uu, bb in cases:
        with pytest.raises(exc, match=match):
            multigrid.stencil_cuda(op, uu, None if op == "laplacian" else bb, 0.3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        multigrid.stencil_cuda(op, u, b, 0.3, mask=torch.zeros_like(u))
    assert multigrid.STENCIL_LAUNCHES == before


def test_kernel_source_builds_into_the_library():
    """csrc/mg_stencil.cu is one of the library's sources (so it changes
    the library's key), declares the two entry points the loader binds with
    their 13 arguments, agrees with the wrapper on the op codes and the
    one-launch limit, and uses no atomics.  Read as text: no nvcc here."""
    src = _build.CSRC / "mg_stencil.cu"
    assert src in _build._sources()
    text = src.read_text()
    loader = (_build.CSRC.parent / "_build.py").read_text()
    assert 'f"shm3d_mg_stencil_{suffix}"' in loader
    for suffix, scalar in (("f32", "float"), ("f64", "double")):
        sig = re.search(rf"int shm3d_mg_stencil_{suffix}\((.*?)\)\s*\{{", text, re.S)
        assert sig is not None
        args = [a.strip() for a in sig.group(1).split(",")]
        assert len(args) == 13 and args[0] == "int op"
        assert all(a.startswith(f"const {scalar}*") for a in args[1:4])
        assert args[4].startswith(f"{scalar}* ") and args[5] == "int64_t n"
        assert all(a.startswith(f"{scalar} ") for a in args[6:10])
    ops = dict(re.findall(r"(LAPLACIAN|RESIDUAL|SWEEP) = (\d)", text))
    assert {k.lower(): int(v) for k, v in ops.items()} == {
        "laplacian": 0, "residual": 1, "sweep": 2} and multigrid._OPS["jacobi"] == 2
    assert f"ONE_MAX_NODES = {multigrid.ONE_LAUNCH_NODES};" in text
    assert "atomic" not in text.lower().replace("no atomics", "")
    assert ("shm3d_torch.solve.multigrid", "STENCIL_LAUNCHES") in timing.COUNTERS


def test_scalars_are_the_plain_ops_operands():
    """The kernels' scalars: the Python scalars of the plain ops cast to
    the level's type; the divisors' reciprocals taken in float64, then
    cast (at cell 0.3 that differs from the float32 reciprocal of the
    float32 diagonal in the last bit)."""
    for cell in CELLS:
        inv_c2, pen, omega, inv_diag = multigrid._scalars(cell, torch.float32)
        assert all(isinstance(c, np.float32) for c in (inv_c2, pen, omega, inv_diag))
        assert inv_c2 == np.float32(1.0 / (cell * cell))
        assert pen == np.float32(6.0 / (cell * cell)) and omega == np.float32(2.0 / 3.0)
        assert inv_diag == np.float32(1.0 / (6.0 / (cell * cell)))
        inv_c2, pen, omega, inv_diag = multigrid._scalars(cell, torch.float64)
        assert inv_c2 == 1.0 / (cell * cell) and pen == 6.0 / (cell * cell)
        assert inv_diag == 1.0 / (6.0 / (cell * cell))
    assert multigrid._scalars(0.3, torch.float32)[3] != \
        np.float32(1) / np.float32(6.0 / (0.3 * 0.3))


# --- the card ---------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    from shm3d_torch._device import resolve_device

    return resolve_device("cuda")


def _mask(kind, n, dtype, device):
    """No mask, a binary one (a fine level's) or a fractional one (a coarse
    level's: a restricted mask, x8, clipped)."""
    if kind is None:
        return None
    pins = _pins(2 * n if kind == "fractional" else n, dtype, device, seed=n)
    return pins[1] if kind == "fractional" else pins[0]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [8, 16, 17, 64, 128])
@pytest.mark.parametrize("kind", [None, "binary", "fractional"])
def test_cuda_kernels_match_the_plain_ops_bitwise(cuda_device, dtype, n, kind):
    """Laplacian, residual, one sweep from u and one from zero, each one
    launch, bit for bit the plain ops on the card over the whole level."""
    if kind == "fractional" and n % 2:
        pytest.skip("a fractional mask is a restricted one: even levels below the finest")
    u, b = _field(n, dtype, cuda_device, 1), _field(n, dtype, cuda_device, 2)
    mask = _mask(kind, n, dtype, cuda_device)
    if kind == "fractional":
        assert bool(((mask > 0) & (mask < 1)).any())
    for cell in CELLS:
        w = None if mask is None else mask * (6.0 / (cell * cell))
        diag = multigrid._H_diag(cell)
        before = multigrid.STENCIL_LAUNCHES
        got = dict(
            laplacian=multigrid.stencil_cuda("laplacian", u, None, cell),
            residual=multigrid.stencil_cuda("residual", u, b, cell, mask),
            sweep=multigrid.stencil_cuda("jacobi", u, b, cell, mask),
            sweep0=multigrid.stencil_cuda("jacobi", None, b, cell, mask))
        want = dict(
            laplacian=stencil.laplacian_apply(u, cell),
            residual=b - multigrid._Hp_apply(u, cell, w),
            sweep=multigrid._jacobi(u, b, cell, diag, 1, w),
            sweep0=multigrid._jacobi(torch.zeros_like(b), b, cell, diag, 1, w))
        torch.cuda.synchronize()
        assert multigrid.STENCIL_LAUNCHES == before + 4
        for name in got:
            assert torch.equal(got[name], want[name]), (name, cell)
        assert torch.equal(_lap(u, cell), want["laplacian"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,sweeps", [(8, 40), (9, 20), (16, 40), (17, 20)])
@pytest.mark.parametrize("kind", [None, "fractional"])
def test_cuda_sweeps_in_one_launch(cuda_device, dtype, n, sweeps, kind):
    """A level of at most ONE_LAUNCH_NODES nodes runs all its sweeps in one
    launch (16^3 in float64: 64 KB of shared memory); a larger one a launch
    a sweep; both bit for bit the plain sweeps, from zero and from u."""
    if kind == "fractional" and n % 2:
        kind = "binary"
    b, u = _field(n, dtype, cuda_device, 3), _field(n, dtype, cuda_device, 4)
    mask = _mask(kind, n, dtype, cuda_device)
    cell = 0.0173 * 16
    w = None if mask is None else mask * (6.0 / (cell * cell))
    diag = multigrid._H_diag(cell)
    for start in (None, u):
        before = multigrid.STENCIL_LAUNCHES
        got = multigrid.stencil_cuda("jacobi", start, b, cell, mask, sweeps)
        want = multigrid._jacobi(torch.zeros_like(b) if start is None else start, b, cell,
                                 diag, sweeps, w)
        torch.cuda.synchronize()
        one = n ** 3 <= multigrid.ONE_LAUNCH_NODES
        assert multigrid.STENCIL_LAUNCHES == before + (1 if one else sweeps)
        assert torch.equal(got, want)


def _plain_on_card(monkeypatch):
    monkeypatch.setattr(multigrid, "fused", lambda u: False)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [64, 128])
@pytest.mark.parametrize("pinned", [True, False])
def test_cuda_v_cycle_bitwise(cuda_device, monkeypatch, dtype, n, pinned):
    """A whole V-cycle through the kernels equals the plain V-cycle on the
    card bit for bit; 13 launches a pinned cycle from 128^3 (three a level
    above 8^3, one there), 12 an unpinned one (8^3 is the dense pinv)."""
    b = _field(n, dtype, cuda_device, 5)
    pins = _pins(n, dtype, cuda_device) if pinned else None
    cell = 2.0 / n
    before = multigrid.STENCIL_LAUNCHES
    got = multigrid.v_cycle(b, cell, pins=pins)
    torch.cuda.synchronize()
    levels = int(np.log2(n // 8))
    assert multigrid.STENCIL_LAUNCHES - before == 3 * levels + (1 if pinned else 0)
    want = _plain_v_cycle(b, cell, pins=pins)
    _plain_on_card(monkeypatch)
    assert torch.equal(got, want)
    assert torch.equal(got, multigrid.v_cycle(b, cell, pins=pins))


@pytest.mark.cuda
def test_cuda_graph_replay_counts_and_repeats(cuda_device):
    """A pinned V-cycle and a Laplacian captured into a CUDA graph replay
    the eager results and add their 14 launches to ``STENCIL_LAUNCHES``
    once a replay."""
    n = 128
    b = _field(n, torch.float32, cuda_device, 6)
    pins = _pins(n, torch.float32, cuda_device)
    cell = 2.0 / n

    def step():
        return multigrid.v_cycle(_lap(b, cell), cell, pins=pins)

    want = step()
    counts = graphs.LaunchCounts()
    g = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream(cuda_device)
    stream.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(stream):
        step()
    torch.cuda.current_stream(cuda_device).wait_stream(stream)
    captured = multigrid.STENCIL_LAUNCHES
    with counts.recording(), torch.cuda.graph(g):
        out = step()
    assert multigrid.STENCIL_LAUNCHES == captured
    for k in range(2):
        g.replay()
        counts.add()
        torch.cuda.synchronize()
        assert multigrid.STENCIL_LAUNCHES == captured + 14 * (k + 1)
        assert torch.equal(out, want)


@pytest.mark.cuda
def test_cuda_levels_the_kernels_cannot_take_raise(cuda_device):
    """A CUDA level that is not a contiguous float32 or float64 cube takes
    the kernels' path and raises there, in the V-cycle and in the CG
    matvec's Laplacian, before any launch: the card never falls back to
    the plain ops."""
    n, cell = 16, 0.3
    b = _field(n, torch.float32, cuda_device, 7)
    pins = _pins(n, torch.float32, cuda_device)
    flat = torch.zeros(2 * n ** 3, dtype=torch.float32, device=cuda_device)
    cases = [
        (ValueError, "contiguous", b.transpose(0, 2), None),
        (ValueError, "contiguous", b.transpose(0, 2), pins),
        (TypeError, "float32 or float64", b.half(), None),
        (ValueError, r"\(n, n, n\)", b[:, :, : n // 2].contiguous(), None),
    ]
    before = multigrid.STENCIL_LAUNCHES
    for exc, match, level, p in cases:
        with pytest.raises(exc, match=match):
            multigrid.v_cycle(level, cell, pins=p)
        assert multigrid.STENCIL_LAUNCHES == before
    with pytest.raises(ValueError, match="contiguous"):
        tgrid._lap(flat[::2], cell, (n, n, n))
    with pytest.raises(TypeError, match="float32 or float64"):
        _lap(b.half(), cell)
    assert multigrid.STENCIL_LAUNCHES == before
