"""The full-row projector's packed lower-triangular factor
(shm3d_torch.solve.projection: ``TriFactor``, ``tri_pack``, ``tri_gemv``)
and its kernel (csrc/tri_gemv.cu).

On the CPU: packing then unpacking gives tril(T); the plain products match
the dense ones to float32 rounding; ``project_t`` on the packed factor
matches the same projector on the dense square; the subsampled tier's
eigendecomposition fallback keeps a dense factor and still projects onto
ker(A).  Tile counts 1, TILE - 1, TILE, TILE + 1, 3 TILE + 5 and 600 rows
cover a single partial tile, whole tiles and ragged last tiles.  The kernel
runs only where a card is present (marked ``cuda``): against the float64
product, two calls bit for bit, one launch a product, inside a CUDA graph.
"""

import numpy as np
import pytest
import scipy.linalg
import torch

from shm3d_torch.domains import grid as griddom
from shm3d_torch.geometry import sources as src_mod
from shm3d_torch.geometry.procedural import make_icosphere
from shm3d_torch.solve import graphs, projection
from shm3d_torch.utils import timing

B = projection.TRI_TILE
SIZES = [1, B - 1, B, B + 1, 3 * B + 5, 600]
EPS32 = 2.0 ** -24


def _rounding_bound(m: int) -> float:
    """Float32 rounding of a row sum in tiles, relative to (|T| |x|) of the
    row: (tile + tile rows) x 2^-24."""
    return (B + -(-m // B)) * EPS32


def _row_err(got: torch.Tensor, T64: torch.Tensor, x64: torch.Tensor) -> float:
    exact, scale = T64 @ x64, T64.abs() @ x64.abs()
    return float(((got.double() - exact).abs() / scale.clamp_min(1e-300)).max())


@pytest.mark.parametrize("m", SIZES)
def test_pack_then_unpack_gives_the_lower_triangle(m):
    T = torch.as_tensor(np.random.default_rng(m).standard_normal((m, m)))
    f = projection.tri_pack(T)
    nb = -(-m // B)
    assert f.m == m and f.tiles.shape == (nb * (nb + 1) // 2, B, B)
    assert torch.equal(projection.tri_unpack(f), torch.tril(T))
    # diagonal tiles keep a zero upper half, padding stays zero
    rows, cols = projection._tile_rows_cols(f)
    diag = f.tiles[rows == cols]
    assert torch.equal(diag, torch.tril(diag))
    assert int((f.tiles != 0).sum()) == int((torch.tril(T) != 0).sum())


@pytest.mark.parametrize("m", SIZES)
def test_plain_products_match_dense(m):
    rng = np.random.default_rng(100 + m)
    T = torch.tril(torch.as_tensor(rng.standard_normal((m, m)), dtype=torch.float32))
    x = torch.as_tensor(rng.standard_normal(m), dtype=torch.float32)
    f = projection.tri_pack(T)
    T64, x64 = T.double(), x.double()
    for trans, mat in ((False, T64), (True, T64.T)):
        got = projection.tri_gemv_torch(f, x, trans)
        assert _row_err(got, mat, x64) <= _rounding_bound(m)
        # the dispatch takes the plain version on the CPU
        assert torch.equal(projection.tri_gemv(f, x, trans), got)


@pytest.fixture(scope="module")
def rows():
    mesh = make_icosphere(3)
    grid = griddom.build_grid(mesh.vertices, 2.0, 1.0)
    nodes8, coeffs8 = griddom.constraint_rows(grid, src_mod.from_geometry(mesh).points)
    assert nodes8.shape[0] >= max(SIZES)
    return grid, nodes8, np.asarray(coeffs8, np.float64)


def _projector(nodes8, coeffs8, gram, N):
    return projection.make_projector(torch.as_tensor(nodes8, dtype=torch.int64),
                                     torch.as_tensor(coeffs8), gram, N,
                                     projection.at_table(nodes8, coeffs8, "cpu", torch.float64))


@pytest.mark.parametrize("m", SIZES)
def test_project_t_on_the_packed_factor_matches_the_square(rows, m):
    """The full-row tier's factor (the first m constraint rows), float64:
    ``project_t`` through the packed triangle against the same projector
    on the dense square, whose products are plain matmuls."""
    grid, nodes8, coeffs8 = rows
    N = grid.total_nodes
    n8, c8 = nodes8[:m], coeffs8[:m]
    gram = projection.gram_from_arrays(projection.build_tform_full_arrays(n8, c8, N),
                                       "cpu", torch.float64)
    assert isinstance(gram.tmat, projection.TriFactor) and gram.tmat.m == m
    square = gram._replace(tmat=projection.tri_unpack(gram.tmat))
    v = torch.as_tensor(np.random.default_rng(m).standard_normal(N))
    got = _projector(n8, c8, gram, N)(v)
    want = _projector(n8, c8, square, N)(v)
    assert float((got - want).norm() / want.norm()) < 1e-12


@pytest.mark.parametrize("branch", ["cholesky", "eigendecomposition"])
def test_subsampled_factor_form_decides_the_product(rows, monkeypatch, branch):
    """``build_tform_arrays``'s Cholesky factor is lower triangular, so it
    is packed at load; its eigendecomposition fallback is a dense factor,
    applied with plain products.  Both project onto ker(A) as the exact
    host projection does."""
    grid, nodes8, coeffs8 = rows
    N = grid.total_nodes
    n8, c8 = nodes8[:200], coeffs8[:200]
    if branch == "eigendecomposition":
        def refuse(*a, **k):
            raise np.linalg.LinAlgError("not positive definite")
        monkeypatch.setattr(scipy.linalg, "cholesky", refuse)
    arrays = projection.build_tform_arrays(n8, c8, N)
    T = arrays["tmat"]
    assert (T.shape[0] == T.shape[1] and not np.triu(T, 1).any()) == (branch == "cholesky")
    gram = projection.gram_from_arrays(arrays, "cpu", torch.float64)
    packed = isinstance(gram.tmat, projection.TriFactor)
    assert packed == (branch == "cholesky")
    if not packed:
        assert torch.equal(gram.tmat, torch.as_tensor(arrays["tmat"]))
    v = np.random.default_rng(4).standard_normal(N)
    got = _projector(n8, c8, gram, N)(torch.as_tensor(v)).numpy()
    A, lu = projection.host_gram_factor(n8, c8, N)
    want = projection.host_project(v, A, lu)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-10
    assert np.abs(A @ got).max() < 1e-10 * np.abs(v).max()


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel wrapper launches only on CUDA tensors; it never falls back
    to the plain version.  Its launches are one of the solve's counters."""
    f = projection.tri_pack(torch.eye(5, dtype=torch.float32))
    before = projection.TRI_GEMV_LAUNCHES
    for trans in (False, True):
        with pytest.raises(ValueError, match="CUDA tensor"):
            projection.tri_gemv_cuda(f, torch.ones(5), trans)
    assert projection.TRI_GEMV_LAUNCHES == before
    assert ("shm3d_torch.solve.projection", "TRI_GEMV_LAUNCHES") in timing.COUNTERS


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    from shm3d_torch._device import resolve_device

    return resolve_device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m", SIZES + [15706])
def test_cuda_kernel_matches_float64_and_repeats(cuda_device, m):
    """Kernel and plain version on the card against the float64 product
    with the same float32 factor, row by row within the float32 rounding
    bound; two calls bit for bit; one launch a product; float64 refused."""
    gen = torch.Generator(device=cuda_device).manual_seed(m)
    T = torch.randn(m, m, generator=gen, device=cuda_device).tril_()
    x = torch.randn(m, generator=gen, device=cuda_device)
    f = projection.tri_pack(T)
    T64, x64 = T.double(), x.double()
    del T
    for trans, mat in ((False, T64), (True, T64.T)):
        before = projection.TRI_GEMV_LAUNCHES
        got = projection.tri_gemv_cuda(f, x, trans)
        again = projection.tri_gemv_cuda(f, x, trans)
        torch.cuda.synchronize()
        assert projection.TRI_GEMV_LAUNCHES == before + 2
        assert torch.equal(got, again)
        assert _row_err(got, mat, x64) <= _rounding_bound(m)
        assert _row_err(projection.tri_gemv_torch(f, x, trans), mat, x64) <= _rounding_bound(m)
        # what the kernel does not take is refused, never copied or computed otherwise
        with pytest.raises(ValueError, match="aligned"):
            projection.tri_gemv_cuda(f, torch.cat([x.new_zeros(1), x])[1:], trans)
        with pytest.raises(TypeError, match="float32"):
            projection.tri_gemv_cuda(projection.TriFactor(f.tiles.double(), m), x64, trans)


@pytest.mark.cuda
def test_cuda_kernel_inside_a_graph(cuda_device):
    """Captured into a CUDA graph, the two products replay the eager
    results and count one launch each a replay."""
    m = 3 * B + 5
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    f = projection.tri_pack(torch.randn(m, m, generator=gen, device=cuda_device))
    x = torch.randn(m, generator=gen, device=cuda_device)

    def product():
        return projection.tri_gemv_cuda(f, projection.tri_gemv_cuda(f, x), trans=True)

    want = product()
    counts = graphs.LaunchCounts()
    g = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream(cuda_device)
    stream.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(stream):
        product()
    torch.cuda.current_stream(cuda_device).wait_stream(stream)
    with counts.recording(), torch.cuda.graph(g):
        out = product()
    before = projection.TRI_GEMV_LAUNCHES
    g.replay()
    counts.add()
    torch.cuda.synchronize()
    assert projection.TRI_GEMV_LAUNCHES == before + 2
    assert torch.equal(out, want)
