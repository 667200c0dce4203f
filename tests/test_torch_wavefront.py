"""Greedy ("fast") grid integration: the port's wavefront
(shm3d_torch.ops.wavefront) against shm3d.ops.wavefront and the host BFS,
and ``fast_integration=True`` end to end against shm3d, all in float64 on
the CPU.

The wavefront computes each edge increment once instead of once a sweep,
and tests "every node visited" at a stride instead of after chunks of
sweeps; neither changes a value, so it must give shm3d's phi to 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shm3d.ops.wavefront import greedy_integrate_wavefront as jax_wavefront
from shm3d.solvers.grid import GridSolver as JaxGridSolver
from shm3d_torch.config import SignedHeatOptions
from shm3d_torch.domains.grid import build_grid
from shm3d_torch.geometry.procedural import make_icosphere
from shm3d_torch.ops.wavefront import greedy_integrate_wavefront
from shm3d_torch.oracle.reference import integrate_greedily_grid
from shm3d_torch.solvers.grid import GridSolver
from torch_interop import jax_geom, jax_options

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def grid32():
    return build_grid(make_icosphere(2).vertices, 2.0, 1.0)


def _both(grid, Y):
    got, sweeps, visited = greedy_integrate_wavefront(
        torch.as_tensor(Y), grid.cell_size, grid.shape)
    ref = np.asarray(jax_wavefront(jnp.asarray(Y), grid.cell_size, grid.shape))
    assert visited == grid.total_nodes and sweeps == 3 * (grid.n - 1)
    return got.numpy(), ref


def test_wavefront_exact_on_constant_field(grid32):
    """On a constant unit field every spanning tree gives the exact linear
    phi: the wavefront, shm3d's and the host BFS agree."""
    d = np.array([1.0, 2.0, -0.5])
    d /= np.linalg.norm(d)
    Y = np.tile(d, (grid32.total_nodes, 1))
    got, ref = _both(grid32, Y)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got, integrate_greedily_grid(grid32, Y), rtol=0, atol=1e-12)
    pos = grid32.node_positions()
    np.testing.assert_allclose(got, (pos - pos[0]) @ d, rtol=0, atol=1e-12)


def test_wavefront_on_smooth_field(grid32):
    """A unit radial field: shm3d's wavefront to 1e-12, and within the
    method's path-integration error of the BFS and of |x| - |x_corner|."""
    pos = grid32.node_positions()
    r = np.linalg.norm(pos, axis=1)
    Y = pos / np.maximum(r, 1e-9)[:, None]
    got, ref = _both(grid32, Y)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    bfs = integrate_greedily_grid(grid32, Y)
    scale = np.abs(bfs).max()
    assert np.abs(got - bfs).max() < 0.15 * scale
    assert np.abs(got - (r - r[0])).max() < 0.2 * scale


@pytest.mark.parametrize("h_coef,path", [(0.0, "greedy-bfs"), (2.0, "greedy-wavefront")])
def test_fast_integration_matches_shm3d(h_coef, path):
    geom = make_icosphere(2)
    opts = SignedHeatOptions(dtype="float64", fast_integration=True, h_coef=h_coef,
                             disk_cache=False)
    js, ts = JaxGridSolver(), GridSolver(device="cpu")
    jr = js.compute_distance(jax_geom(geom), jax_options(opts))
    tr = ts.compute_distance(geom, opts)
    assert ts.last_stats["step3_path"] == js.last_stats["step3_path"] == path
    assert tr.u_device is None
    assert tr.phi.shape == (int(16 * 2 ** h_coef) ** 3,)
    rel = np.linalg.norm(tr.phi - jr.phi) / np.linalg.norm(jr.phi)
    assert rel < 1e-10, rel
