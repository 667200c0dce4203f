"""Port stencils (shm3d_torch.ops.stencil) against shm3d.ops.stencil and the
SciPy operator matrices of shm3d.domains.grid, in float64 on the CPU.

Tolerance 1e-12 relative: the operators are the same +-1-coefficient sums in
both packages, so only the summation order differs (a few ulp of f64)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shm3d.domains import grid as griddom
from shm3d.ops import stencil as jstencil
from shm3d_torch.ops import stencil

torch.set_num_threads(2)

RTOL = 1e-12


def _grid(n, cell=0.37):
    return griddom.GridSpec((0.1, -0.2, 0.3), cell, n)


def _close(got, expected):
    got = np.asarray(got)
    scale = np.abs(expected).max()
    assert np.abs(got - expected).max() <= RTOL * scale, np.abs(got - expected).max() / scale


@pytest.mark.parametrize("n", [4, 7, 16])
def test_laplacian_matches_scipy_and_jax(n):
    g = _grid(n)
    u = np.random.default_rng(n).normal(size=g.total_nodes)
    got = stencil.laplacian_apply(torch.from_numpy(u.reshape(g.shape)), g.cell_size)
    _close(got.numpy().reshape(-1), griddom.laplacian_matrix(g) @ u)
    ref = jstencil.laplacian_apply(jnp.asarray(u.reshape(g.shape)), g.cell_size)
    _close(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("n", [4, 7, 16])
def test_gradient_matches_scipy_and_jax(n):
    g = _grid(n, cell=0.21)
    u = np.random.default_rng(10 + n).normal(size=g.total_nodes)
    got = stencil.gradient_apply(torch.from_numpy(u.reshape(g.shape)), g.cell_size)
    assert got.shape == (n, n, n, 3)
    _close(got.numpy().reshape(-1), griddom.gradient_matrix(g) @ u)
    ref = jstencil.gradient_apply(jnp.asarray(u.reshape(g.shape)), g.cell_size)
    _close(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("n", [3, 5, 16])
def test_divergence_matches_scipy_and_jax(n):
    g = _grid(n)
    Y = np.random.default_rng(20 + n).normal(size=(g.total_nodes, 3))
    got = stencil.divergence_apply(torch.from_numpy(Y.reshape(*g.shape, 3)), g.cell_size)
    _close(got.numpy().reshape(-1), griddom.gradient_matrix(g).T @ Y.reshape(-1))
    ref = jstencil.divergence_apply(jnp.asarray(Y.reshape(*g.shape, 3)), g.cell_size)
    _close(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("n", [3, 8, 17])
def test_divergence_is_gradient_adjoint_f64(n):
    """<grad u, Y> == <u, div Y> directly in float64, not only via parity."""
    rng = np.random.default_rng(30 + n)
    cell = 0.13
    u = torch.from_numpy(rng.normal(size=(n, n, n)))
    Y = torch.from_numpy(rng.normal(size=(n, n, n, 3)))
    lhs = float((stencil.gradient_apply(u, cell) * Y).sum())
    rhs = float((u * stencil.divergence_apply(Y, cell)).sum())
    assert abs(lhs - rhs) <= RTOL * max(abs(lhs), 1.0), (lhs, rhs)


def test_stencils_leave_inputs_unchanged():
    rng = np.random.default_rng(40)
    u = torch.from_numpy(rng.normal(size=(6, 6, 6)))
    Y = torch.from_numpy(rng.normal(size=(6, 6, 6, 3)))
    u0, Y0 = u.clone(), Y.clone()
    stencil.laplacian_apply(u, 0.5)
    stencil.gradient_apply(u, 0.5)
    stencil.divergence_apply(Y, 0.5)
    assert torch.equal(u, u0) and torch.equal(Y, Y0)
