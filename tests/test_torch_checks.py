"""The port's numerical sanitizer (shm3d_torch.utils.checks): clean solves
pass every check, corrupted inputs are caught at the first bad phase (the
counterpart of tests/test_checks.py)."""

import numpy as np
import pytest
import torch

from shm3d_torch import cli
from shm3d_torch.config import SignedHeatOptions
from shm3d_torch.geometry.procedural import make_icosphere
from shm3d_torch.io.mesh_io import write_obj
from shm3d_torch.ops import stencil
from shm3d_torch.solve import projection
from shm3d_torch.solvers.grid import GridSolver
from shm3d_torch.tet.solver import SignedHeatTetSolver
from shm3d_torch.utils import checks

torch.set_num_threads(2)


@pytest.fixture
def debug_mode():
    checks.enable(True)
    yield
    checks.enable(False)


@pytest.fixture(scope="module")
def small_icosphere():
    return make_icosphere(1)


@pytest.mark.parametrize("domain", ["grid", "tet"])
def test_clean_solve_passes(debug_mode, small_icosphere, domain):
    opts = SignedHeatOptions(dtype="float64", refine_steps=0, disk_cache=False)
    solver = GridSolver(device="cpu") if domain == "grid" else SignedHeatTetSolver(device="cpu")
    assert np.isfinite(solver.compute_distance(small_icosphere, opts).phi).all()


def test_corrupted_grid_solve_caught(debug_mode, small_icosphere, monkeypatch):
    """A projector that leaves A u != 0 fails at the Step-3 pinning check."""
    real = projection.make_projector

    def leaky(*args, **kwargs):
        proj = real(*args, **kwargs)
        return lambda v: proj(v) + 1e-2 * v.abs().max()

    monkeypatch.setattr(projection, "make_projector", leaky)
    opts = SignedHeatOptions(dtype="float64", refine_steps=0, disk_cache=False)
    with pytest.raises(checks.NumericalCheckError, match="grid Step 3 pinning"):
        GridSolver(device="cpu").compute_distance(small_icosphere, opts)


def test_checks_disabled_are_free():
    checks.enable(False)
    checks.check_finite("x", np.array([np.nan]))
    checks.check_unit_field("y", np.ones((4, 3)) * 5.0)
    checks.check_symmetric("z", lambda v: v.flip(0), 8)


def test_non_finite_caught(debug_mode):
    with pytest.raises(checks.NumericalCheckError, match="non-finite"):
        checks.check_finite("bad", torch.tensor([1.0, float("inf"), 2.0]))
    arr = np.ones(1000)
    arr[0] = np.nan
    checks.check_finite("ok", arr, allow_fraction=0.01)


def test_non_unit_field_caught(debug_mode):
    Y = torch.ones((16, 3), dtype=torch.float64) / np.sqrt(3.0)
    checks.check_unit_field("unit", Y)
    Y[3] *= 2.0
    with pytest.raises(checks.NumericalCheckError, match="non-unit"):
        checks.check_unit_field("scaled", Y)


def test_asymmetric_operator_caught(debug_mode):
    rng = np.random.default_rng(0)
    M = rng.standard_normal((12, 12))
    S = M + M.T
    checks.check_symmetric("sym", lambda x: S @ np.asarray(x), 12)
    with pytest.raises(checks.NumericalCheckError, match="adjoint mismatch"):
        checks.check_symmetric("asym", lambda x: M @ np.asarray(x), 12)


def test_adjoint_pair_caught(debug_mode):
    cell, shape = 0.37, (6, 6, 6)
    fwd = lambda u: stencil.gradient_apply(u.reshape(shape), cell)
    adj = lambda g: stencil.divergence_apply(g.reshape(*shape, 3), cell)
    checks.check_adjoint("grad/div", fwd, adj, (216,), (216, 3))
    bad = lambda g: 1.01 * adj(g)
    with pytest.raises(checks.NumericalCheckError, match="adjoint mismatch"):
        checks.check_adjoint("drifted", fwd, bad, (216,), (216, 3))


def test_constraint_violation_caught(debug_mode):
    a = lambda u: u.sum().reshape(1)
    checks.check_constraint("ok", torch.tensor([1.0, -1.0, 0.5, -0.5]), a, b_scale=1.0)
    with pytest.raises(checks.NumericalCheckError, match="constraint violation"):
        checks.check_constraint("bad", torch.ones(4), a, b_scale=1.0)


def test_cli_debug_flag(tmp_path, small_icosphere):
    path = tmp_path / "sphere.obj"
    write_obj(str(path), small_icosphere.vertices, small_icosphere.faces)
    try:
        assert cli.main([str(path), "--g", "--debug", "--no-disk-cache",
                         "--dtype", "float64", "--device", "cpu"]) == 0
        assert checks.enabled()
    finally:
        checks.enable(False)
