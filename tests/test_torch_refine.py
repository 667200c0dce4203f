"""The grid domain's default tier (shm3d_torch.solvers.grid: float64 defect
correction of the float32 solve) against shm3d.solvers.grid.

- the float64 defect P (b - H u) of the port, on the device in native
  float64 (refine_mode="pair") and in host NumPy (refine_mode="host"),
  against the JAX package's host pieces (``_laplacian_apply_np``,
  ``_div64_np``, ``host_project``) on the same u: 1e-12 relative (the same
  float64 sums in another order);
- whole default-tier solves on a 16^3 icosphere and a 16^3 sphere cloud, both
  modes: the correction reaches ``refine_target`` or stops by the 2x
  stagnation rule, and phi lies within 1e-7 relative of a float64 solve of
  the same discretization and of the JAX package's default tier (phi is
  float32, ~3e-8 relative rounding; the Step-2 field is float32 in both);
- the correction's spans: one a pass, with the host work of its mode;
- the per-pass tolerance equals the JAX package's;
- ``refine_skipped`` on every solve above REFINE_MAX_NODES and after a
  device out-of-memory error; any other error propagates.
"""

import numpy as np
import pytest
import torch

from shm3d.solve import projection as jproj
from shm3d.solvers import grid as jgrid
from shm3d_torch.config import SignedHeatOptions
from shm3d_torch.geometry.procedural import make_icosphere, make_sphere_cloud
from shm3d_torch.solvers import grid as tgrid
from torch_interop import jax_geom, jax_options

torch.set_num_threads(2)

BASE = SignedHeatOptions(dtype="float32", disk_cache=False)  # refine_steps=1, "pair"
TOL = 1e-7


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def solved():
    """{case: (geometry, port solver after one default-tier solve, float64
    phi of the same discretization, the JAX package's default-tier phi)}."""
    out = {}
    for case, geom in (("icosphere16", make_icosphere(2)),
                       ("cloud16", make_sphere_cloud(2000))):
        s = tgrid.GridSolver(device="cpu")
        s.compute_distance(geom, BASE)
        ref64 = tgrid.GridSolver(device="cpu").compute_distance(
            geom, BASE.with_(dtype="float64", refine_steps=0, solver_tol=1e-12)).phi
        jphi = np.asarray(jgrid.GridSolver().compute_distance(
            jax_geom(geom), jax_options(BASE)).phi, np.float64)
        out[case] = (geom, s, ref64, jphi)
    return out


@pytest.mark.parametrize("case", ["icosphere16", "cloud16"])
def test_defect_matches_shm3d_host_pieces(solved, case):
    geom, s, *_ = solved[case]
    cached = next(iter(s._cache.values()))
    grid = cached["grid"]
    cell, shape, n = float(grid.cell_size), grid.shape, grid.total_nodes
    rng = np.random.default_rng(0)
    u = rng.standard_normal(n)
    Y = rng.standard_normal((n, 3))
    A, lu = jproj.host_gram_factor(cached["nodes8_host"], cached["coeffs8_f64"], n)
    b = -jgrid.GridSolver._div64_np(Y.reshape(*shape, 3), cell)
    Hu = -jgrid._laplacian_apply_np(u.reshape(shape), cell).reshape(-1)
    ref = jproj.host_project(b - Hu, A, lu)

    tA, tlu = s._host_gram(cached, grid)
    b_dev = -tgrid._rhs_div(torch.as_tensor(Y), cell, shape, False)
    assert _rel(b_dev.numpy(), b) <= 1e-12
    got_dev = tgrid.defect_f64(torch.as_tensor(u), b_dev, cached["nodes8"],
                               torch.as_tensor(cached["coeffs8_f64"]), cached["at64"],
                               tlu, cell, shape)
    got_host = tgrid.defect_host(u, -tgrid._div64_np(Y.reshape(*shape, 3), cell),
                                 tA, tlu, cell, shape)
    assert got_dev.dtype == torch.float64
    assert _rel(got_dev.numpy(), ref) <= 1e-12
    assert _rel(got_host, ref) <= 1e-12


@pytest.mark.parametrize("mode", ["pair", "host"])
@pytest.mark.parametrize("case", ["icosphere16", "cloud16"])
def test_default_tier_matches_f64_and_shm3d(solved, case, mode):
    geom, _, ref64, jphi = solved[case]
    s = tgrid.GridSolver(device="cpu")
    res = s.compute_distance(geom, BASE.with_(refine_mode=mode))
    st = s.last_stats
    rels = st["refine_pass_rels"]
    assert "refine_skipped" not in st
    assert len(rels) >= 2 and len(st["correction_iters"]) == len(rels) - 1
    assert rels[-1] < 1e-3 * rels[0]
    # stopped at the target or by the 2x stagnation rule
    assert st["refine_rel_res"] <= BASE.refine_target or rels[-1] > 0.5 * rels[-2]
    # the correction's spans: a pass each, and its host work (the Gram LU
    # solves on the device path, the NumPy defect in host mode)
    spans = st["spans"]
    (phase,) = [i for i, x in enumerate(spans) if x[0] == "float64 defect correction"]
    refine = [x for x in spans if x[1] == phase or spans[x[1]][1] == phase]
    assert [dict(x[5])["pass"] for x in refine if x[0] == "defect pass"] == \
        list(range(1, len(rels)))
    assert {x[0] for x in refine if x[2] == "host"} == (
        {"Gram lu.solve"} if mode == "pair" else
        {"divergence (host float64)", "project (host float64)", "defect (host float64)"})
    assert res.phi_device.dtype == torch.float32
    assert _rel(res.phi, ref64) <= TOL
    assert _rel(res.phi, jphi) <= TOL


@pytest.mark.parametrize("rel", [None, float("nan"), 1e-3, 2.5e-5, 1.1e-9, 3e-11])
@pytest.mark.parametrize("exact", [True, False])
def test_correction_tol_matches_shm3d(rel, exact):
    opts = BASE.with_(refine_target=1e-9)
    assert tgrid.GridSolver._correction_tol(opts, rel, exact) == \
        jgrid.GridSolver._correction_tol(jax_options(opts), rel, exact)


def test_refine_skipped_above_max_nodes(monkeypatch):
    monkeypatch.setattr(tgrid, "REFINE_MAX_NODES", 16 ** 3 - 1)
    s = tgrid.GridSolver(device="cpu")
    for _ in range(2):
        s.compute_distance(make_icosphere(2), BASE)
        assert "REFINE_MAX_NODES" in s.last_stats["refine_skipped"]
        assert "refine_pass_rels" not in s.last_stats


def test_refine_skipped_after_device_oom(monkeypatch):
    """A device out-of-memory error keeps the float32 solution, warns, and
    is recorded on that solve and on every later one; other errors
    propagate."""
    s = tgrid.GridSolver(device="cpu")
    geom = make_icosphere(2)
    fast = s.compute_distance(geom, BASE.with_(refine_steps=0)).phi

    def oom(*args, **kwargs):
        raise torch.cuda.OutOfMemoryError("out of memory")

    monkeypatch.setattr(tgrid.GridSolver, "_refine", oom)
    for _ in range(2):
        with pytest.warns(UserWarning, match="exhausted device memory"):
            res = s.compute_distance(geom, BASE)
        assert s.last_stats["refine_skipped"] == "device OOM"
        np.testing.assert_array_equal(res.phi, fast)

    def boom(*args, **kwargs):
        raise RuntimeError("not an allocation failure")

    monkeypatch.setattr(tgrid.GridSolver, "_refine", boom)
    with pytest.raises(RuntimeError, match="not an allocation failure"):
        tgrid.GridSolver(device="cpu").compute_distance(geom, BASE)


def test_default_options_run_the_default_tier():
    """SignedHeatOptions() on the grid domain: float32, refine_steps=1,
    refine_mode="pair"."""
    opts = SignedHeatOptions(disk_cache=False)
    assert (opts.dtype, opts.refine_steps, opts.refine_mode) == ("float32", 1, "pair")
    s = tgrid.GridSolver(device="cpu")
    res = s.compute_distance(make_icosphere(1), opts)
    assert np.isfinite(res.phi).all()
    assert s.last_stats["refine_rel_res"] < s.last_stats["refine_pass_rels"][0]
