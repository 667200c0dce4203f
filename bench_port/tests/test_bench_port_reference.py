"""The reference against the program on the CPU at small sizes, and a run
of the harness end to end (``run.drive``, the look for a card skipped)
that has to come out correct, and not correct with the timed path broken
underneath or the control in the program's place.

Small cells: the 16^3 grid (3,000 sphere points, the shell Step 1 forced)
and bunny_dec on the tet domain.  Each is held to the limits of the
committed cell of its domain (``CELLS``), so the faults are planted
against the numbers and limits the benchmark's runs compare."""

import json
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import run
from harness import manifest

CPU = torch.device("cpu")
BENCH = manifest.BENCH_DIR
ROOT = manifest.ROOT

# the committed cell whose limits each small cell is held to
CELLS = {"grid": "cloud52k-grid128.fast", "tet": "knot-tet.cr"}

SMALL = {
    "grid": dict(
        config={"name": "small-grid", "domain": "grid", "reference": "grid",
                "geometry": {"maker": "fibonacci_sphere", "points": 3000, "radius": 1.0,
                             "base_seed": 20260101},
                "options": {"h_coef": 0, "dtype": "float32", "disk_cache": False,
                            "step1_method": "shell", "refine_steps": 0}}),
    "tet": dict(
        config={"name": "small-tet", "domain": "tet", "reference": "tet",
                "geometry": {"maker": "obj_file", "file": "data/bunny_dec.obj"},
                "options": {"dtype": "float32", "disk_cache": False}}),
}


def cell_limits(kind: str) -> dict:
    """The limits of the committed cell of ``kind``'s domain."""
    return dict(manifest.workload(CELLS[kind])["limits"])


def small_cell(tmp_path, monkeypatch, kind: str) -> str:
    """A checkout copy holding one small cell of ``kind`` with the committed
    cell's limits; the manifest points at it.  Returns the cell's name."""
    spec = SMALL[kind]
    limits = cell_limits(kind)
    bench = tmp_path / "bench_port"
    if not bench.exists():
        shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("_cache", "_build",
                                                                     "__pycache__"))
    name = spec["config"]["name"]
    (bench / "configs" / f"{name}.json").write_text(json.dumps(spec["config"]))
    cell = f"{name}.x"
    (bench / "workloads" / f"{cell}.json").write_text(json.dumps(
        {"config": name, "options": {}, "warm_solves": 1, "trace_solves": 2,
         "limits": limits, "chips": 1, "why": "small"}))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    man["workloads"] = [{"name": cell, "config": name, "traffic": "x", "chips": 1,
                         "why": "small"}]
    for m in man["end_to_end"] + man["per_layer"]:
        m.pop("workloads", None)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    monkeypatch.setattr(manifest, "BENCH_DIR", bench)
    monkeypatch.setattr(manifest, "ROOT", tmp_path)
    return cell


def drive(cell: str, seed: int = 2 ** 31 + 11, trace: int = 0) -> dict:
    return run.drive(SimpleNamespace(workload=cell, seed=seed, seconds=0.2, trace=trace),
                     CPU)


@pytest.mark.parametrize("kind", ["grid", "tet"])
def test_the_reference_agrees_with_the_program(tmp_path, monkeypatch, kind):
    limits = cell_limits(kind)
    cell = small_cell(tmp_path, monkeypatch, kind)
    out = drive(cell, seed=5)
    res = out["result"]
    assert res["correct"], out["stderr"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "compared" and set(res["compared"]) == set(limits)
    assert {"solve_s", "mem_peak_gb", "setup_s"} <= set(res["metrics"])
    assert out["stderr"][-1].startswith("compared ")


def _faults(kind):
    """(name, patch) of each fault a cell can have, planted in the program."""
    import shm3d_torch.ops.farfield as farfield
    import shm3d_torch.solve.krylov as krylov
    import shm3d_torch.solvers.grid as gridmod
    import shm3d_torch.tet.solver as tetsolver

    def unchanged(mp):
        # a step that returns its state unchanged: every CG leaves x at zero
        orig = krylov.cg_run

        def cg_run(*a, **kw):
            res = orig(*a, **kw)
            return res._replace(x=torch.zeros_like(res.x))
        mp.setattr(krylov, "cg_run", cg_run)

    def half_batch(mp):
        # half of the sources left out of Step 1, the sum scaled over the rest
        for mod in (farfield, tetsolver):
            orig = mod.yukawa_field

            def yukawa_field(q, p, v, lam, *a, _orig=orig, **kw):
                h = p.shape[0] // 2
                return _orig(q, p[:h], 2.0 * v[:h], lam, *a, **kw)
            mp.setattr(mod, "yukawa_field", yukawa_field)

    def altered(mp):
        # an answer altered where it is produced: phi off by half its
        # largest value at one node of the grid, or at one vertex of the
        # tet mesh
        orig_shift = gridmod._mean_shift

        def _mean_shift(*a):
            phi = orig_shift(*a).clone()
            phi[phi.shape[0] // 3] += 0.5 * float(phi.abs().max())
            return phi
        mp.setattr(gridmod, "_mean_shift", _mean_shift)
        orig_res = tetsolver.TetResult

        def TetResult(phi, mesh, Y=None):
            phi = np.array(phi, copy=True)
            phi[phi.shape[0] // 3] += 0.5 * float(np.abs(phi).max())
            return orig_res(phi, mesh, Y)
        mp.setattr(tetsolver, "TetResult", TetResult)

    return [("unchanged", unchanged), ("half_batch", half_batch), ("altered", altered)]


@pytest.mark.parametrize("kind", ["grid", "tet"])
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, kind, fault):
    cell = small_cell(tmp_path, monkeypatch, kind)
    dict(_faults(kind))[fault](monkeypatch)
    out = drive(cell)
    assert out["result"]["correct"] is False, out["stderr"][-4:]


@pytest.mark.parametrize("kind", ["grid", "tet"])
def test_the_control_in_the_programs_place_is_not_correct(tmp_path, monkeypatch, kind):
    """The configuration's control (the reference one precision lower) put
    in the program's place, at the small size (the cell's own size runs on
    the card: ``readings.py``)."""
    cell = small_cell(tmp_path, monkeypatch, kind)
    ref_mod = manifest.reference_module(SMALL[kind]["config"]["reference"])
    from shm3d_torch import api

    program = api.SignedHeatSolver.compute_distance

    class Result:
        def __init__(self, out):
            self.Y, self.phi = out["Y"], out["phi"]
            if "mesh_tets" in out:
                self.mesh = SimpleNamespace(vertices=out["mesh_vertices"],
                                            tets=out["mesh_tets"])

    def compute_distance(self, geom, options):
        port = None
        if kind == "tet":
            # the tet reference solves on the program's mesh: the program's
            # mesher runs, and the control takes the solve's place
            port = run.port_output(program(self, geom, options))
            inputs = {"vertices": geom.vertices, "faces": geom.faces}
        else:
            inputs = {"positions": geom.positions, "normals": geom.normals}
        self.last_stats = {}
        return Result(ref_mod.solve(inputs, run.cell_options(SMALL[kind]["config"], {}),
                                    CPU, control="bf16", port=port))

    monkeypatch.setattr(api.SignedHeatSolver, "compute_distance", compute_distance)
    monkeypatch.setattr(api.SignedHeatSolver, "last_stats", None, raising=False)
    out = drive(cell)
    assert out["result"]["correct"] is False
    assert any(v["value"] > v["limit"] for v in out["result"]["compared"].values())


@pytest.mark.cuda
def test_the_control_fails_at_the_cells_own_size():
    """On the card: each cell's control (its configuration's ``control``),
    held against the float64 reference at the cell's own size, reads above
    a limit the cell compares (the readings script's control, one seed)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda:0")
    man = manifest.manifest()
    for w in man["workloads"]:
        wl = manifest.workload(w["name"])
        cfg = manifest.config(wl["config"])
        opts = run.cell_options(cfg, wl)
        ref_mod = manifest.reference_module(cfg["reference"])
        inputs = manifest.geometry_module(cfg["geometry"]["maker"]).make(
            cfg["geometry"], np.random.default_rng(7))
        port = None
        if cfg["domain"] == "tet":
            # the tet reference solves on the program's mesh
            from shm3d_torch import SignedHeatSolver

            solver = SignedHeatSolver("tet", device="cuda")
            port = run.port_output(solver.compute_distance(
                run.port_geometry(inputs), run.port_options(opts)))
            del solver
        disc = ref_mod.discretize(inputs, opts, port=port)
        ref = ref_mod.solve(inputs, opts, dev, disc=disc)
        ctl = ref_mod.numbers(ref_mod.solve(inputs, opts, dev, control=cfg["control"],
                                            disc=disc), ref)
        assert any(ctl[k] > lim for k, lim in wl["limits"].items()), (w["name"], ctl)
