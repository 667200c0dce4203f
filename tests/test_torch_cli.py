"""The port's CLI end to end on the CPU (``python -m shm3d_torch.cli ...
--device cpu``), its headless exports, and the optional viewer against a
fake polyscope module (the counterpart of tests/test_cli.py)."""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from shm3d_torch import cli
from shm3d_torch.api import SignedHeatSolver
from shm3d_torch.config import SignedHeatOptions
from shm3d_torch.domains.grid import GridSpec
from shm3d_torch.io import viewer, volume_io
from shm3d_torch.io.mesh_io import read_geometry

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUNNY = os.path.join(REPO, "tests", "data", "bunny_dec.obj")


def _run(args, timeout=300):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-m", "shm3d_torch.cli", *args],
                          capture_output=True, text=True, env=env, cwd=REPO, timeout=timeout)


@pytest.mark.parametrize("fast", [False, True])
def test_cli_grid_solve_and_export(tmp_path, fast):
    iso, phi, vtk = tmp_path / "iso.obj", tmp_path / "phi.npy", tmp_path / "vol.vtk"
    out = _run([BUNNY, "--grid", "--device", "cpu", "--no-disk-cache", "--json",
                "--export-iso", str(iso), "--export-phi", str(phi), "--export-vtk", str(vtk)]
               + (["--f"] if fast else []))
    assert out.returncode == 0, out.stderr[-2000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["domain"] == "grid" and summary["device"] == "cpu"
    assert summary["n_unknowns"] == 16 ** 3
    assert summary["step3_path"] == ("greedy-bfs" if fast else "projected-mg-pcg")
    assert summary["tier"] == "bmat"
    v = np.load(phi)
    assert v.shape == (16 ** 3,) and np.isfinite(v).all()
    assert v.min() < 0 < v.max()
    text = iso.read_text()
    assert text.startswith("v ") or "\nv " in text
    assert "DIMENSIONS 16 16 16" in vtk.read_text()


def test_cli_refuses_what_is_not_ported(tmp_path):
    # both domains run on a mesh (tests/test_torch_parallel.py,
    # tests/test_torch_tet_parallel.py): here the tet domain on 2 CPU shards
    from shm3d_torch.geometry.procedural import make_icosphere
    from shm3d_torch.io.mesh_io import write_obj

    geom = make_icosphere(1)
    obj, phi = tmp_path / "ico.obj", tmp_path / "phi.npy"
    write_obj(str(obj), geom.vertices, geom.faces)
    assert cli.main([str(obj), "--device", "cpu", "--devices", "2", "--no-disk-cache",
                     "--export-phi", str(phi)]) == 0
    v = np.load(phi)
    assert v.ndim == 1 and v.size > geom.vertices.shape[0] and np.isfinite(v).all()
    with pytest.raises(ValueError, match="--devices"):
        cli.main([BUNNY, "--grid", "--device", "cpu", "--slices", "2"])
    if not torch.cuda.is_available():
        out = _run([BUNNY, "--grid"])  # the default device is cuda
        assert out.returncode != 0 and "cuda" in out.stderr


def test_cli_profile_writes_a_trace(tmp_path):
    assert cli.main([BUNNY, "--grid", "--f", "--device", "cpu", "--no-disk-cache",
                     "--profile", str(tmp_path)]) == 0
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert trace["traceEvents"]


def test_vtk_exports(tmp_path):
    g = GridSpec((0.0, 0.0, 0.0), 0.5, 4)
    path = tmp_path / "vol.vtk"
    volume_io.write_vtk_grid(str(path), g, np.arange(64, dtype=np.float64))
    text = path.read_text()
    assert "STRUCTURED_POINTS" in text and "DIMENSIONS 4 4 4" in text
    path2 = tmp_path / "tet.vtk"
    volume_io.write_vtk_tet(str(path2), np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1.0]]),
                            np.array([[0, 1, 2, 3]]), np.array([0.0, 1, 2, 3]))
    t2 = path2.read_text()
    assert "UNSTRUCTURED_GRID" in t2 and "CELL_TYPES 1" in t2


def test_viewer_degrades_without_polyscope():
    """Without the optional polyscope, --view exits 2 with a pointer to the
    headless exports, not a traceback."""
    code = ("import builtins, sys\n"
            "_imp = builtins.__import__\n"
            "def block(n, *a, **k):\n"
            "    if n.startswith('polyscope'):\n"
            "        raise ImportError(n)\n"
            "    return _imp(n, *a, **k)\n"
            "builtins.__import__ = block\n"
            "from shm3d_torch.cli import main\n"
            f"sys.exit(main(['--view', '--g', '--f', '--device', 'cpu', {BUNNY!r}]))\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=300)
    assert out.returncode == 2, (out.returncode, out.stderr[-2000:])
    assert "polyscope" in out.stderr and "--export-iso" in out.stderr
    assert "Traceback" not in out.stderr


def test_viewer_solve_with_fake_polyscope():
    """Viewer.solve/contour against a stub polyscope: the volume grid's
    scalars in the right memory order, the isosurface routed through the
    solver."""
    calls = {}

    class _Q:
        def set_color_map(self, *a):
            calls["cmap"] = a

        def set_isolines_enabled(self, *a):
            calls["isolines"] = a

    class _VG:
        def add_scalar_quantity(self, name, vals, **kw):
            calls["grid_scalar"] = np.asarray(vals)
            return _Q()

    class _SM:
        def set_ignore_slice_plane(self, *a):
            pass

    class _Plane:
        def set_draw_plane(self, *a):
            pass

        def set_draw_widget(self, *a):
            pass

    ps = types.SimpleNamespace(
        register_volume_grid=lambda name, dims, lo, hi: calls.update(
            dims=dims, lo=np.asarray(lo), hi=np.asarray(hi)) or _VG(),
        register_surface_mesh=lambda name, V, F: calls.update(
            iso=(np.asarray(V), np.asarray(F))) or _SM(),
        add_scene_slice_plane=lambda: _Plane(),
        get_surface_mesh=lambda name: _SM(),
    )
    v = viewer.Viewer(read_geometry(BUNNY), SignedHeatSolver("grid", device="cpu"),
                      SignedHeatOptions(h_coef=0.0, fast_integration=True, disk_cache=False),
                      input_name="input mesh")
    v.solve(ps)
    assert calls["dims"] == (16, 16, 16)
    g = v.result.grid
    np.testing.assert_allclose(calls["hi"] - calls["lo"], (g.n - 1) * g.cell_size)
    phi = np.asarray(v.result.phi)
    np.testing.assert_array_equal(calls["grid_scalar"][:, 0, 0], phi[:16])
    v.contour(ps)
    V, F = calls["iso"]
    assert V.shape[0] > 0 and F.shape[0] > 0
