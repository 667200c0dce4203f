#!/usr/bin/env python3
"""The JAX package's numbers for the tet vertex (dual-Laplacian) path on
tests/data/knot_dec.obj, taken on the CPU in float32 (JAX x64 off, so the
device solves are float32 and the defect correction float64 on the host):
the constants chip_smoke.py holds the port's vertex phase against.

Run from the repository root (a few minutes on 8 CPU cores):

    JAX_PLATFORMS=cpu python3 scripts/jax_tet_vertex_reference.py

1. the triangle mesh with ``use_crouzeix_raviart=False`` (ZERO_SET,
   refine_steps=1);
2. its vertices with area-weighted vertex normals as an oriented point
   cloud, LevelSetConstraint.NONE.

Prints one JSON object per case: mesh sizes, iterations, per-pass f64
residuals, and min / max / mean |phi| / mean |phi| at the sources; and a
checksum of the point cloud's normals, which chip_smoke.py recomputes from
its own normals so that both runs are known to solve one input.
"""

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax

jax.config.update("jax_platforms", "cpu")

from shm3d import LevelSetConstraint, SignedHeatOptions
from shm3d.io.mesh_io import PointCloud, read_geometry
from shm3d.tet.solver import SignedHeatTetSolver

KNOT = os.path.join(REPO, "tests", "data", "knot_dec.obj")


def vertex_normals(mesh) -> np.ndarray:
    """Unit area-weighted vertex normals of a triangle mesh."""
    tris = mesh.triangles()
    v = mesh.vertices
    fn = np.cross(v[tris[:, 1]] - v[tris[:, 0]], v[tris[:, 2]] - v[tris[:, 0]])
    vn = np.zeros_like(v)
    for k in range(3):
        np.add.at(vn, tris[:, k], fn)
    return vn / np.linalg.norm(vn, axis=1, keepdims=True)


def normals_checksum(normals) -> float:
    """The sum chip_smoke.py recomputes from the port's own vertex normals
    (shm3d_torch.geometry.surface.normals_checksum) before it holds the
    point-cloud run against this script's numbers."""
    return float(np.abs(np.asarray(normals, np.float64) @ np.array([1.0, 2.0, 3.0])).sum())


def run(label, geom, opts):
    solver = SignedHeatTetSolver()
    t0 = time.perf_counter()
    res = solver.compute_distance(geom, opts)
    st = solver.last_stats
    phi = res.phi
    print(json.dumps(dict(
        case=label, seconds=round(time.perf_counter() - t0, 1),
        vertices=int(res.mesh.n_vertices), tets=int(res.mesh.n_tets),
        n_src=int(res.mesh.n_src), conforming=bool(res.mesh.conforming),
        step3_path=st["step3_path"], iters=st["iters"], rel_res=st["rel_res"],
        refine_pass_rels=st.get("refine_pass_rels"), amg_sizes=st["amg_sizes"],
        phi_min=float(phi.min()), phi_max=float(phi.max()),
        phi_mean_abs=float(np.abs(phi).mean()),
        phi_src_mean_abs=float(np.abs(res.phi_at_sources()).mean()),
        phi_src_max_abs=float(np.abs(res.phi_at_sources()).max()),
        negative_share=float((phi < 0).mean()))), flush=True)


def main() -> int:
    mesh = read_geometry(KNOT)
    base = SignedHeatOptions(disk_cache=False)
    print(f"jax {jax.__version__} on {jax.default_backend()}, x64 "
          f"{jax.config.jax_enable_x64}", flush=True)
    run("knot_dec vertex path", mesh, base.with_(use_crouzeix_raviart=False))
    cloud = PointCloud(mesh.vertices.copy(), vertex_normals(mesh))
    print(json.dumps(dict(case="knot_dec vertex normals", points=int(cloud.n_points),
                          normals_checksum=normals_checksum(cloud.normals))), flush=True)
    run("knot_dec point cloud, NONE", cloud,
        base.with_(level_set_constraint=LevelSetConstraint.NONE))
    return 0


if __name__ == "__main__":
    sys.exit(main())
