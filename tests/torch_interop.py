"""Inputs carried between the JAX package and the port in the tests: the
same arrays, each package's own option, geometry and mesh types (the port's
entry points refuse the JAX package's)."""

import dataclasses

from shm3d import config as jcfg
from shm3d.io import mesh_io as jio
from shm3d.tet.mesher import TetMesh as JaxTetMesh
from shm3d_torch.io import mesh_io as tio
from shm3d_torch.tet.mesher import TetMesh


def _options(opts, cfg):
    kw = {f.name: getattr(opts, f.name) for f in dataclasses.fields(opts)}
    kw["level_set_constraint"] = cfg.LevelSetConstraint(opts.level_set_constraint.value)
    return cfg.SignedHeatOptions(**kw)


def _geom(geom, io):
    if hasattr(geom, "positions"):
        return io.PointCloud(geom.positions, geom.normals)
    return io.Mesh(geom.vertices, geom.faces, geom.degrees)


def jax_options(opts):
    return _options(opts, jcfg)


def jax_geom(geom):
    return _geom(geom, jio)


def port_geom(geom):
    return _geom(geom, tio)


def port_tetmesh(mesh) -> TetMesh:
    return TetMesh.from_fields(mesh)


def jax_tetmesh(mesh) -> JaxTetMesh:
    return JaxTetMesh(**{f.name: getattr(mesh, f.name)
                         for f in dataclasses.fields(JaxTetMesh)})
