"""An oriented point cloud on a sphere: the Fibonacci lattice of
``points`` points (outward unit normals), turned about the sphere's center
by a fixed generic rotation (drawn once from ``base_seed``, so that no
lattice row lines up with the grid) and then by one of the 24 rotations of
the cube, chosen by the seed.  A rotation of the cube maps the grid built
around the cloud onto itself, and its arithmetic is exact (signs and
swaps), so every seed gives the same occupied cells, constraint rows and
shell: the same work, in another orientation."""

from __future__ import annotations

import numpy as np


def lattice(n: int) -> np.ndarray:
    """(n, 3) unit vectors of the Fibonacci lattice (the port's
    ``make_sphere_cloud``, written out here)."""
    i = np.arange(n, dtype=np.float64)
    golden = np.pi * (3.0 - np.sqrt(5.0))
    z = 1.0 - 2.0 * (i + 0.5) / n
    rho = np.sqrt(np.maximum(0.0, 1.0 - z * z))
    th = golden * i
    return np.stack([rho * np.cos(th), rho * np.sin(th), z], axis=1)


def rotation(rng: np.random.Generator) -> np.ndarray:
    """A rotation matrix drawn uniformly from SO(3)."""
    q = rng.standard_normal(4)
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def cube_rotations() -> list:
    """The 24 signed permutation matrices of determinant +1, in a fixed
    order (the identity first)."""
    import itertools

    out = []
    for perm in itertools.permutations(range(3)):
        for signs in itertools.product((1.0, -1.0), repeat=3):
            R = np.zeros((3, 3))
            R[np.arange(3), perm] = signs
            if np.linalg.det(R) > 0:
                out.append(R)
    return out


def make(params: dict, rng: np.random.Generator) -> dict:
    base = lattice(int(params["points"])) @ rotation(
        np.random.default_rng(int(params["base_seed"]))).T
    R = cube_rotations()[int(rng.integers(24))]
    normals = base @ R.T
    radius = float(params.get("radius", 1.0))
    return {"kind": "cloud", "positions": normals * radius, "normals": normals.copy(),
            "pose": R}
