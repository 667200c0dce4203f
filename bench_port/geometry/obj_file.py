"""A triangle mesh read from an OBJ file under ``bench_port/``, as it is
stored (``file``).  The seed draws nothing: the mesh is the input of every
run."""

from __future__ import annotations

from pathlib import Path

import numpy as np

BENCH_DIR = Path(__file__).resolve().parents[1]


def read_obj(path: Path):
    """(vertices (V, 3) float64, faces (F, 3) int64) of a triangle OBJ
    (``v`` and ``f`` lines; ``a/b/c`` tokens and negative indices)."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "v":
                verts.append([float(t) for t in tok[1:4]])
            elif tok[0] == "f":
                idx = [int(t.split("/")[0]) for t in tok[1:]]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                if len(idx) != 3:
                    raise ValueError(f"{path}: a face of {len(idx)} vertices")
                faces.append(idx)
    return np.asarray(verts, np.float64), np.asarray(faces, np.int64)


def make(params: dict, rng: np.random.Generator) -> dict:
    verts, faces = read_obj(BENCH_DIR / params["file"])
    return {"kind": "mesh", "vertices": verts, "faces": faces}
