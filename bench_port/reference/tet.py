"""Plain reference of the tet domain's default path
(``SignedHeatSolver("tet")`` on a triangle mesh: the conforming tet mesh,
the Crouzeix-Raviart face solve, ZERO_SET): the same discretization, solved
to float64 round-off.

The tet mesh is the program's output (``TetResult.mesh``), taken as data
and checked here by itself before anything is solved on it (``check_mesh``):
it tiles the bounding cube the domain states, its input vertices are mesh
vertices, the mesh faces found on the input triangles tile each triangle
exactly (the surface is recovered), and the tets along the surface are no
larger than the configuration's ``h_coef`` allows.  A mesh that fails
raises ``Rejected``, and the run is not correct.

Host, written out here: the input triangles' one-point quadrature
(barycenters, vector areas), the mesh's faces and outward face normals,
its CR operators (stiffness with the sliver caps, mass, face-to-vertex
averaging, the face divergence), the L2 projection's shift and its
mass-starved vertices.  Card, in float64: the Yukawa field at the tet
barycenters (``common.yukawa_unit``), the integrated divergence onto the
faces, the face solve L phi = div on the faces off the surface with
phi = 0 on the surface faces, and the projection
(A^T M A + shift I) w = A^T M phi, both by Jacobi-preconditioned conjugate
gradient on torch's sparse CSR products; then the repair of mass-starved
vertices on the host.
"""

from __future__ import annotations

import math
import time
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch
from scipy.spatial import cKDTree

from . import common

DEFAULTS = dict(h_coef=0.0, scale=2.0, t_coef=1.0)
TOL = {torch.float64: 1e-12, torch.float32: 1e-6, torch.bfloat16: 4e-3}
MAXITER = 200000

# the CR stiffness's sliver caps: each tet's volume floored at this share
# of the median tet's, and its largest |n_j . n_k| / vol capped at this
# multiple of the median tet's
VOL_FLOOR_REL = 1e-3
COUPLING_CAP_REL = 1e3
# the projection's regularization and the mass-starved vertices
PROJ_SHIFT_REL = 1e-8
PROJ_WEAK_REL = 1e-6
# the mesh checks.  The program's mesher places its vertices on a lattice
# of 2^-28 of the cube's side (the input vertices move by up to 3.7e-9 of
# the half side on bunny_dec), so a point lies on an input triangle within
# ON_PLANE_REL of the half side, and the faces on a triangle add up to its
# area within AREA_REL; the tets' volumes add up to the cube's within
# VOLUME_REL.  The largest tet along the surface may exceed the
# configuration's largest volume by BAND_VOLUME_SLACK: the mesher snaps
# lattice vertices onto input vertices, which nearly doubles a tet beside
# them (1.93 times the lattice's tet on bunny_dec, 1.92 on knot_dec at
# h_coef 1), and rounds its cells per axis to a multiple of 8 (66 -> 64:
# 1.10).  knot_dec at h_coef 1 reads 2.05; a mesh one step of h_coef
# coarser would read 3.06 by the lattice's scaling
ON_PLANE_REL = 1e-7
AREA_REL = 1e-5
VOLUME_REL = 1e-8
BAND_VOLUME_SLACK = 2.5


class Rejected(ValueError):
    """The program's mesh is not a discretization of the stated domain."""


def quadrature(verts: np.ndarray, faces: np.ndarray):
    """The input triangles' barycenters and vector areas (area times unit
    normal)."""
    a, b, c = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    return (a + b + c) / 3.0, 0.5 * np.cross(b - a, c - a)


def mesh_faces(tets: np.ndarray):
    """The mesh's faces, each once, as sorted vertex triples, and for each
    tet corner j the index of the face opposite it."""
    opp = np.array([[1, 2, 3], [0, 2, 3], [0, 1, 3], [0, 1, 2]])
    slots = np.sort(tets[:, opp], axis=2).reshape(-1, 3)
    faces, tet_face = np.unique(slots, axis=0, return_inverse=True)
    return faces, tet_face.reshape(-1, 4)


def outward_normals(verts: np.ndarray, tets: np.ndarray) -> np.ndarray:
    """(NT, 4, 3): for each tet corner j, the outward normal of the face
    opposite it, times that face's area."""
    p = verts[tets]
    out = np.empty_like(p)
    opp = ((1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2))
    for j, (a, b, c) in enumerate(opp):
        n = 0.5 * np.cross(p[:, b] - p[:, a], p[:, c] - p[:, a])
        inward = np.einsum("ij,ij->i", n, p[:, j] - p[:, a]) > 0
        out[:, j] = np.where(inward[:, None], -n, n)
    return out


def on_triangles(verts: np.ndarray, tri: np.ndarray, tol: float):
    """(vertex, triangle) pairs of the mesh vertices lying on each input
    triangle (``tri``: (T, 3, 3) corners), within ``tol`` of its plane and
    inside it."""
    tree = cKDTree(verts)
    pv, pt = [], []
    for t, (a, b, c) in enumerate(tri):
        ctr = (a + b + c) / 3.0
        r = max(np.linalg.norm(a - ctr), np.linalg.norm(b - ctr), np.linalg.norm(c - ctr))
        idx = np.asarray(tree.query_ball_point(ctr, r + tol), np.int64)
        if idx.size == 0:
            continue
        e1, e2 = b - a, c - a
        n = np.cross(e1, e2)
        nn = float(n @ n)
        if nn == 0.0:
            continue
        w = verts[idx] - a
        near = np.abs(w @ n) <= tol * math.sqrt(nn)
        # barycentric coordinates of the projection onto the plane
        u = (np.cross(w, e2) @ n) / nn
        v = (np.cross(e1, w) @ n) / nn
        eps = tol / math.sqrt(math.sqrt(nn))
        inside = near & (u >= -eps) & (v >= -eps) & (u + v <= 1.0 + eps)
        pv.append(idx[inside])
        pt.append(np.full(int(inside.sum()), t, np.int64))
    if not pv:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(pv), np.concatenate(pt)


def surface_faces(verts, faces, tri, tol):
    """(face ids, their input triangles) of the mesh faces whose three
    vertices lie on one input triangle."""
    pv, pt = on_triangles(verts, tri, tol)
    T = tri.shape[0]
    keys = np.unique(pv * T + pt)
    on = np.zeros(verts.shape[0], bool)
    on[pv] = True
    cand = np.nonzero(on[faces].all(axis=1))[0]
    # each candidate face against each triangle its first vertex lies on
    order = np.argsort(pv, kind="stable")
    sv, st = pv[order], pt[order]
    lo = np.searchsorted(sv, faces[cand, 0], "left")
    hi = np.searchsorted(sv, faces[cand, 0], "right")
    reps = hi - lo
    f = np.repeat(cand, reps)
    t = st[np.concatenate([np.arange(a, b) for a, b in zip(lo, hi)])] if f.size else f
    ok = (np.isin(faces[f, 1] * T + t, keys, assume_unique=False)
          & np.isin(faces[f, 2] * T + t, keys, assume_unique=False))
    f, t = f[ok], t[ok]
    f, first = np.unique(f, return_index=True)
    return f, t[first]


def check_mesh(verts, tets, src_verts, src_faces, o) -> dict:
    """The program's mesh, checked as a discretization of the stated
    domain; returns its faces and surface.  Raises ``Rejected``."""
    c = src_verts.mean(axis=0)
    s = float(np.linalg.norm(src_verts - c, axis=1).max()) * o["scale"]
    tol = ON_PLANE_REL * s
    # the input vertices are mesh vertices
    d, _ = cKDTree(verts).query(src_verts)
    if d.max() > tol:
        raise Rejected(f"an input vertex is {d.max():.3e} from every mesh vertex")
    p = verts[tets]
    vol = np.einsum("ij,ij->i", np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]),
                    p[:, 3] - p[:, 0]) / 6.0
    if (vol <= 0).any():
        raise Rejected(f"{int((vol <= 0).sum())} tets of no positive volume")
    # the tets tile the cube [c - s, c + s]^3: each face is shared by two
    # tets, or lies on the cube's boundary, and the volumes add up to it
    faces, tet_face = mesh_faces(tets)
    count = np.bincount(tet_face.ravel(), minlength=faces.shape[0])
    if count.max() > 2:
        raise Rejected("a face shared by more than two tets")
    fp = verts[faces[count == 1]]
    lo, hi = c - s, c + s
    on_box = ((np.abs(fp - lo) <= tol).all(axis=1) | (np.abs(fp - hi) <= tol).all(axis=1)).any(axis=1)
    if not on_box.all():
        raise Rejected(f"{int((~on_box).sum())} faces of one tet inside the cube")
    if abs(vol.sum() - (2 * s) ** 3) > VOLUME_REL * (2 * s) ** 3:
        raise Rejected(f"the tets' volume {vol.sum():.12e} is not the cube's {(2 * s) ** 3:.12e}")
    # the surface is recovered: the faces on each input triangle tile it
    tri = src_verts[src_faces]
    surf, parent = surface_faces(verts, faces, tri, tol)
    fa = 0.5 * np.linalg.norm(np.cross(verts[faces[surf, 1]] - verts[faces[surf, 0]],
                                       verts[faces[surf, 2]] - verts[faces[surf, 0]]), axis=1)
    ta = 0.5 * np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1)
    covered = np.bincount(parent, weights=fa, minlength=tri.shape[0])
    bad = np.abs(covered - ta) > AREA_REL * ta
    if bad.any():
        raise Rejected(f"{int(bad.sum())} input triangles not tiled by mesh faces")
    # the resolution: TetGen's largest volume 2^-h_coef x the mean input
    # triangle area, along the surface (the far field may grade coarser)
    maxvol = 2.0 ** -o["h_coef"] * float(ta.mean())
    band = np.zeros(verts.shape[0], bool)
    band[faces[surf].ravel()] = True
    largest = float(vol[band[tets].any(axis=1)].max())
    if largest > BAND_VOLUME_SLACK * maxvol:
        raise Rejected(f"a tet along the surface of volume {largest:.4e} against "
                       f"{maxvol:.4e} at h_coef {o['h_coef']}")
    return dict(faces=faces, tet_face=tet_face, surface=surf, vol=vol,
                band_volume=largest, max_volume=maxvol)


def cr_operators(verts, tets, faces, tet_face, vol):
    """The CR stiffness L (n_j . n_k / vol per tet, the diagonal making each
    row sum to zero, with the sliver caps), mass M (0.4 vol on the diagonal,
    -0.05 vol off it), the averaging A from faces to their three vertices,
    and the outward normals of the face divergence."""
    nf, nv = faces.shape[0], verts.shape[0]
    nrm = outward_normals(verts, tets)
    med = float(np.median(vol))
    inv_vol = 1.0 / np.maximum(vol, max(VOL_FLOOR_REL * med, 1e-300))
    pairs = [(j, k) for j in range(4) for k in range(j + 1, 4)]
    dots = np.stack([np.einsum("ij,ij->i", nrm[:, j], nrm[:, k]) for j, k in pairs], axis=1)
    raw = np.abs(dots).max(axis=1) * inv_vol
    cap = COUPLING_CAP_REL * float(np.median(raw[raw > 0]))
    inv_vol = inv_vol * np.minimum(1.0, cap / np.maximum(raw, 1e-300))
    w = dots * inv_vol[:, None]
    fj = np.stack([tet_face[:, j] for j, _ in pairs], axis=1).ravel()
    fk = np.stack([tet_face[:, k] for _, k in pairs], axis=1).ravel()
    w = w.ravel()
    L = sp.coo_matrix((np.concatenate([w, w, -w, -w]),
                       (np.concatenate([fj, fk, fj, fk]), np.concatenate([fk, fj, fj, fk]))),
                      shape=(nf, nf)).tocsr()
    mw = -0.05 * np.repeat(vol, 6)
    M = sp.coo_matrix((np.concatenate([0.4 * np.repeat(vol, 4), mw, mw]),
                       (np.concatenate([tet_face.ravel(), fj, fk]),
                        np.concatenate([tet_face.ravel(), fk, fj]))), shape=(nf, nf)).tocsr()
    A = sp.csr_matrix((np.full(3 * nf, 1.0 / 3.0), faces.ravel(), np.arange(0, 3 * nf + 1, 3)),
                      shape=(nf, nv))
    return L, M, A, nrm


def mean_node_spacing(verts, tets) -> float:
    """The mean distance between the barycenters of a tet's four faces,
    over the tets' six pairs."""
    p = verts[tets]
    fb = (p.sum(axis=1, keepdims=True) - p) / 3.0
    acc = 0.0
    for j in range(4):
        for k in range(j + 1, 4):
            acc += np.linalg.norm(fb[:, j] - fb[:, k], axis=1).sum()
    return float(acc / (6 * tets.shape[0]))


def projection_regularization(p_diag: np.ndarray):
    pos = p_diag[p_diag > 0]
    med = float(np.median(pos)) if pos.size else 1.0
    return PROJ_SHIFT_REL * med, np.nonzero(p_diag < PROJ_WEAK_REL * med)[0].astype(np.int64)


def repair_mass_starved(w: np.ndarray, weak: np.ndarray, tets: np.ndarray,
                        sweeps: int = 3) -> np.ndarray:
    """Replace mass-starved vertices' projected values by the mean of their
    tet-edge neighbours (healthy neighbours preferred)."""
    if weak.size == 0:
        return w
    weak_set = {int(v) for v in weak}
    nbrs = {int(v): set() for v in weak}
    for t in tets[np.isin(tets, weak).any(axis=1)]:
        for v in t:
            if int(v) in weak_set:
                nbrs[int(v)].update(int(u) for u in t if int(u) != int(v))
    w = np.array(w, dtype=np.float64, copy=True)
    for _ in range(sweeps):
        for v in weak:
            nb = [u for u in nbrs[int(v)] if u not in weak_set] or list(nbrs[int(v)])
            if nb:
                w[int(v)] = float(np.mean(w[nb]))
    return w


def discretize(inputs: dict, opts: dict, port: Optional[dict] = None) -> dict:
    """The host half on the program's mesh (``port``: a solve's output with
    ``mesh_vertices`` and ``mesh_tets``): the mesh's checks, the
    quadrature, the CR operators."""
    if port is None or "mesh_tets" not in port:
        raise Rejected("the program returned no tet mesh")
    o = {**DEFAULTS, **{k: v for k, v in opts.items() if k in DEFAULTS}}
    src_v = np.asarray(inputs["vertices"], np.float64)
    src_f = np.asarray(inputs["faces"], np.int64)
    verts = np.asarray(port["mesh_vertices"], np.float64)
    tets = np.asarray(port["mesh_tets"], np.int64)
    m = check_mesh(verts, tets, src_v, src_f, o)
    faces, tet_face, vol = m["faces"], m["tet_face"], m["vol"]
    barys, vectors = quadrature(src_v, src_f)
    L, M, A, nrm = cr_operators(verts, tets, faces, tet_face, vol)
    lam = math.sqrt(1.0 / (o["t_coef"] * mean_node_spacing(verts, tets) ** 2))
    AtM = (A.T @ M).tocsr()
    P = (AtM @ A).tocsr()
    p_diag = np.asarray(P.diagonal())
    shift, weak = projection_regularization(p_diag)
    mask = np.ones(faces.shape[0])
    mask[m["surface"]] = 0.0
    # the face solve on the faces off the surface: mask L mask + (1 - mask)
    Dm = sp.diags(mask)
    Lm = (Dm @ L @ Dm + sp.diags(1.0 - mask)).tocsr()
    return dict(verts=verts, tets=tets, tet_face=tet_face, nrm=nrm, points=barys,
                vectors=vectors, lam=lam, L_nnz=int(L.nnz), Lm=Lm, AtM=AtM, P=P,
                p_diag=p_diag, shift=shift, weak=weak, mask=mask,
                n_surface=int(m["surface"].size), band_volume=m["band_volume"],
                max_volume=m["max_volume"])


def _spmv(M, dt, device):
    """x -> M x on the card in ``dt``, by torch's sparse CSR product; in
    bfloat16 the values are stored in bfloat16 and each product accumulates
    in float32 (torch has no bfloat16 sparse product), its result stored
    in bfloat16."""
    M = M.tocsr()
    M.sort_indices()
    cdt = common.factor_dtype(dt)
    T = torch.sparse_csr_tensor(
        torch.as_tensor(M.indptr, dtype=torch.int64), torch.as_tensor(M.indices, dtype=torch.int64),
        torch.as_tensor(M.data).to(dt).to(cdt), size=M.shape,
        check_invariants=False).to(device=device)
    return lambda x: (T @ x.to(cdt)).to(dt)


def solve(inputs: dict, opts: dict, device, control: Optional[str] = None,
          disc: Optional[dict] = None, port: Optional[dict] = None) -> dict:
    """The reference's solve of ``inputs`` on the program's mesh (in
    float64, or in a control's precision); ``disc``: the host half already
    made by ``discretize``."""
    t0 = time.perf_counter()
    d = discretize(inputs, opts, port) if disc is None else disc
    verts, tets, tet_face = d["verts"], d["tets"], d["tet_face"]
    Lm, AtM, P, p_diag, shift, mask = (d[k] for k in ("Lm", "AtM", "P", "p_diag", "shift",
                                                      "mask"))
    nf, nv, nt = Lm.shape[0], verts.shape[0], tets.shape[0]
    t_host = time.perf_counter() - t0
    with common.precision(control) as dt:
        put = lambda a: torch.as_tensor(np.asarray(a), device=device).to(dt)
        Y = common.yukawa_unit(put(verts[tets].mean(axis=1)), put(d["points"]),
                               put(d["vectors"]), d["lam"])
        div = torch.zeros(nf, dtype=dt, device=device).index_add_(
            0, torch.as_tensor(tet_face.ravel(), dtype=torch.int64, device=device),
            (put(d["nrm"]) * Y[:, None, :]).sum(dim=2).reshape(-1))
        b = put(mask) * div
        dL = put(np.where(Lm.diagonal() > 0, Lm.diagonal(), 1.0))
        phi_f, it1, rel1 = common.cg(_spmv(Lm, dt, device), b, TOL[dt], MAXITER,
                                     precond=lambda r: r / dL, check_every=100)
        dP = put(np.where(np.abs(p_diag) > 0, p_diag, 1.0) + shift)
        rhs = _spmv(AtM, dt, device)(phi_f)
        w, it2, rel2 = common.cg(_spmv(P + shift * sp.eye(nv), dt, device), rhs, TOL[dt],
                                 MAXITER, precond=lambda r: r / dP, check_every=100)
        w = repair_mass_starved(w.double().cpu().numpy(), d["weak"], tets)
        out = dict(Y=Y.double().cpu().numpy(), phi=w, mesh_vertices=verts, mesh_tets=tets)
    out["info"] = dict(
        n_sources=int(d["points"].shape[0]), n_tets=int(nt), k1_queries=int(nt),
        n_faces=int(nf), n_vertices=int(nv), n_surface_faces=d["n_surface"],
        band_volume=d["band_volume"], max_volume=d["max_volume"], L_nnz=d["L_nnz"],
        face_iters=int(it1), face_rel_res=float(rel1), proj_iters=int(it2),
        proj_rel_res=float(rel2), host_s=t_host, total_s=time.perf_counter() - t0)
    return out


NUMBERS = ("y_rms", "y_max", "phi_min", "phi_top", "phi_mean", "phi_rel", "phi_max")


def numbers(port: dict, ref: dict) -> dict:
    """The program's solve against the reference: the unit field's root
    mean square and largest error over the barycenters; the relative errors
    of phi's minimum (the interior's deepest point), its maximum and its
    mean magnitude over the vertices (the statistics this repository has
    held the tet path to since PR 2); phi's relative L2 error and its
    largest error relative to the largest |phi|.  A solve on another mesh
    than the one the reference checked and solved on compares as inf."""
    Yp = np.asarray(port["Y"], np.float64)
    phip = np.asarray(port["phi"], np.float64)
    same = (Yp.shape == ref["Y"].shape and phip.shape == ref["phi"].shape
            and np.array_equal(np.asarray(port.get("mesh_tets")), ref["mesh_tets"])
            and np.array_equal(np.asarray(port.get("mesh_vertices")), ref["mesh_vertices"]))
    if not same:
        return {k: math.inf for k in NUMBERS}
    dY = np.linalg.norm(Yp - ref["Y"], axis=1)
    phir = ref["phi"]
    dphi = phip - phir
    rel = lambda a, b: float(abs(a - b) / abs(b))
    return {
        "y_rms": float(np.sqrt(np.mean(dY ** 2))),
        "y_max": float(dY.max()),
        "phi_min": rel(phip.min(), phir.min()),
        "phi_top": rel(phip.max(), phir.max()),
        "phi_mean": rel(np.abs(phip).mean(), np.abs(phir).mean()),
        "phi_rel": float(np.linalg.norm(dphi) / np.linalg.norm(phir)),
        "phi_max": float(np.abs(dphi).max() / np.abs(phir).max()),
    }
