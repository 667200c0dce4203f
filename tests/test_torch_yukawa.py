"""Port Steps 1-2 (shm3d_torch.ops.yukawa) against shm3d.ops.yukawa.

On the CPU the port runs its plain PyTorch version; it is compared in
float64 with ``yukawa_field_xla`` and with the Pallas kernel in interpret
mode, tolerance 1e-12: the same formula in the same precision, differing
only in summation order (the Pallas kernel also in its per-block rescale).
The CUDA kernel against the plain version runs only where a card is
present (marked ``cuda``; ``python3 chip_smoke.py`` runs the same checks at
the main path's shapes)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shm3d.domains import grid as jgriddom
from shm3d.ops import farfield as jfarfield
from shm3d.ops.yukawa import yukawa_field_pallas, yukawa_field_xla
from shm3d_torch.domains import grid as griddom
from shm3d_torch.geometry import sources as src_mod
from shm3d_torch.geometry.procedural import make_icosphere
from shm3d_torch.io.mesh_io import PointCloud
from shm3d_torch.ops import farfield, yukawa

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def src():
    s = src_mod.from_mesh(make_icosphere(1))
    return s.points, s.vectors()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    from shm3d_torch._device import resolve_device

    return resolve_device("cuda")


def _torch(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


@pytest.mark.parametrize("nq", [1, 130, 257])
@pytest.mark.parametrize("normalize", [True, False])
def test_plain_matches_xla_f64(src, nq, normalize):
    pts, vecs = src
    q = np.random.default_rng(nq).uniform(-2, 2, size=(nq, 3))
    lam = 3.1
    got = yukawa.yukawa_field_torch(_torch(q), _torch(pts), _torch(vecs), lam,
                                    q_tile=64, normalize=normalize).numpy()
    ref = np.asarray(yukawa_field_xla(jnp.asarray(q), jnp.asarray(pts),
                                      jnp.asarray(vecs), lam, q_tile=64,
                                      normalize=normalize))
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12 * np.abs(ref).max())


def test_plain_matches_pallas_interpret_f64(src):
    """Ragged Q (130) and ragged S (the icosphere's 80 faces against 32-wide
    source blocks), as tests/test_device_grid.py runs the Pallas kernel."""
    pts, vecs = src
    q = np.random.default_rng(4).uniform(-2, 2, size=(130, 3))
    lam = 2.0
    ref = np.asarray(yukawa_field_pallas(
        jnp.asarray(q, jnp.float64), jnp.asarray(pts, jnp.float64),
        jnp.asarray(vecs, jnp.float64), lam, q_tile=64, s_block=32,
        interpret=True))
    got = yukawa.yukawa_field(_torch(q), _torch(pts), _torch(vecs), lam).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)


def test_query_on_source_is_finite_unit():
    """A query exactly on a source: r2 is clamped to tiny, so the direction
    is that source's vector, not 0 * inf = NaN."""
    pts = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], np.float32)
    vecs = np.array([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], np.float32)
    q = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]], np.float32)
    for dtype in (torch.float32, torch.float64):
        Y = yukawa.yukawa_field(_torch(q, dtype), _torch(pts, dtype),
                                _torch(vecs, dtype), 10.0).numpy()
        assert np.isfinite(Y).all()
        np.testing.assert_allclose(np.linalg.norm(Y, axis=1), 1.0, atol=1e-6)
        np.testing.assert_allclose(Y[0], [0.0, 0.0, 1.0], atol=1e-6)


def test_far_queries_large_lambda_stay_finite(src):
    """exp(-lam r) underflows to 0 in float32 for every source here (lam*r
    ~ 2e3); the per-query rescale keeps the direction finite and equal to
    the float64 result."""
    pts, vecs = src
    q = np.random.default_rng(5).normal(size=(64, 3))
    q = 40.0 * q / np.linalg.norm(q, axis=1, keepdims=True)
    lam = 50.0
    assert np.exp(np.float32(-lam * 39.0)) == 0.0
    got = yukawa.yukawa_field(_torch(q, torch.float32), _torch(pts, torch.float32),
                              _torch(vecs, torch.float32), lam).numpy()
    ref = yukawa.yukawa_field(_torch(q), _torch(pts), _torch(vecs), lam).numpy()
    assert np.isfinite(got).all()
    # float32 positions at |q| = 40 carry ~4e-6 absolute error, which lam
    # turns into relative weight changes of ~2e-4 between sources
    np.testing.assert_allclose(got, ref, atol=1e-3)


def test_padded_sources_contribute_nothing(src):
    pts, vecs = src
    q = _torch(np.random.default_rng(6).uniform(-2, 2, size=(33, 3)), torch.float32)
    p32, v32 = _torch(pts, torch.float32), _torch(vecs, torch.float32)
    pp, pv = yukawa.pad_sources(p32, v32, 64)
    assert pp.shape[0] % 64 == 0 and pp.shape[0] > p32.shape[0]
    for normalize in (True, False):
        a = yukawa.yukawa_field_torch(q, p32, v32, 2.0, normalize=normalize)
        b = yukawa.yukawa_field_torch(q, pp, pv, 2.0, normalize=normalize)
        assert torch.equal(a, b)


def test_shell_field_matches_shm3d_f64():
    """Shell-decomposed Steps 1-2 at 32^3 from shm3d's own ShellPlan (the
    port's copied builder gives the same plan), tolerance 1e-12: the exact
    rows are the plain version, the rest three (n, m) products."""
    mesh = make_icosphere(2)
    cloud = PointCloud(mesh.vertices.copy(),
                       mesh.vertices / np.linalg.norm(mesh.vertices, axis=1, keepdims=True))
    s = src_mod.from_geometry(cloud)
    grid = griddom.build_grid(cloud.positions, 2.0, 1.0)
    jgrid = jgriddom.build_grid(cloud.positions, 2.0, 1.0)
    # a sharper kernel than the heuristic, so a real far region exists
    lam = 4.0 / s.spacing
    jplan = jfarfield.build_shell_plan(jgrid, s.points, lam)
    tplan = farfield.build_shell_plan(grid, s.points, lam)
    for k, a in jplan.arrays().items():
        np.testing.assert_array_equal(tplan.arrays()[k], a, err_msg=k)
    assert 0 < jplan.shell_fraction < 1
    dplan = farfield.DeviceShellPlan.from_arrays(jplan.arrays(), "cpu", torch.float64)
    got = farfield.yukawa_field_shell(dplan, _torch(s.points), _torch(s.vectors()),
                                      lam, grid.n).numpy()
    ref = np.asarray(jfarfield.yukawa_field_shell(
        jplan, jnp.asarray(s.points), jnp.asarray(s.vectors()), lam, grid.n))
    assert got.shape == (grid.total_nodes, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


@pytest.mark.parametrize("chunk", [1, 7, 32, 80])
@pytest.mark.parametrize("normalize", [True, False])
def test_chunked_plain_matches_xla_f64(src, chunk, normalize):
    """The plain version of the kernel's source split (per-chunk partials in
    log2 units, merged in chunk order) against ``yukawa_field_xla`` in
    float64, 1e-12: the same sum regrouped (80 = every source in one
    chunk)."""
    pts, vecs = src
    q = np.random.default_rng(chunk).uniform(-2, 2, size=(130, 3))
    lam = 3.1
    part = yukawa.yukawa_partials_torch(_torch(q), _torch(pts), _torch(vecs), lam,
                                        chunk, q_tile=64)
    assert part.shape == (-(-pts.shape[0] // chunk), 130, 4)
    got = yukawa.yukawa_merge_torch(part, normalize=normalize).numpy()
    ref = np.asarray(yukawa_field_xla(jnp.asarray(q), jnp.asarray(pts),
                                      jnp.asarray(vecs), lam, q_tile=64,
                                      normalize=normalize))
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("case", ["ragged", "coincident", "far"])
def test_chunked_plain_matches_unchunked_f32(src, case):
    """float32: the chunked form against the unchunked plain version on the
    inputs of chip_smoke.py's kernel cases, 1e-5 on unit directions (float32
    sums regrouped).  Far from every source (|q| = 40, lam = 50) each
    exp(-lam r) underflows in float32; every row stays finite and of unit
    norm, as the merge keeps each chunk's nearest sources at weight ~1.
    There the float32 distances carry ~1e-7 * lam r ~ 2e-4 of exponent
    noise, and each version lies ~2.5e-5 from the float64 directions: the
    bound is chip_smoke.py's DIR_TOL, 1e-4."""
    rng = np.random.default_rng(3)
    pts, vecs = src
    lam = {"ragged": 7.5, "coincident": 10.0, "far": 50.0}[case]
    if case == "ragged":
        q = rng.uniform(-1, 1, (300, 3))
        pts = rng.uniform(-1, 1, (411, 3))
        vecs = rng.normal(size=(411, 3)) * 0.3
        vecs[:, 2] += 1.0
    elif case == "coincident":
        q = pts[:40]
    else:
        q = rng.normal(size=(64, 3))
        q = 40.0 * q / np.linalg.norm(q, axis=1, keepdims=True)
        assert np.exp(np.float32(-lam * 39.0)) == 0.0
    args = [_torch(a, torch.float32) for a in (q, pts, vecs)]
    ref = yukawa.yukawa_field_torch(*args, lam)
    for chunk in (7, 64):
        got = yukawa.yukawa_merge_torch(yukawa.yukawa_partials_torch(*args, lam, chunk))
        assert torch.isfinite(got).all()
        assert (torch.linalg.vector_norm(got, dim=1) - 1).abs().max() <= 1e-6
        assert (got - ref).abs().max() <= (1e-4 if case == "far" else 1e-5)


def test_cuda_wrapper_refuses_cpu_tensors(src):
    """The kernel wrapper launches only on CUDA tensors; it never falls back
    to the plain version."""
    pts, vecs = src
    q = _torch(np.zeros((4, 3)), torch.float32)
    before = yukawa.KERNEL_LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensor"):
        yukawa.yukawa_field_cuda(q, _torch(pts, torch.float32),
                                 _torch(vecs, torch.float32), 1.0)
    assert yukawa.KERNEL_LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1), (1000, 777), (4099, 5001)])
@pytest.mark.parametrize("normalize", [True, False])
def test_cuda_kernel_matches_plain(cuda_device, shape, normalize):
    """Kernel vs plain version on the card, float32.  Vectors share a +z
    bias so |X| does not cancel (cond <= ~3); tolerance 1e-5 absolute on
    unit directions, 1e-5 relative unnormalized: float32 sums of up to 5k
    terms in another order (chunks merged, a reference moved once a stage,
    vs one minimum per query tile).  One count a call (the partial kernel
    and its merge)."""
    nq, ns = shape
    rng = np.random.default_rng(nq + ns)
    q = torch.as_tensor(rng.uniform(-1, 1, (nq, 3)), dtype=torch.float32, device=cuda_device)
    p = torch.as_tensor(rng.uniform(-1, 1, (ns, 3)), dtype=torch.float32, device=cuda_device)
    v = rng.normal(size=(ns, 3)) * 0.3
    v[:, 2] += 1.0
    v = torch.as_tensor(v, dtype=torch.float32, device=cuda_device)
    before = yukawa.KERNEL_LAUNCHES
    got = yukawa.yukawa_field(q, p, v, 7.5, normalize=normalize)
    assert yukawa.KERNEL_LAUNCHES == before + 1
    ref = yukawa.yukawa_field_torch(q, p, v, 7.5, normalize=normalize)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    scale = 1.0 if normalize else ref.abs().max().item()
    assert err <= 1e-5 * scale, err


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["coincident", "far"])
def test_cuda_kernel_far_and_coincident(cuda_device, src, case):
    """Queries on sources, and queries so far away that every float32
    exp(-lam r) underflows (|q| = 40, lam = 50; the stage is summed again
    from a new reference): every row finite and of unit norm, within 1e-4
    of the plain version (chip_smoke.py's DIR_TOL: float32 distances at
    |q| = 40 carry ~1e-4 relative weight noise)."""
    pts, vecs = src
    rng = np.random.default_rng(12)
    if case == "coincident":
        q, lam = pts[:64], 10.0
    else:
        q = rng.normal(size=(3000, 3))
        q, lam = 40.0 * q / np.linalg.norm(q, axis=1, keepdims=True), 50.0
    args = [torch.as_tensor(np.asarray(a), dtype=torch.float32, device=cuda_device)
            for a in (q, pts, vecs)]
    got = yukawa.yukawa_field_cuda(*args, lam)
    ref = yukawa.yukawa_field_torch(*args, lam)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (torch.linalg.vector_norm(got, dim=1) - 1).abs().max().item() <= 1e-5
    assert (got - ref).abs().max().item() <= 1e-4
