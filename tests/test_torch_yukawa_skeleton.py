"""The Yukawa speed-of-light probe (shm3d_torch.ops.yukawa_skeleton) against
a NumPy float64 transcription of the TPU probe's per-pair arithmetic
(bench_kernels.py:_skeleton_pallas, its inner ``kernel``: r2, rsqrt, exp and
a row sum).  The TPU probe has no interpret switch, so the transcription
stands in for it.

- float64 plain version vs the transcription: 1e-12 relative to each row
  sum (the same terms summed in another order);
- float32 plain version: 1e-5 relative to each row sum (float32 sums of up
  to ~5k positive terms);
- sources padded as the TPU probe pads them (far points at 1e17) add
  exactly zero;
- the plain version of the kernel's split over source chunks: the chunks'
  partial row sums, added in chunk order, give the unsplit row sum within
  1e-12 (f64) or 1e-5 (float32) relative, for ragged and exact splits;
- on the card, kernel vs plain version in float32, 1e-5 relative to each
  row sum, on shapes that split into several source chunks too, and two
  launches bit for bit (the chunks merge in chunk order).
"""

import numpy as np
import pytest
import torch

from shm3d_torch.ops import yukawa_skeleton as ys

torch.set_num_threads(2)

LAM = 4.0  # bench_kernels.py's lambda


def _transcription(q, sp, lam):
    """bench_kernels.py:99-106 in NumPy float64; sp is (3, S) as there."""
    dx = q[:, 0:1] - sp[0:1, :]
    dy = q[:, 1:2] - sp[1:2, :]
    dz = q[:, 2:3] - sp[2:3, :]
    r2 = dx * dx + dy * dy + dz * dz
    inv = 1.0 / np.sqrt(r2)
    w = np.exp(-(lam * r2) * inv) * inv
    return w.sum(axis=1)


def _inputs(nq, ns, seed):
    rng = np.random.default_rng(seed)
    # bench_kernels.py's distributions: unit-normal queries, sources at 0.3
    return rng.standard_normal((nq, 3)), rng.standard_normal((ns, 3)) * 0.3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    from shm3d_torch._device import resolve_device

    return resolve_device("cuda")


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("shape", [(1, 1), (130, 257), (3001, 1025), (700, 5003)])
def test_plain_matches_transcription(shape, dtype, rtol):
    nq, ns = shape
    q, p = _inputs(nq, ns, nq + ns)
    ref = _transcription(q, p.T, LAM)
    got = ys.skeleton_sum_torch(torch.as_tensor(q, dtype=dtype),
                                torch.as_tensor(p, dtype=dtype), LAM, q_tile=512)
    assert got.shape == (nq,) and got.dtype == dtype
    np.testing.assert_array_less(np.abs(got.numpy() - ref), rtol * ref)


def test_far_padding_adds_zero():
    """The TPU probe pads the sources to a multiple of 1024 with points at
    1e17; in float32 they add exactly 0, so the port drops the padding."""
    q, p = _inputs(257, 1000, 7)
    pad = np.concatenate([p, np.full((24, 3), 1e17)])
    t = lambda a: torch.as_tensor(a, dtype=torch.float32)
    a = ys.skeleton_sum_torch(t(q), t(p), LAM)
    b = ys.skeleton_sum_torch(t(q), t(pad), LAM, q_tile=4096)
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("shape,chunk", [((130, 1025), 256), ((257, 5003), 1280),
                                         ((64, 1024), 256), ((5, 100), 256)])
def test_chunked_partials_sum_to_the_row_sum(shape, chunk, dtype, rtol):
    """Ragged last chunks, exact splits and a single chunk."""
    nq, ns = shape
    q, p = _inputs(nq, ns, nq + ns + chunk)
    qt, pt = torch.as_tensor(q, dtype=dtype), torch.as_tensor(p, dtype=dtype)
    parts = ys.skeleton_partials_torch(qt, pt, LAM, chunk)
    assert parts.shape == (-(-ns // chunk), nq) and parts.dtype == dtype
    merged = torch.zeros(nq, dtype=dtype)
    for part in parts:  # the merge kernel's order
        merged = merged + part
    ref = _transcription(q, p.T, LAM)
    np.testing.assert_array_less(np.abs(merged.numpy() - ref), rtol * ref)


def test_dispatch_on_cpu_is_plain_and_wrapper_refuses_cpu():
    q, p = _inputs(64, 300, 3)
    qt, pt = torch.as_tensor(q, dtype=torch.float32), torch.as_tensor(p, dtype=torch.float32)
    before = ys.KERNEL_LAUNCHES
    assert torch.equal(ys.skeleton_sum(qt, pt, LAM), ys.skeleton_sum_torch(qt, pt, LAM))
    with pytest.raises(ValueError, match="CUDA tensor"):
        ys.skeleton_sum_cuda(qt, pt, LAM)
    assert ys.KERNEL_LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1), (1000, 777), (4099, 5001), (70000, 8192),
                                   (3001, 52290), (36000, 20001)])
def test_cuda_kernel_matches_plain(cuda_device, shape):
    """Kernel vs plain version on the card, float32, 1e-5 relative to each
    row sum: the same positive terms summed in another order.  The last two
    shapes split into several source chunks; every launch repeats bit for
    bit."""
    nq, ns = shape
    q, p = _inputs(nq, ns, nq + ns)
    qt = torch.as_tensor(q, dtype=torch.float32, device=cuda_device)
    pt = torch.as_tensor(p, dtype=torch.float32, device=cuda_device)
    before = ys.KERNEL_LAUNCHES
    got = ys.skeleton_sum(qt, pt, LAM)
    assert ys.KERNEL_LAUNCHES == before + 1
    ref = ys.skeleton_sum_torch(qt, pt, LAM)
    again = ys.skeleton_sum(qt, pt, LAM)
    torch.cuda.synchronize()
    assert got.shape == (nq,) and bool(torch.isfinite(got).all())
    assert torch.equal(got, again)
    if ns > 20000:
        assert ys.skeleton_chunk_len(nq, ns, cuda_device) < ns
    rel = ((got - ref).abs() / ref).max().item()
    assert rel <= 1e-5, rel
