"""Steps 1 & 2: Yukawa vector diffusion + normalization (port of
shm3d.ops.yukawa).

For each query q:  X(q) = sum_s v_s exp(-lam |q - p_s|) / |q - p_s|, with
v_s the area-weighted source normals; Step 2 returns X/|X|.  Evaluated
relative to the per-query minimum m of lam*r so far queries do not
underflow in float32 (the normalized direction is invariant to exp(-m)).

- ``yukawa_field_torch``: the plain PyTorch version, the same formula as
  ``shm3d.ops.yukawa.yukawa_field_xla``, tiled over queries.
- ``yukawa_partials_torch`` / ``yukawa_merge_torch``: the plain version of
  the kernel's split over source chunks (per chunk a reference m_k and the
  sum relative to it, in log2 units; then the merge in chunk order).
- ``yukawa_field_cuda``: wrapper of the hand-written Hopper kernels
  (``shm3d_torch/csrc/yukawa.cu``: the chunked partial sums and their
  merge); float32 CUDA tensors only.
- ``yukawa_field``: dispatch on the tensor's device -- CPU tensors take the
  plain version, CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

# Source padding of the plain version's fixed-shape callers: exp(-lam*r)
# underflows to exactly 0 while 3*_FAR^2 stays finite in float32.
_FAR = 1e17

LOG2E = 1.4426950408889634  # exponents of the chunked form are in log2 units

# Launches of the CUDA kernel in this process (incremented by
# ``yukawa_field_cuda`` only, once per call; a call launches the partial
# kernel and its merge).
KERNEL_LAUNCHES = 0


def pad_sources(points: torch.Tensor, vectors: torch.Tensor, block: int):
    """Pad (S, 3) source arrays to a multiple of ``block`` rows with entries
    that contribute exactly zero (far points, zero vectors)."""
    pad = -points.shape[0] % block
    if pad == 0:
        return points, vectors
    far = points.new_full((pad, 3), _FAR)
    zero = vectors.new_zeros((pad, 3))
    return torch.cat([points, far]), torch.cat([vectors, zero])


def yukawa_field_torch(
    queries: torch.Tensor,
    src_points: torch.Tensor,
    src_vectors: torch.Tensor,
    lam,
    q_tile: int = 2048,
    normalize: bool = True,
) -> torch.Tensor:
    """Plain PyTorch Steps 1-2 on any device, in the queries' dtype.

    queries (Q, 3); src_points / src_vectors (S, 3); returns (Q, 3).  Each
    query tile materializes (q_tile, S) temporaries."""
    dtype = queries.dtype
    sp = src_points.to(dtype)
    sv = src_vectors.to(dtype)
    lam_t = torch.as_tensor(lam, dtype=dtype, device=queries.device)
    tiny = torch.finfo(dtype).tiny
    out = torch.empty_like(queries)
    for i in range(0, queries.shape[0], q_tile):
        q = queries[i:i + q_tile]
        dx = q[:, 0:1] - sp[None, :, 0]
        dy = q[:, 1:2] - sp[None, :, 1]
        dz = q[:, 2:3] - sp[None, :, 2]
        # r2 == 0 (a query on a source) would give rsqrt = inf and
        # b = 0*inf = NaN; clamping keeps the coincident source dominant
        r2 = torch.clamp_min(dx * dx + dy * dy + dz * dz, tiny)
        inv = torch.rsqrt(r2)
        b = (lam_t * r2) * inv  # lam * r
        m = torch.amin(b, dim=1, keepdim=True)
        X = (torch.exp(m - b) * inv) @ sv
        if normalize:
            X = X / torch.linalg.vector_norm(X, dim=1, keepdim=True)
        else:
            X = X * torch.exp(-m)
        out[i:i + q_tile] = X
    return out


def yukawa_partials_torch(
    queries: torch.Tensor,
    src_points: torch.Tensor,
    src_vectors: torch.Tensor,
    lam,
    chunk: int,
    q_tile: int = 2048,
) -> torch.Tensor:
    """Plain PyTorch partial sums over source chunks [k chunk, (k+1) chunk),
    in the queries' dtype: (C, Q, 4) holding, per chunk and query,
    m_k = lam log2(e) min r and a_k = sum v exp2(m_k - lam log2(e) r) / r
    (the kernel's reference moves within a chunk; the sum is the same up to
    rounding)."""
    dtype = queries.dtype
    sp = src_points.to(dtype)
    sv = src_vectors.to(dtype)
    lam2 = float(lam) * LOG2E
    tiny = torch.finfo(dtype).tiny
    S = sp.shape[0]
    n_chunks = -(-S // chunk)
    out = torch.empty((n_chunks, queries.shape[0], 4), dtype=dtype, device=queries.device)
    for i in range(0, queries.shape[0], q_tile):
        q = queries[i:i + q_tile]
        for k in range(n_chunks):
            p = sp[k * chunk:(k + 1) * chunk]
            d = q[:, None, :] - p[None, :, :]
            r2 = torch.clamp_min((d * d).sum(dim=2), tiny)
            r = torch.sqrt(r2)
            b = lam2 * r
            m = torch.amin(b, dim=1, keepdim=True)
            a = (torch.exp2(m - b) / r) @ sv[k * chunk:(k + 1) * chunk]
            out[k, i:i + q_tile] = torch.cat([m, a], dim=1)
    return out


def yukawa_merge_torch(partials: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """Merge (C, Q, 4) chunk partials in chunk order: m = min m_k,
    X = sum a_k exp2(m - m_k); returns X / |X| or X exp2(-m), (Q, 3)."""
    m = partials[..., 0].amin(dim=0)
    X = torch.zeros_like(partials[0, :, 1:])
    for k in range(partials.shape[0]):
        X = X + partials[k, :, 1:] * torch.exp2(m - partials[k, :, 0])[:, None]
    if normalize:
        return X / torch.linalg.vector_norm(X, dim=1, keepdim=True)
    return X * torch.exp2(-m)[:, None]


def _check_cuda_f32(name: str, t: torch.Tensor, device: torch.device):
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor on {device}, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernel takes float32, got {t.dtype}")
    if t.dim() != 2 or t.shape[1] != 3:
        raise ValueError(f"{name}: expected shape (N, 3), got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


def yukawa_chunk_len(Q: int, S: int, device) -> int:
    """Sources a chunk of the kernel's split holds for Q queries and S
    sources on a CUDA ``device`` (a multiple of 256): the split that fills
    the card (``shm3d_yukawa_chunk_len`` in csrc/yukawa.cu)."""
    from .._build import load_library

    chunk = load_library().shm3d_yukawa_chunk_len(Q, S, _index(torch.device(device)))
    if chunk <= 0:
        raise RuntimeError("yukawa kernel: the device's occupancy query failed")
    return int(chunk)


def yukawa_field_cuda(
    queries: torch.Tensor,
    src_points: torch.Tensor,
    src_vectors: torch.Tensor,
    lam: float,
    normalize: bool = True,
) -> torch.Tensor:
    """Launch the Hopper kernel on the current stream (float32, contiguous
    (N, 3) CUDA tensors on one device).  Does not synchronize."""
    global KERNEL_LAUNCHES
    device = queries.device
    _check_cuda_f32("queries", queries, device)
    _check_cuda_f32("src_points", src_points, device)
    _check_cuda_f32("src_vectors", src_vectors, device)
    if src_points.shape != src_vectors.shape:
        raise ValueError("src_points and src_vectors must have the same shape")
    if src_points.shape[0] == 0:
        raise ValueError("at least one source is required")
    out = torch.empty_like(queries)
    if queries.shape[0] == 0:
        return out
    from .._build import load_library

    lib = load_library()
    Q, S = queries.shape[0], src_points.shape[0]
    chunk = yukawa_chunk_len(Q, S, device)
    part = torch.empty((-(-S // chunk), Q, 4), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.shm3d_yukawa_f32(
            ctypes.c_void_p(queries.data_ptr()),
            ctypes.c_void_p(src_points.data_ptr()),
            ctypes.c_void_p(src_vectors.data_ptr()),
            ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(part.data_ptr()),
            ctypes.c_int64(Q),
            ctypes.c_int64(S),
            ctypes.c_int64(chunk),
            ctypes.c_float(float(lam) * LOG2E),
            ctypes.c_int(1 if normalize else 0),
            ctypes.c_int(_index(device)),
            ctypes.c_void_p(stream),
        )
    if err != 0:
        msg = lib.shm3d_cuda_error_string(err).decode()
        raise RuntimeError(f"yukawa kernel launch failed: {msg} ({err})")
    KERNEL_LAUNCHES += 1
    return out


def yukawa_field(
    queries: torch.Tensor,
    src_points: torch.Tensor,
    src_vectors: torch.Tensor,
    lam,
    normalize: bool = True,
) -> torch.Tensor:
    """Steps 1-2 dispatch: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (which raises on what it does not take)."""
    if queries.device.type == "cpu":
        return yukawa_field_torch(queries, src_points, src_vectors, lam,
                                  normalize=normalize)
    if queries.device.type == "cuda":
        return yukawa_field_cuda(queries, src_points, src_vectors, float(lam),
                                 normalize=normalize)
    raise ValueError(f"unsupported device {queries.device}")
