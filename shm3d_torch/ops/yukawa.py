"""Steps 1 & 2: Yukawa vector diffusion + normalization (port of
shm3d.ops.yukawa).

For each query q:  X(q) = sum_s v_s exp(-lam |q - p_s|) / |q - p_s|, with
v_s the area-weighted source normals; Step 2 returns X/|X|.  Evaluated
relative to the per-query minimum m of lam*r so far queries do not
underflow in float32 (the normalized direction is invariant to exp(-m)).

- ``yukawa_field_torch``: the plain PyTorch version, the same formula as
  ``shm3d.ops.yukawa.yukawa_field_xla``, tiled over queries.
- ``yukawa_field_cuda``: wrapper of the hand-written Hopper kernel
  (``shm3d_torch/csrc/yukawa.cu``); float32 CUDA tensors only.
- ``yukawa_field``: dispatch on the tensor's device -- CPU tensors take the
  plain version, CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

# Source padding of the plain version's fixed-shape callers: exp(-lam*r)
# underflows to exactly 0 while 3*_FAR^2 stays finite in float32.
_FAR = 1e17

# Launches of the CUDA kernel in this process (incremented by
# ``yukawa_field_cuda`` only, once per launch).
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


def _check_cuda_f32(name: str, t: torch.Tensor, device: torch.device):
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor on {device}, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernel takes float32, got {t.dtype}")
    if t.dim() != 2 or t.shape[1] != 3:
        raise ValueError(f"{name}: expected shape (N, 3), got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


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
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.shm3d_yukawa_f32(
            ctypes.c_void_p(queries.data_ptr()),
            ctypes.c_void_p(src_points.data_ptr()),
            ctypes.c_void_p(src_vectors.data_ptr()),
            ctypes.c_void_p(out.data_ptr()),
            ctypes.c_int64(queries.shape[0]),
            ctypes.c_int64(src_points.shape[0]),
            ctypes.c_float(float(lam)),
            ctypes.c_int(1 if normalize else 0),
            ctypes.c_int(device.index if device.index is not None
                         else torch.cuda.current_device()),
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
