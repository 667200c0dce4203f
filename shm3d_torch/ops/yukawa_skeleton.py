"""The Yukawa kernel's speed-of-light probe (port of the inner ``kernel`` of
``bench_kernels.py:_skeleton_pallas``).

For each query q:  out(q) = sum_s exp(-lam |q - p_s|) / |q - p_s|, the
per-pair work of Steps 1-2 (``ops/yukawa.py``) without the running minimum,
the rescale and the vector accumulation.  It is a measurement yardstick:
the Yukawa kernel's time over this probe's, at the same shapes, is the share
of its time spent on bookkeeping.  No solve calls it.

- ``skeleton_sum_torch``: the plain PyTorch version, tiled over queries.
- ``skeleton_partials_torch``: the plain version of the kernel's split over
  source chunks (one partial row sum a chunk; the kernel's merge adds them
  in chunk order).
- ``skeleton_sum_cuda``: wrapper of the hand-written Hopper kernels
  (``shm3d_torch/csrc/yukawa_skeleton.cu``: the chunked partial row sums
  and their merge); float32 CUDA tensors only.
- ``skeleton_sum``: dispatch on the tensor's device -- CPU tensors take the
  plain version, CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from .yukawa import _check_cuda, _index

# Launches of the CUDA kernel in this process (incremented by
# ``skeleton_sum_cuda`` only, once per call; a call launches the partial
# kernel and, for more than one source chunk, its merge).
KERNEL_LAUNCHES = 0


def skeleton_sum_torch(queries: torch.Tensor, src_points: torch.Tensor, lam,
                       q_tile: int = 2048) -> torch.Tensor:
    """Plain PyTorch probe on any device, in the queries' dtype: queries
    (Q, 3), src_points (S, 3); returns (Q,).  r^2 is clamped to the dtype's
    smallest normal as in the kernel."""
    dtype = queries.dtype
    sp = src_points.to(dtype)
    lam_t = torch.as_tensor(lam, dtype=dtype, device=queries.device)
    tiny = torch.finfo(dtype).tiny
    out = queries.new_empty(queries.shape[0])
    for i in range(0, queries.shape[0], q_tile):
        q = queries[i:i + q_tile]
        dx = q[:, 0:1] - sp[None, :, 0]
        dy = q[:, 1:2] - sp[None, :, 1]
        dz = q[:, 2:3] - sp[None, :, 2]
        r2 = torch.clamp_min(dx * dx + dy * dy + dz * dz, tiny)
        inv = torch.rsqrt(r2)
        out[i:i + q_tile] = (torch.exp(-(lam_t * r2) * inv) * inv).sum(dim=1)
    return out


def skeleton_partials_torch(queries: torch.Tensor, src_points: torch.Tensor, lam,
                            chunk: int, q_tile: int = 2048) -> torch.Tensor:
    """Plain PyTorch partial row sums over source chunks
    [k chunk, (k+1) chunk): (C, Q), whose sum over C in chunk order is the
    kernel's output."""
    S = src_points.shape[0]
    return torch.stack([
        skeleton_sum_torch(queries, src_points[k:k + chunk], lam, q_tile=q_tile)
        for k in range(0, S, chunk)])


def skeleton_chunk_len(Q: int, S: int, device) -> int:
    """Sources a chunk of the kernel's split holds for Q queries and S
    sources on a CUDA ``device`` (a multiple of 256): the split that fills
    the card (``shm3d_yukawa_skeleton_chunk_len`` in
    csrc/yukawa_skeleton.cu)."""
    from .._build import load_library

    chunk = load_library().shm3d_yukawa_skeleton_chunk_len(
        Q, S, _index(torch.device(device)))
    if chunk <= 0:
        raise RuntimeError("yukawa skeleton kernel: the device's occupancy query failed")
    return int(chunk)


def skeleton_sum_cuda(queries: torch.Tensor, src_points: torch.Tensor,
                      lam: float) -> torch.Tensor:
    """Launch the Hopper kernels on the current stream (float32, contiguous
    (N, 3) CUDA tensors on one device).  Does not synchronize."""
    global KERNEL_LAUNCHES
    device = queries.device
    _check_cuda("queries", queries, device, torch.float32)
    _check_cuda("src_points", src_points, device, torch.float32)
    if src_points.shape[0] == 0:
        raise ValueError("at least one source is required")
    out = queries.new_empty(queries.shape[0])
    if queries.shape[0] == 0:
        return out
    from .._build import load_library

    lib = load_library()
    Q, S = queries.shape[0], src_points.shape[0]
    chunk = skeleton_chunk_len(Q, S, device)
    n_chunks = -(-S // chunk)
    # scratch of the chunks' partial row sums (one chunk writes to ``out``)
    part = torch.empty((n_chunks if n_chunks > 1 else 0, Q), dtype=torch.float32,
                       device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.shm3d_yukawa_skeleton_f32(
            ctypes.c_void_p(queries.data_ptr()),
            ctypes.c_void_p(src_points.data_ptr()),
            ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(part.data_ptr()),
            ctypes.c_int64(Q),
            ctypes.c_int64(S),
            ctypes.c_int64(chunk),
            ctypes.c_float(float(lam)),
            ctypes.c_int(_index(device)),
            ctypes.c_void_p(stream),
        )
    if err != 0:
        msg = lib.shm3d_cuda_error_string(err).decode()
        raise RuntimeError(f"yukawa skeleton kernel launch failed: {msg} ({err})")
    KERNEL_LAUNCHES += 1
    return out


def skeleton_sum(queries: torch.Tensor, src_points: torch.Tensor, lam) -> torch.Tensor:
    """Dispatch: the plain version for CPU tensors, the CUDA kernel for CUDA
    tensors (which raises on what it does not take)."""
    if queries.device.type == "cpu":
        return skeleton_sum_torch(queries, src_points, lam)
    if queries.device.type == "cuda":
        return skeleton_sum_cuda(queries, src_points, float(lam))
    raise ValueError(f"unsupported device {queries.device}")
