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
  merge), instantiated for float32 and float64 CUDA tensors (the three
  inputs in one of them; anything else raises).  The float32 pair runs on
  the MUFU approximations of exp2 and rsqrt; the float64 pair on
  libdevice's IEEE exp2 and rsqrt on the FP64 pipe, since MUFU has no
  float64 exponential and its float32 approximations would cost the
  float64 path 9 of its 16 digits.  ``yukawa_partials_cuda`` and
  ``yukawa_merge_cuda`` launch the two kernels one at a time (the ring
  schedule merges the partials of several source shards).
- ``yukawa_field``, ``yukawa_partials``, ``yukawa_merge``: dispatch on the
  tensor's device -- CPU tensors take the plain version, CUDA tensors
  launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..solve import graphs

# Source padding of the fixed-shape callers (the ring's source shards):
# exp(-lam*r) underflows to exactly 0 while 3*_FAR^2 stays finite, in
# float32 (3e34 < 3.4e38) and in float64.
_FAR = 1e17

LOG2E = 1.4426950408889634  # exponents of the chunked form are in log2 units

# Queries a block of the partial kernel in each precision (QBLOCK in
# csrc/yukawa_common.cuh, both instantiations): a query's sum depends on
# the block's other queries (a thread's four queries rebase together), so
# launches over rows split at multiples of it, with one chunk length, give
# each row the arithmetic of one launch.
_QUERY_BLOCKS = {torch.float32: 1024, torch.float64: 1024}
_KERNEL_DTYPES = tuple(_QUERY_BLOCKS)

# Launches of the CUDA kernels in this process, one count per
# instantiation: KERNEL_LAUNCHES (float32) and KERNEL_LAUNCHES_F64 count
# ``yukawa_field_cuda`` calls (each launches the partial kernel and its
# merge), PARTIAL_LAUNCHES[_F64] and MERGE_LAUNCHES[_F64] the split entry
# points ``yukawa_partials_cuda`` and ``yukawa_merge_cuda``, once per call
# each; a call while a CUDA graph is captured counts at each of the graph's
# replays instead (``_count``).
KERNEL_LAUNCHES = 0
PARTIAL_LAUNCHES = 0
MERGE_LAUNCHES = 0
KERNEL_LAUNCHES_F64 = 0
PARTIAL_LAUNCHES_F64 = 0
MERGE_LAUNCHES_F64 = 0


def _count(counter: str) -> None:
    """One launch counted in ``counter``: now or, while a CUDA graph is
    captured (which launches nothing), at each replay of the graph."""
    if not graphs.note_launch(__name__, counter):
        globals()[counter] += 1


def query_block(dtype: torch.dtype) -> int:
    """Queries a block of the partial kernel for ``dtype`` inputs."""
    if dtype not in _QUERY_BLOCKS:
        raise TypeError(f"the CUDA kernel takes float32 or float64, got {dtype}")
    return _QUERY_BLOCKS[dtype]


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


def _check_cuda(name: str, t: torch.Tensor, device: torch.device, dtype: torch.dtype):
    """Refuse what a kernel does not take: another dtype than ``dtype``
    (checked first, so a CPU tensor of the wrong dtype says so), another
    device than the CUDA ``device``, a shape other than (N, 3), or a
    non-contiguous layout."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: the CUDA kernel takes {dtype} here, got {t.dtype}")
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor on {device}, got {t.device}")
    if t.dim() != 2 or t.shape[1] != 3:
        raise ValueError(f"{name}: expected shape (N, 3), got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _index(device: torch.device) -> int:
    return device.index if device.index is not None else torch.cuda.current_device()


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.shm3d_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({err})")


def _check_inputs(queries, src_points, src_vectors) -> torch.dtype:
    """The kernel's dtype for these inputs: the queries' float32 or float64,
    shared by all three, each a contiguous (N, 3) tensor on the queries'
    CUDA device; raises otherwise."""
    dtype = queries.dtype
    query_block(dtype)
    named = (("queries", queries), ("src_points", src_points), ("src_vectors", src_vectors))
    for name, t in named:  # every dtype first: a mixed call says so on any device
        if t.dtype != dtype:
            raise TypeError(f"{name}: the CUDA kernel takes one dtype, the queries' "
                            f"{dtype}, got {t.dtype}")
    for name, t in named:
        _check_cuda(name, t, queries.device, dtype)
    if src_points.shape != src_vectors.shape:
        raise ValueError("src_points and src_vectors must have the same shape")
    if src_points.shape[0] == 0:
        raise ValueError("at least one source is required")
    return dtype


def _suffix(dtype: torch.dtype) -> str:
    return "f64" if dtype == torch.float64 else "f32"


def _scalar(dtype: torch.dtype, x: float):
    """A kernel's scalar argument in its precision (lam2 is a double in the
    float64 instantiation)."""
    return ctypes.c_double(x) if dtype == torch.float64 else ctypes.c_float(x)


def yukawa_chunk_len(Q: int, S: int, device, dtype: torch.dtype = torch.float32) -> int:
    """Sources a chunk of the ``dtype`` kernel's split holds for Q queries and
    S sources on a CUDA ``device`` (a multiple of 256): the split that fills
    the card, from that instantiation's occupancy
    (``shm3d_yukawa_chunk_len[_f64]`` in csrc/yukawa.cu)."""
    from .._build import load_library

    query_block(dtype)
    lib = load_library()
    fn = lib.shm3d_yukawa_chunk_len_f64 if dtype == torch.float64 else lib.shm3d_yukawa_chunk_len
    chunk = fn(Q, S, _index(torch.device(device)))
    if chunk <= 0:
        raise RuntimeError("yukawa kernel: the device's occupancy query failed")
    return int(chunk)


def _check_chunk(chunk: int) -> None:
    if chunk <= 0 or chunk % 256:
        raise ValueError(f"chunk={chunk}: a positive multiple of 256 is required")


def yukawa_field_cuda(
    queries: torch.Tensor,
    src_points: torch.Tensor,
    src_vectors: torch.Tensor,
    lam: float,
    normalize: bool = True,
    chunk: Optional[int] = None,
) -> torch.Tensor:
    """Launch the Hopper kernel on the current stream (float32 or float64,
    one dtype for all three contiguous (N, 3) CUDA tensors on one device;
    the instantiation of that dtype).  ``chunk``: sources a chunk (a
    multiple of 256; default ``yukawa_chunk_len``, the split that fills the
    card).  Does not synchronize."""
    dtype = _check_inputs(queries, src_points, src_vectors)
    device = queries.device
    out = torch.empty_like(queries)
    if queries.shape[0] == 0:
        return out
    from .._build import load_library

    lib = load_library()
    Q, S = queries.shape[0], src_points.shape[0]
    chunk = yukawa_chunk_len(Q, S, device, dtype) if chunk is None else int(chunk)
    _check_chunk(chunk)
    part = torch.empty((-(-S // chunk), Q, 4), dtype=dtype, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, f"shm3d_yukawa_{_suffix(dtype)}")(
            ctypes.c_void_p(queries.data_ptr()),
            ctypes.c_void_p(src_points.data_ptr()),
            ctypes.c_void_p(src_vectors.data_ptr()),
            ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(part.data_ptr()),
            ctypes.c_int64(Q),
            ctypes.c_int64(S),
            ctypes.c_int64(chunk),
            _scalar(dtype, float(lam) * LOG2E),
            ctypes.c_int(1 if normalize else 0),
            ctypes.c_int(_index(device)),
            ctypes.c_void_p(stream),
        )
    _raise_on(lib, err, "yukawa kernel")
    _count("KERNEL_LAUNCHES_F64" if dtype == torch.float64 else "KERNEL_LAUNCHES")
    return out


def yukawa_partials_cuda(
    queries: torch.Tensor,
    src_points: torch.Tensor,
    src_vectors: torch.Tensor,
    lam: float,
    chunk: int,
) -> torch.Tensor:
    """Launch the partial kernel alone on the current stream of the
    queries' device: (C, Q, 4) partials in the inputs' dtype (float32 or
    float64) over source chunks of ``chunk`` sources (a multiple of 256;
    ``yukawa_chunk_len``), C = ceil(S / chunk).  Does not synchronize."""
    dtype = _check_inputs(queries, src_points, src_vectors)
    device = queries.device
    Q, S = queries.shape[0], src_points.shape[0]
    _check_chunk(chunk)
    part = torch.empty((-(-S // chunk), Q, 4), dtype=dtype, device=device)
    if Q == 0:
        return part
    from .._build import load_library

    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, f"shm3d_yukawa_partials_{_suffix(dtype)}")(
            ctypes.c_void_p(queries.data_ptr()),
            ctypes.c_void_p(src_points.data_ptr()),
            ctypes.c_void_p(src_vectors.data_ptr()),
            ctypes.c_void_p(part.data_ptr()),
            ctypes.c_int64(Q), ctypes.c_int64(S), ctypes.c_int64(chunk),
            _scalar(dtype, float(lam) * LOG2E),
            ctypes.c_int(_index(device)), ctypes.c_void_p(stream),
        )
    _raise_on(lib, err, "yukawa partial kernel")
    _count("PARTIAL_LAUNCHES_F64" if dtype == torch.float64 else "PARTIAL_LAUNCHES")
    return part


def yukawa_merge_cuda(partials: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """Launch the merge kernel alone on the current stream of the partials'
    device: (C, Q, 4) float32 or float64 partials, any C, merged in order
    along C -> (Q, 3) in their dtype.  Does not synchronize."""
    device = partials.device
    dtype = partials.dtype
    if device.type != "cuda" or dtype not in _KERNEL_DTYPES:
        raise TypeError(f"partials: expected float32 or float64 on a CUDA device, got "
                        f"{dtype} on {device}")
    if partials.dim() != 3 or partials.shape[2] != 4 or partials.shape[0] == 0:
        raise ValueError(f"partials: expected shape (C >= 1, Q, 4), got {tuple(partials.shape)}")
    if not partials.is_contiguous():
        raise ValueError("partials: expected a contiguous tensor")
    C, Q = partials.shape[0], partials.shape[1]
    out = torch.empty((Q, 3), dtype=dtype, device=device)
    if Q == 0:
        return out
    from .._build import load_library

    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, f"shm3d_yukawa_merge_{_suffix(dtype)}")(
            ctypes.c_void_p(partials.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            ctypes.c_int64(Q), ctypes.c_int64(C), ctypes.c_int(1 if normalize else 0),
            ctypes.c_int(_index(device)), ctypes.c_void_p(stream),
        )
    _raise_on(lib, err, "yukawa merge kernel")
    _count("MERGE_LAUNCHES_F64" if dtype == torch.float64 else "MERGE_LAUNCHES")
    return out


def yukawa_partials(queries, src_points, src_vectors, lam, chunk: int,
                    q_tile: int = 2048) -> torch.Tensor:
    """Partials dispatch: the plain version for CPU tensors, the partial
    kernel for CUDA tensors (``q_tile``: the plain version's query tile)."""
    if queries.device.type == "cpu":
        return yukawa_partials_torch(queries, src_points, src_vectors, lam, chunk, q_tile)
    if queries.device.type == "cuda":
        return yukawa_partials_cuda(queries, src_points, src_vectors, float(lam), chunk)
    raise ValueError(f"unsupported device {queries.device}")


def yukawa_merge(partials: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """Merge dispatch: the plain version for CPU tensors, the merge kernel
    for CUDA tensors."""
    if partials.device.type == "cpu":
        return yukawa_merge_torch(partials, normalize)
    if partials.device.type == "cuda":
        return yukawa_merge_cuda(partials, normalize)
    raise ValueError(f"unsupported device {partials.device}")


def yukawa_field(
    queries: torch.Tensor,
    src_points: torch.Tensor,
    src_vectors: torch.Tensor,
    lam,
    normalize: bool = True,
    chunk: Optional[int] = None,
) -> torch.Tensor:
    """Steps 1-2 dispatch: the plain version for CPU tensors, the CUDA
    kernel for CUDA tensors (which raises on what it does not take);
    ``chunk``: the kernel's source chunk (``yukawa_field_cuda``)."""
    if queries.device.type == "cpu":
        return yukawa_field_torch(queries, src_points, src_vectors, lam,
                                  normalize=normalize)
    if queries.device.type == "cuda":
        return yukawa_field_cuda(queries, src_points, src_vectors, float(lam),
                                 normalize=normalize, chunk=chunk)
    raise ValueError(f"unsupported device {queries.device}")
