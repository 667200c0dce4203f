#!/usr/bin/env python3
"""Compare the float32 Yukawa kernel (shm3d_torch/csrc/yukawa.cu) with an
earlier build of it, bit for bit, on one NVIDIA GPU.

    python3 scripts/yukawa_vs_parent.py OLD_DIR [BUILD_DIR]

OLD_DIR holds an earlier ``yukawa.cu`` and the ``yukawa_common.cuh`` it
includes, for example the parent commit's, taken from git with ``git
show <commit>:shm3d_torch/csrc/yukawa.cu`` (and the header) into a
gitignored directory.  The script builds them with nvcc into BUILD_DIR
(default: OLD_DIR), then runs both float32 kernels (``shm3d_yukawa_f32``,
the partial and the merge kernel, at the same chunk length) on the same
inputs: seeded clouds of 52,290 sources on the unit sphere against the
main path's two launch sizes (211,563 and 35,937 queries), a ragged case,
and far queries with a large lambda, normalized and not.  It prints, per
case, whether the outputs are equal bit for bit and the chunk lengths of
both builds, then one JSON line; exits 1 if any output differs."""

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_old_library(old_dir: str, out_dir: str) -> ctypes.CDLL:
    sys.path.insert(0, REPO)
    from shm3d_torch._build import NVCC_FLAGS, find_nvcc

    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "libyukawa_old.so")
    subprocess.run([find_nvcc(), *NVCC_FLAGS, "-shared", "-o", so,
                    os.path.join(old_dir, "yukawa.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(so)
    lib.shm3d_yukawa_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.shm3d_yukawa_f32.restype = ctypes.c_int
    lib.shm3d_yukawa_chunk_len.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
    lib.shm3d_yukawa_chunk_len.restype = ctypes.c_int64
    return lib


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("yukawa_vs_parent: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    old_dir = os.path.abspath(sys.argv[1])
    old = build_old_library(old_dir, os.path.abspath(sys.argv[2]) if len(sys.argv) > 2
                            else old_dir)
    from shm3d_torch.ops import yukawa as yk

    dev = torch.device("cuda:0")
    rng = np.random.default_rng(0)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=dev)

    sphere = rng.normal(size=(52290, 3))
    sphere /= np.linalg.norm(sphere, axis=1, keepdims=True)
    far = rng.normal(size=(1000, 3))
    far = 40.0 * far / np.linalg.norm(far, axis=1, keepdims=True)
    cases = (("shell-size", rng.uniform(-1.3, 1.3, (211563, 3)), sphere, 1e-4 * sphere, 90.0),
             ("coarse-size", rng.uniform(-1.3, 1.3, (35937, 3)), sphere, 1e-4 * sphere, 90.0),
             ("ragged", rng.uniform(-1, 1, (5003, 3)), rng.uniform(-1, 1, (4099, 3)),
              rng.normal(size=(4099, 3)) * 0.3 + [0, 0, 1], 7.5),
             ("far", far, sphere[:3001], 0.7 * sphere[:3001], 50.0))
    results = {}
    for name, q, p, v, lam in cases:
        q, p, v = t(q), t(p), t(v)
        Q, S = q.shape[0], p.shape[0]
        chunk = yk.yukawa_chunk_len(Q, S, dev)
        old_chunk = old.shm3d_yukawa_chunk_len(Q, S, 0)
        for normalize in (True, False):
            got = yk.yukawa_field_cuda(q, p, v, lam, normalize=normalize)
            want = torch.empty_like(q)
            part = torch.empty((-(-S // old_chunk), Q, 4), dtype=torch.float32, device=dev)
            err = old.shm3d_yukawa_f32(q.data_ptr(), p.data_ptr(), v.data_ptr(),
                                       want.data_ptr(), part.data_ptr(), Q, S, old_chunk,
                                       ctypes.c_float(lam * yk.LOG2E), int(normalize), 0,
                                       torch.cuda.current_stream(dev).cuda_stream)
            torch.cuda.synchronize()
            if err != 0:
                raise RuntimeError(f"the earlier kernel's launch failed ({err})")
            same = torch.equal(got, want)
            results[f"{name}/{'normalized' if normalize else 'raw'}"] = same
            print(f"{name} Q={Q} S={S} normalize={normalize}: chunk {chunk} (earlier build "
                  f"{old_chunk}), bit for bit {same}")
    print(json.dumps({"bitwise": results, "device": torch.cuda.get_device_name(0)}))
    return 0 if all(results.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
