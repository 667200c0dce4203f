"""Build and load the port's CUDA kernels.

The sources under ``shm3d_torch/csrc`` are compiled at first use with nvcc
for ``sm_90a`` into one shared library with a plain C interface, loaded
with ctypes.  The library lands in ``shm3d_torch/_build/`` under a name keyed
by a hash of the sources and flags, so an edited source rebuilds and an
unchanged one is reused; a file lock keeps concurrent processes from
building the same library twice.

nvcc is taken from ``$CUDA_HOME/bin``, then ``PATH``, then the toolkit's
default prefix ``/usr/local/cuda``; the build raises when none has it.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_LIB: Optional[ctypes.CDLL] = None
# (seconds spent building, compiler log) of the library this process loaded;
# seconds is 0.0 when an existing build was reused
BUILD_INFO = {"seconds": 0.0, "log": ""}


def _sources():
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME")
    candidates = []
    if cuda_home:
        candidates.append(os.path.join(cuda_home, "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found ($CUDA_HOME/bin, PATH, /usr/local/cuda/bin): the "
        "CUDA kernels of shm3d_torch are built from source at first use")


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libshm3d_torch_{h.hexdigest()[:16]}.so"


def _compile(so: Path) -> None:
    nvcc = find_nvcc()
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cu = [str(s) for s in _sources() if s.suffix == ".cu"]
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *cu]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_INFO["seconds"] = time.perf_counter() - t0
    BUILD_INFO["log"] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{BUILD_INFO['log']}")
    so.with_suffix(".log").write_text(BUILD_INFO["log"])
    os.replace(tmp, so)


def load_library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _LIB
    if _LIB is not None:
        return _LIB
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / "lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            try:
                if not so.exists():
                    _compile(so)
            finally:
                fcntl.flock(lock, fcntl.LOCK_UN)
    else:
        log = so.with_suffix(".log")
        BUILD_INFO["log"] = log.read_text() if log.exists() else ""
    lib = ctypes.CDLL(str(so))
    lib.shm3d_yukawa_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p,
    ]
    lib.shm3d_yukawa_f32.restype = ctypes.c_int
    lib.shm3d_pell_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.shm3d_pell_f32.restype = ctypes.c_int
    lib.shm3d_cuda_error_string.argtypes = [ctypes.c_int]
    lib.shm3d_cuda_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib
