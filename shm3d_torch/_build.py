"""Build and load the port's native libraries.

Two shared libraries with a plain C interface, loaded with ctypes, both
compiled from the sources in the checkout at first use:

- the CUDA kernels (``shm3d_torch/csrc/*.cu``), nvcc for ``sm_90a``;
- the host mesher core (``shm3d_torch/csrc/native/*.cpp``: the lattice
  tetrahedralizer and the exact conforming recovery), g++ with the flags of
  the JAX package's ``native/Makefile``.

Each source compiles in its own compiler process, all started together,
and one link step joins the objects.  A library lands in
``shm3d_torch/_build/`` under a name keyed by a hash of its sources and
flags, so an edited source rebuilds and an unchanged one is reused; a file
lock keeps concurrent processes from building the same library twice.  A
failed build raises with the compiler's log.

nvcc is taken from ``$CUDA_HOME/bin``, then ``PATH``, then the toolkit's
default prefix ``/usr/local/cuda``; g++ from ``$CXX``, then ``PATH``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Callable, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
NATIVE_SRC = CSRC / "native"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-Wall"]

_LIB: Optional[ctypes.CDLL] = None
_NATIVE_LIB: Optional[ctypes.CDLL] = None
# (seconds spent building, compiler log) of the kernel library this process
# loaded; seconds is 0.0 when an existing build was reused
BUILD_INFO = {"seconds": 0.0, "log": ""}


def _sources():
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def _native_sources():
    return sorted(list(NATIVE_SRC.glob("*.cpp")) + list(NATIVE_SRC.glob("*.h")))


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


def find_cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError(
            "g++ not found ($CXX, PATH): the mesher core of shm3d_torch is "
            "built from source at first use")
    return cxx


def _keyed_path(prefix: str, sources, flags) -> Path:
    h = hashlib.sha256()
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"{prefix}_{h.hexdigest()[:16]}.so"


def library_path() -> Path:
    return _keyed_path("libshm3d_torch", _sources(), NVCC_FLAGS)


def native_library_path() -> Path:
    return _keyed_path("libshm3d_torch_native", _native_sources(), CXX_FLAGS)


def _run_all(cmds: List[List[str]], logs: List[Path]) -> List[int]:
    """Run the commands together, each writing its output to its log."""
    procs = []
    for cmd, log in zip(cmds, logs):
        with open(log, "w") as out:
            procs.append(subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT))
    return [p.wait() for p in procs]


def _compile(so: Path, units, compile_cmd: Callable, link_cmd: Callable) -> dict:
    """Compile each unit to an object in parallel, link them into ``so``;
    returns {seconds, log} and raises with the log on failure."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        tmp = Path(tmpdir)
        objs = [tmp / f"{u.stem}.o" for u in units]
        cmds = [compile_cmd(u, o) for u, o in zip(units, objs)]
        logs = [tmp / f"{u.stem}.log" for u in units]
        rcs = _run_all(cmds, logs)
        log = "".join(lg.read_text() for lg in logs)
        if all(rc == 0 for rc in rcs):
            cmds.append(link_cmd(objs, tmp / so.name))
            rcs += _run_all(cmds[-1:], [tmp / "link.log"])
            log += (tmp / "link.log").read_text()
        if any(rc != 0 for rc in rcs):
            failed = next(c for c, rc in zip(cmds, rcs) if rc != 0)
            raise RuntimeError(f"build of {so.name} failed: {' '.join(map(str, failed))}\n{log}")
        so.with_suffix(".log").write_text(log)
        os.replace(tmp / so.name, so)
    return {"seconds": time.perf_counter() - t0, "log": log}


def _build_once(so: Path, build: Callable[[], dict]) -> Optional[dict]:
    """Run ``build`` under the build lock unless ``so`` exists; returns its
    info, or None when an existing build was reused."""
    if so.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{so.name.rsplit('_', 1)[0]}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not so.exists():
                return build()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return None


def load_library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _LIB
    if _LIB is not None:
        return _LIB
    so = library_path()

    def build():
        nvcc = find_nvcc()
        return _compile(
            so, [s for s in _sources() if s.suffix == ".cu"],
            lambda src, obj: [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            lambda objs, out: [nvcc, NVCC_FLAGS[0], NVCC_FLAGS[1], "-shared",
                               "-o", str(out), *map(str, objs)])

    info = _build_once(so, build)
    if info is not None:
        BUILD_INFO.update(info)
    else:
        log = so.with_suffix(".log")
        BUILD_INFO.update(seconds=0.0, log=log.read_text() if log.exists() else "")
    lib = ctypes.CDLL(str(so))
    lib.shm3d_yukawa_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.shm3d_yukawa_f32.restype = ctypes.c_int
    lib.shm3d_yukawa_chunk_len.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
    lib.shm3d_yukawa_chunk_len.restype = ctypes.c_int64
    lib.shm3d_yukawa_skeleton_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.shm3d_yukawa_skeleton_f32.restype = ctypes.c_int
    lib.shm3d_sell_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.shm3d_sell_f32.restype = ctypes.c_int
    lib.shm3d_cuda_error_string.argtypes = [ctypes.c_int]
    lib.shm3d_cuda_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def load_native_library() -> ctypes.CDLL:
    """The loaded mesher-core library, built with g++ first if needed (the
    caller declares its functions: ``shm3d_torch.tet.native``)."""
    global _NATIVE_LIB
    if _NATIVE_LIB is not None:
        return _NATIVE_LIB
    so = native_library_path()

    def build():
        cxx = find_cxx()
        return _compile(
            so, [s for s in _native_sources() if s.suffix == ".cpp"],
            lambda src, obj: [cxx, *CXX_FLAGS, "-c", "-o", str(obj), str(src)],
            lambda objs, out: [cxx, "-shared", "-o", str(out), *map(str, objs)])

    _build_once(so, build)
    _NATIVE_LIB = ctypes.CDLL(str(so))
    return _NATIVE_LIB
