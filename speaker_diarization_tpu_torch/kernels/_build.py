"""Build the port's CUDA sources (csrc/*.cu) with nvcc and load them with ctypes.

Each source becomes its own shared library with a plain C interface, built
for sm_90a (Hopper) at first use into ``_build/`` inside the package and
cached by a hash of the source, the shared headers and the flags. All
missing libraries are compiled at once, one nvcc process per source.

Nothing here runs at import time: the package imports on hosts without
nvcc or a GPU, and only a call that needs a kernel builds one. A failed
build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
]

SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH to build the CUDA kernels")


def _so_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        h.update(f.read())
    for hdr in sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh")):
        with open(os.path.join(CSRC, hdr), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build_all() -> Dict[str, float]:
    """Compile every source whose library is not cached, all in parallel.

    Returns {source: seconds} for the sources compiled by this call.
    """
    todo = {n: _so_path(n) for n in sources()}
    todo = {n: p for n, p in todo.items() if not os.path.exists(p)}
    if not todo:
        return {}
    nvcc = nvcc_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name, so in todo.items():
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp, so)
    done: Dict[str, float] = {}
    errors = []
    for name, (proc, tmp, so) in procs.items():
        out, _ = proc.communicate()
        done[name] = time.perf_counter() - t0
        log = out.decode(errors="replace")
        with open(so[:-3] + ".log", "w") as f:
            f.write(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, so)  # atomic: a concurrent process sees the whole library or none
    if errors:
        raise RuntimeError("\n".join(errors))
    return done


def build_log(name: str) -> str:
    """nvcc/ptxas output of the cached build of `name` (registers, spills, smem)."""
    path = _so_path(name)[:-3] + ".log"
    with open(path) as f:
        return f.read()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, building what is missing first."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            so = _so_path(name)
            if not os.path.exists(so):
                build_all()
            lib = ctypes.CDLL(so)
            lib.sdt_cuda_error_string.restype = ctypes.c_char_p
            lib.sdt_cuda_error_string.argtypes = [ctypes.c_int]
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if code != 0:
        msg = lib.sdt_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
