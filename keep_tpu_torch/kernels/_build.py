"""Builds the package's CUDA kernels at first use and loads them with ctypes.

The sources under ``csrc/`` are compiled by ``nvcc`` into one shared library
with a plain C interface, for ``sm_90a`` (Hopper). The library lands in
``kernels/build/`` (ignored by git) under a name that carries a hash of the
sources and flags, so an edited source is rebuilt and an unchanged one is
loaded as it is. Nothing is built when the package is imported: ``library()``
is called by a wrapper the first time it launches a kernel on a CUDA tensor.
A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
BUILD_SECONDS: float | None = None  # wall time of this process's build, if any


def _sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    # PyTorch's own toolkit discovery: CUDA_HOME / CUDA_PATH, then nvcc on
    # PATH, then the toolkit's default install location
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and Path(CUDA_HOME, "bin", "nvcc").exists():
        return str(Path(CUDA_HOME, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libkeep_kernels_{h.hexdigest()[:16]}.so"


def _compile(target: Path) -> None:
    global BUILD_SECONDS
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = [str(p) for p in _sources() if p.suffix == ".cu"]
    # build into a temporary name and rename, so that a concurrent process
    # never loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)
    BUILD_SECONDS = time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The kernel library, built first if its sources changed."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _compile(path)
            lib = ctypes.CDLL(str(path))
            fn = lib.keep_attention_qkv_slab
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_float,
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib
