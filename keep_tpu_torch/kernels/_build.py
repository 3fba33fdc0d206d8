"""Builds the package's CUDA kernels at first use and loads them with ctypes.

The sources under ``csrc/`` are compiled by ``nvcc`` for ``sm_90a`` (Hopper),
one ``nvcc`` process per ``.cu`` file, all started together, and linked into
one shared library with a plain C interface. The library lands in
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
              "-Xcompiler", "-fPIC")

_F = ctypes.c_float
_I = ctypes.c_int
_L = ctypes.c_longlong
_P = ctypes.c_void_p
# argtypes of each C entry point (every one returns its cudaError_t as int);
# pointers and the stream are c_void_p, so that ctypes never cuts them to 32
# bits
SIGNATURES = {
    # q, k, v, batch_stride, head_stride, row_stride, key_bias, out, B, S,
    # H, head_dim, dtype, scale, stream
    "keep_attention": [_P, _P, _P, _L, _L, _L, _P, _P, _I, _I, _I, _I, _I, _F,
                       _P],
    # qkv, key_bias, dout, dqkv, stats, B, S, H, head_dim, dtype, scale,
    # stream
    "keep_attention_qkv_slab_bwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                    _F, _P],
    # x, x_dtype, ln_g, ln_b, eps, pre_scale, q, scale, M, K, stream
    "keep_quant_rows": [_P, _I, _P, _P, _F, _P, _P, _P, _I, _I, _P],
    # x, ln_g, ln_b, eps, out, out_dtype, M, D, stream
    "keep_ln_rows": [_P, _P, _P, _F, _P, _I, _I, _I, _P],
    # A, a_scale, B, b_scale, bias, res, res_dtype, out, out_dtype, M, N, K,
    # order, gelu, stream
    "keep_int8_gemm": [_P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I,
                       _P],
    # x, ln_g, ln_b, eps, w, bias, stats, out, dtype, out_dtype, M, N, K,
    # stream
    "keep_ln_matmul": [_P, _P, _P, _F, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
}

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


def _run_all(cmds: list[list[str]]) -> None:
    """Runs the commands in parallel and raises with the output of the first
    that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{out}")


def _compile(target: Path) -> None:
    global BUILD_SECONDS
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    cu = [p for p in _sources() if p.suffix == ".cu"]
    t0 = time.perf_counter()
    # objects and the library are built under temporary names and the
    # library renamed into place, so that a concurrent process never loads
    # a half-written one
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs = [str(Path(work, p.stem + ".o")) for p in cu]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", str(p), "-o", o]
                  for p, o in zip(cu, objs)])
        tmp = str(Path(work, target.name))
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
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
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
