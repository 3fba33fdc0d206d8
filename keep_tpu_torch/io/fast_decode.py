"""ctypes bindings of the repo's native C++ JPEG / PNG decoder
(``native/imgdec.cpp``; counterpart of ``keep_tpu/io/fast_decode.py``).

The training data loader's host path: decode runs on C++ threads with the
GIL released. The native path covers baseline / progressive JPEG (YCbCr,
grey, RGB) and PNG without alpha, decoded by the same libjpeg / libpng that
PIL sits on, so its outputs equal PIL's bit for bit; anything else (and any
host where the library cannot be built) goes through
``PIL.Image.convert("RGB")``, as in the JAX package. Either route gives the
same array.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Sequence

import numpy as np

from keep_tpu_torch.io._native import build_native

_lib = None
_lib_failed = False  # a failed build is not retried on every decode
_lib_error = ""
_load_lock = threading.Lock()


def _load_lib():
    # one build a process, not one for each decode thread that asks before
    # the first has failed: where the library cannot be built, each would
    # run the compiler anew, a rank's 8 threads one after another
    with _load_lock:
        return _open_lib()


def _open_lib():
    global _lib, _lib_failed, _lib_error
    if _lib_failed:
        raise RuntimeError(
            f"native decoder unavailable (cached failure): {_lib_error}")
    if _lib is None:
        try:
            lib = ctypes.CDLL(build_native())
        except Exception as e:
            _lib_failed, _lib_error = True, str(e)
            raise
        lib.imgdec_probe.restype = ctypes.c_int
        lib.imgdec_probe.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.imgdec_decode.restype = ctypes.c_int
        lib.imgdec_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int,
        ]
        lib.imgdec_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_size_t),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int),
        ]
        _lib = lib
    return _lib


def decode_bytes(data: bytes) -> Optional[np.ndarray]:
    """One encoded image → uint8 [H, W, 3] RGB, or None (caller falls back
    to PIL: unsupported format/colorspace or corrupt stream)."""
    lib = _load_lib()
    w, h = ctypes.c_int(), ctypes.c_int()
    fmt = lib.imgdec_probe(data, len(data), ctypes.byref(w), ctypes.byref(h))
    if fmt < 0:
        return None
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.imgdec_decode(data, len(data), out.ctypes.data, w.value, h.value)
    return out if rc == 0 else None


def decode_image(path: str) -> np.ndarray:
    """File → uint8 [H, W, 3] RGB; native fast path with PIL fallback (any
    native-path failure — unsupported format, corrupt stream, toolchain
    missing — lands in PIL)."""
    try:
        with open(path, "rb") as f:
            data = f.read()
        arr = decode_bytes(data)
        if arr is not None:
            return arr
    except Exception:
        pass
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def decode_files(
    paths: Sequence[str], workers: int = 8
) -> list[np.ndarray]:
    """Batch decode on C++ threads (one batched call, GIL released);
    threaded PIL fallback for anything the fast path declines."""
    try:
        lib = _load_lib()
    except Exception:
        from concurrent.futures import ThreadPoolExecutor

        from PIL import Image

        with ThreadPoolExecutor(max_workers=max(1, workers)) as pool:
            return list(pool.map(
                lambda p: np.asarray(Image.open(p).convert("RGB")), paths))
    blobs = []
    for p in paths:
        try:
            with open(p, "rb") as f:
                blobs.append(f.read())
        except OSError:
            blobs.append(b"")

    n = len(paths)
    ws = (ctypes.c_int * n)()
    hs = (ctypes.c_int * n)()
    fast: list[int] = []
    outs: dict[int, np.ndarray] = {}
    for i, data in enumerate(blobs):
        if not data:
            continue
        w, h = ctypes.c_int(), ctypes.c_int()
        if lib.imgdec_probe(data, len(data), ctypes.byref(w), ctypes.byref(h)) >= 0:
            ws[i], hs[i] = w.value, h.value
            outs[i] = np.empty((h.value, w.value, 3), np.uint8)
            fast.append(i)

    if fast:
        m = len(fast)
        bufs = (ctypes.c_char_p * m)(*[blobs[i] for i in fast])
        lens = (ctypes.c_size_t * m)(*[len(blobs[i]) for i in fast])
        out_ptrs = (ctypes.c_void_p * m)(*[outs[i].ctypes.data for i in fast])
        sub_ws = (ctypes.c_int * m)(*[ws[i] for i in fast])
        sub_hs = (ctypes.c_int * m)(*[hs[i] for i in fast])
        rc = (ctypes.c_int * m)()
        lib.imgdec_decode_batch(bufs, lens, m, out_ptrs, sub_ws, sub_hs,
                                max(1, workers), rc)
        for j, i in enumerate(fast):
            if rc[j] != 0:
                del outs[i]

    del blobs  # compressed bytes are done; don't hold them across fallback

    slow = [i for i in range(n) if i not in outs]
    if slow:  # threaded PIL fallback (matches the pre-native preload path)
        from concurrent.futures import ThreadPoolExecutor

        from PIL import Image

        with ThreadPoolExecutor(max_workers=max(1, workers)) as pool:
            decoded = pool.map(
                lambda i: np.asarray(Image.open(paths[i]).convert("RGB")), slow
            )
            for i, arr in zip(slow, decoded):
                outs[i] = arr
    return [outs[i] for i in range(n)]
