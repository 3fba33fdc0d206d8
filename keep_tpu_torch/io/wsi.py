"""Whole-slide image reader / writer: pyramidal TIFF / Aperio SVS without
OpenSlide (counterpart of ``keep_tpu/io/wsi.py``).

The reference reads real slides only through ``openslide.OpenSlide``
(WSI_evaluation/segment_utils.py:91-127). Here the pyramidal TIFF (which
.svs is) reads through the repo's native libtiff module
(``native/tiffwsi.cpp``, built by ``io._native``) with an
OpenSlide-compatible surface:

    with open_slide("slide.svs") as s:
        region = s.read_region((x, y), level, (w, h))   # uint8 [h, w, 3]

Backend order, as in the JAX package: native libtiff → ``openslide`` (if
importable; for non-TIFF containers such as .ndpi / .mrxs) → PIL (decodes
whole levels; fine for masks, thumbnails and stripped multi-page TIFFs,
memory-bound for giant slides). ``WSIReader.backend`` says which one reads.

``write_pyramid`` builds a tiled pyramidal TIFF (2×2 box-filtered levels)
from a plain RGB image.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence

import numpy as np

_lib = None
_lib_failed = False  # a failed build is not retried on every open
_lib_error = ""


def _load_lib():
    global _lib, _lib_failed, _lib_error
    if _lib_failed:
        raise RuntimeError(
            f"native tiffwsi unavailable (cached failure): {_lib_error}")
    if _lib is None:
        try:
            from keep_tpu_torch.io._native import build_native

            lib = ctypes.CDLL(build_native())
        except Exception as e:
            _lib_failed, _lib_error = True, str(e)
            raise
        lib.tiffwsi_codec_ok.restype = ctypes.c_int
        lib.tiffwsi_codec_ok.argtypes = [ctypes.c_int]
        lib.tiffwsi_open.restype = ctypes.c_void_p
        lib.tiffwsi_open.argtypes = [ctypes.c_char_p]
        lib.tiffwsi_close.argtypes = [ctypes.c_void_p]
        lib.tiffwsi_level_count.restype = ctypes.c_int
        lib.tiffwsi_level_count.argtypes = [ctypes.c_void_p]
        lib.tiffwsi_level_dims.restype = ctypes.c_int
        lib.tiffwsi_level_dims.argtypes = [
            ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
        ]
        lib.tiffwsi_read_region.restype = ctypes.c_int
        lib.tiffwsi_read_region.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_void_p,
        ]
        lib.tiffwsi_write_pyramid.restype = ctypes.c_int
        lib.tiffwsi_write_pyramid.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.c_uint32, ctypes.c_int, ctypes.c_uint32, ctypes.c_int,
            ctypes.c_int,
        ]
        lib.tiffwsi_read_regions.restype = ctypes.c_int
        lib.tiffwsi_read_regions.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_void_p,
            ctypes.c_int,
        ]
        lib.tiffwsi_append_stripped.restype = ctypes.c_int
        lib.tiffwsi_append_stripped.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32,
        ]
        _lib = lib
    return _lib


_COMPRESSIONS = {"none": 0, "deflate": 1, "jpeg": 2}


def write_pyramid(
    path: str,
    image: np.ndarray,
    tile: int = 256,
    max_levels: int = 0,
    min_size: int = 256,
    compression: str = "deflate",
    quality: int = 85,
) -> None:
    """Write ``image`` (uint8 [H, W, 3] RGB) as a tiled pyramidal TIFF.

    Levels 2×2 box-downsample until max(dim) <= ``min_size`` (or
    ``max_levels`` directories, 0 = unlimited). ``tile`` must be a multiple
    of 16 (TIFF spec). compression: none | deflate | jpeg."""
    img = np.ascontiguousarray(np.asarray(image, np.uint8))
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3] RGB uint8, got {img.shape}")
    lib = _load_lib()
    comp = _COMPRESSIONS[compression]
    h, w = img.shape[:2]
    rc = lib.tiffwsi_write_pyramid(
        os.fspath(path).encode(), img.ctypes.data, w, h, tile, max_levels,
        min_size, comp, quality,
    )
    if rc != 0:
        raise OSError(f"tiffwsi_write_pyramid({path}) failed (rc={rc})")


def append_stripped_page(path: str, image: np.ndarray) -> None:
    """Append a STRIPPED RGB directory to an existing TIFF — composes
    Aperio-like layouts (tiled pyramid + stripped thumbnail page, which
    readers skip on tiled slides) for tests and tooling."""
    img = np.ascontiguousarray(np.asarray(image, np.uint8))
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3] RGB uint8, got {img.shape}")
    h, w = img.shape[:2]
    rc = _load_lib().tiffwsi_append_stripped(
        os.fspath(path).encode(), img.ctypes.data, w, h)
    if rc != 0:
        raise OSError(f"tiffwsi_append_stripped({path}) failed (rc={rc})")


class WSIReader:
    """OpenSlide-compatible pyramidal slide reader.

    ``level_dimensions`` / ``level_downsamples`` / ``dimensions`` /
    ``read_region((x, y), level, (w, h))`` match ``openslide.OpenSlide``
    semantics — (x, y) in LEVEL-0 coordinates, (w, h) in the target level's
    — except regions return uint8 [h, w, 3] RGB arrays, not PIL images.
    Out-of-bounds area is zero-filled (like OpenSlide's black border).
    """

    def __init__(self, path: str, backend: Optional[str] = None):
        self.path = os.fspath(path)
        self._handle = None
        self._pil = None
        self._pil_levels = None  # [(frame_idx, w, h)], desc width
        self._pil_cache: dict[int, np.ndarray] = {}
        if backend not in (None, "native", "pil"):
            raise ValueError(f"unknown backend {backend!r}")
        err: Exception | None = None
        if backend in (None, "native"):
            try:
                lib = _load_lib()
                h = lib.tiffwsi_open(self.path.encode())
                if h:
                    self._handle = h
                    self.backend = "native"
            except Exception as e:
                err = e
            if self._handle is None and backend == "native":
                raise OSError(f"native libtiff cannot open {path}") from err
        if self._handle is None:
            self._open_pil()
            self.backend = "pil"
        self.level_dimensions = self._read_level_dims()
        if not self.level_dimensions:
            raise OSError(f"no image levels in {path}")
        w0, h0 = self.level_dimensions[0]
        self.dimensions = (w0, h0)
        self.level_count = len(self.level_dimensions)
        self.level_downsamples = [
            ((w0 / w) + (h0 / h)) / 2 for w, h in self.level_dimensions
        ]

    # -- backends -----------------------------------------------------------
    def _open_pil(self):
        from PIL import Image

        Image.MAX_IMAGE_PIXELS = None
        img = Image.open(self.path)
        levels = []
        n = getattr(img, "n_frames", 1)
        w0 = h0 = None
        base_tiled = False

        def is_tiled(im):  # TIFFTAG_TILEWIDTH present
            return 322 in getattr(im, "tag_v2", {})

        for i in range(n):
            img.seek(i)
            w, h = img.size
            if w0 is None:
                w0, h0 = w, h
                base_tiled = is_tiled(img)
            else:  # skip label/macro pages and (for tiled pyramids) the
                # stripped SVS thumbnail page, like the native reader
                ar0, ar = w0 / h0, w / h
                if not (0.95 * ar0 <= ar <= 1.05 * ar0):
                    continue
                if base_tiled and not is_tiled(img):
                    continue
            levels.append((i, w, h))
        img.seek(0)
        levels.sort(key=lambda t: -t[1])
        self._pil = img
        self._pil_levels = levels

    def _read_level_dims(self) -> list[tuple[int, int]]:
        if self._handle is not None:
            lib = _load_lib()
            out = []
            for i in range(lib.tiffwsi_level_count(self._handle)):
                w, h = ctypes.c_uint32(), ctypes.c_uint32()
                if lib.tiffwsi_level_dims(self._handle, i,
                                          ctypes.byref(w), ctypes.byref(h)):
                    raise OSError(f"level_dims({i}) failed on {self.path}")
                out.append((w.value, h.value))
            return out
        return [(w, h) for _, w, h in self._pil_levels]

    def _pil_level_array(self, level: int) -> np.ndarray:
        if level not in self._pil_cache:
            frame = self._pil_levels[level][0]
            self._pil.seek(frame)
            self._pil_cache[level] = np.asarray(self._pil.convert("RGB"))
        return self._pil_cache[level]

    # -- API ----------------------------------------------------------------
    def read_region(
        self, location: Sequence[int], level: int, size: Sequence[int]
    ) -> np.ndarray:
        """uint8 [h, w, 3] RGB; ``location`` = top-left in level-0 coords,
        ``size`` = (w, h) at ``level`` (OpenSlide semantics)."""
        if not 0 <= level < self.level_count:
            raise IndexError(f"level {level} out of range [0, {self.level_count})")
        x0, y0 = int(location[0]), int(location[1])
        w, h = int(size[0]), int(size[1])
        ds = self.level_downsamples[level]
        x, y = int(round(x0 / ds)), int(round(y0 / ds))
        if self.backend == "native" and self._handle is None:
            # a closed native reader must not fall through to the (never
            # populated) PIL branch and die with a confusing TypeError
            raise ValueError(f"WSIReader({self.path}) is closed")
        if self._handle is not None:
            lib = _load_lib()
            out = np.empty((h, w, 3), np.uint8)
            rc = lib.tiffwsi_read_region(self._handle, level, x, y, w, h,
                                         out.ctypes.data)
            if rc != 0:
                raise OSError(
                    f"read_region(level={level}, xy=({x0},{y0}), "
                    f"size=({w},{h})) failed on {self.path} (rc={rc})")
            return out
        arr = self._pil_level_array(level)
        out = np.zeros((h, w, 3), np.uint8)
        lh, lw = arr.shape[:2]
        sx0, sy0 = max(x, 0), max(y, 0)
        sx1, sy1 = min(x + w, lw), min(y + h, lh)
        if sx0 < sx1 and sy0 < sy1:
            out[sy0 - y : sy1 - y, sx0 - x : sx1 - x] = arr[sy0:sy1, sx0:sx1]
        return out

    def read_regions(
        self,
        locations: np.ndarray,
        level: int,
        size: Sequence[int],
        threads: Optional[int] = None,
    ) -> np.ndarray:
        """Batched :meth:`read_region`: N same-size regions → uint8
        [N, h, w, 3]. On the native backend the decode fans out over C++
        threads with per-thread TIFF handles (the GIL is released for the
        whole batch) — this is what keeps the feature-extraction pipeline's
        host side ahead of the chip on multi-core hosts. Semantics
        identical to N read_region calls (level-0 locations).
        ``threads`` defaults to the CPU count; at 1 the batch runs on this
        reader's own (warm) handle instead of opening worker handles."""
        locs = np.asarray(locations, np.int64).reshape(-1, 2)
        n = len(locs)
        w, h = int(size[0]), int(size[1])
        if not 0 <= level < self.level_count:
            raise IndexError(f"level {level} out of range [0, {self.level_count})")
        if n == 0:
            return np.zeros((0, h, w, 3), np.uint8)
        if threads is None:
            threads = os.cpu_count() or 1
        if self._handle is not None and threads > 1:
            lib = _load_lib()
            ds = self.level_downsamples[level]
            xy = np.rint(locs / ds).astype(np.int64)
            out = np.empty((n, h, w, 3), np.uint8)
            rc = lib.tiffwsi_read_regions(
                self.path.encode(), level,
                xy.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n, w, h,
                out.ctypes.data, threads,
            )
            if rc != 0:
                raise OSError(f"read_regions({n} x ({w},{h}) at level "
                              f"{level}) failed on {self.path} (rc={rc})")
            return out
        # threads<=1 native (warm shared handle) or the PIL backend
        return np.stack([self.read_region(loc, level, (w, h)) for loc in locs])

    def best_level_for_downsample(self, downsample: float) -> int:
        """The level whose downsample is nearest the request (OpenSlide picks
        the best level <= downsample; the segmentation GT path wants
        nearest — matching `_openslide_gt`'s explicit argmin)."""
        return min(range(self.level_count),
                   key=lambda i: abs(self.level_downsamples[i] - downsample))

    def get_thumbnail(self, size: Sequence[int]) -> np.ndarray:
        """RGB thumbnail fitting inside ``size`` (w, h), read from the
        smallest pyramid level at least that large (PIL-resized down)."""
        from PIL import Image

        tw, th = int(size[0]), int(size[1])
        # the smallest (lowest-resolution) level still >= the requested
        # size, else level 0: a level below the request would degrade the
        # tissue masks made from it on >2x-spaced pyramids (Aperio 4x)
        lvl = 0
        for i in range(self.level_count):
            w, h = self.level_dimensions[i]
            if w >= max(tw, 1) and h >= max(th, 1):
                lvl = i
            else:
                break
        w, h = self.level_dimensions[lvl]
        arr = self.read_region((0, 0), lvl, (w, h))
        img = Image.fromarray(arr)
        img.thumbnail((tw, th))
        return np.asarray(img)

    def close(self):
        if self._handle is not None:
            _load_lib().tiffwsi_close(self._handle)
            self._handle = None
        if self._pil is not None:
            self._pil.close()
            self._pil = None
        self._pil_cache.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):  # best-effort; explicit close preferred
        try:
            self.close()
        except Exception:
            pass


def open_slide(path: str) -> "WSIReader | object":
    """Open a slide: native libtiff → ``openslide`` (if importable, for
    non-TIFF containers) → PIL. Returns a WSIReader or an
    ``openslide.OpenSlide`` (API-compatible for the surface used here)."""
    try:
        return WSIReader(path, backend="native")
    except Exception:
        pass
    try:  # openslide is optional
        import openslide

        return openslide.open_slide(path)
    except Exception:
        # ImportError (module or the C library missing) or an
        # OpenSlideError on formats it doesn't speak (e.g. plain PNG) —
        # either way the PIL fallback still gets its chance
        pass
    return WSIReader(path, backend="pil")
