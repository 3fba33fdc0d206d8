"""Builds the repo's native C++ libraries (``native/*.cpp``) at first use
(counterpart of ``keep_tpu.text.fast_tokenizer.build_native``):

- ``build_native``: every source (the libtiff pyramid reader, the JPEG /
  PNG decoder and the tokenizers), linked with ``-ljpeg -lpng -ltiff``;
- ``build_tokenizers``: ``wordpiece.cpp`` and ``bpe.cpp`` alone, with no
  library, so that the fast tokenizers build where the image libraries'
  headers are missing.

The sources are compiled with ``native/Makefile``'s flags
(``-O3 -std=c++17 -fPIC -Wall``) into ``keep_tpu_torch/io/build/`` (ignored
by git), under a name that carries a hash of the sources and flags, so an
edited source is rebuilt and an unchanged one loaded as it is. Nothing is
written under ``native/``. A library is built under a temporary name and
renamed into place, so that a concurrent process never loads a
half-written one. A failed build raises with the compiler's output, which
names the header or library that is missing; a missing header is found by
the preprocessor first (``-M``), in a fraction of a second.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
BUILD_DIR = Path(__file__).resolve().parent / "build"
CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall")
LIBS = ("-ljpeg", "-lpng", "-ltiff")

_lock = threading.Lock()


TOKENIZER_SOURCES = ("wordpiece.cpp", "bpe.cpp")


def _sources() -> list[Path]:
    return sorted(NATIVE_DIR.glob("*.cpp"))


def _library_path(stem: str, sources: list[Path], libs: tuple) -> Path:
    h = hashlib.sha256(" ".join(CXXFLAGS + libs).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"


def library_path() -> Path:
    return _library_path("libkeep_native", _sources(), LIBS)


def tokenizer_library_path() -> Path:
    return _library_path("libkeep_tokenizers", _tokenizer_sources(), ())


def _tokenizer_sources() -> list[Path]:
    return [NATIVE_DIR / name for name in TOKENIZER_SOURCES]


def _compile(cxx: str, cmd: list, name: str) -> None:
    try:
        p = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run the C++ compiler {cxx!r} to build "
                           f"{name}: {e}") from e
    if p.returncode != 0:
        raise RuntimeError(
            f"building the native library failed ({p.returncode}): "
            f"{' '.join(cmd)}\n{p.stderr}")


def _build(target: Path, sources: list[Path], libs: tuple) -> str:
    with _lock:
        if target.exists():
            return str(target)
        cxx = os.environ.get("CXX") or shutil.which("g++") or "c++"
        # a missing header fails here, in the preprocessor, instead of
        # after the optimised compile of the sources that need none: each
        # process that asks for a library that cannot be built asks anew
        _compile(cxx, [cxx, "-std=c++17", "-M", *map(str, sources)],
                 target.name)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
            tmp = Path(work, target.name)
            _compile(cxx, [cxx, *CXXFLAGS, "-shared", "-o", str(tmp),
                           *map(str, sources), *libs], target.name)
            os.replace(tmp, target)
        return str(target)


def build_native() -> str:
    """The whole library's path, compiled first if its sources changed."""
    return _build(library_path(), _sources(), LIBS)


def build_tokenizers() -> str:
    """The tokenizer-only library's path, compiled first if its sources
    changed."""
    return _build(tokenizer_library_path(), _tokenizer_sources(), ())
