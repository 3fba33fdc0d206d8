"""Local pretrained-checkpoint registry: name → on-disk path (+ sha256)
(counterpart of ``keep_tpu/compat/registry.py``; no JAX in it).

The reference keeps a URL / hf-hub registry with download helpers
(training/path_open_clip/pretrained.py:21-427, openai.py:24-90). This is a
LOCAL registry: each entry names where the checkpoint lives under
``$KEEP_TPU_HOME`` (default ``~/.cache/keep_tpu``, the JAX package's
variable and cache, so that a checkpoint placed once serves both
packages), its upstream source (so the user knows what to download
out-of-band), and an optional sha256 to verify the copy.

    from keep_tpu_torch.compat.registry import resolve
    model_dir = resolve("keep")             # errors with download directions
    model = KEEPModel.from_pretrained(model_dir)

``register()`` adds entries at runtime; a JSON file at
``$KEEP_TPU_HOME/registry.json`` ({name: {path, sha256, source}}) extends the
builtins persistently.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Optional


def cache_home() -> str:
    return os.environ.get(
        "KEEP_TPU_HOME", os.path.join(os.path.expanduser("~"), ".cache", "keep_tpu")
    )


@dataclasses.dataclass(frozen=True)
class Entry:
    name: str
    path: str  # absolute, or relative to cache_home()
    source: str  # where a user obtains it (hub id / URL) — informational
    sha256: Optional[str] = None  # of the checkpoint file (dir entries skip)
    kind: str = "dir"  # 'dir' (HF layout) | 'file' (single .bin/.pt)
    url: Optional[str] = None  # fetchable location (file:// works offline)

    def resolved_path(self) -> str:
        p = self.path
        if not os.path.isabs(p):
            p = os.path.join(cache_home(), p)
        return p


_BUILTINS = {
    "keep": Entry(
        name="keep", path="KEEP", kind="dir",
        source="hf.co/Astaxanthin/KEEP (config.json + pytorch_model.bin + "
               "vocab.txt)",
    ),
    "uni": Entry(
        name="uni", path="UNI/pytorch_model.bin", kind="file",
        source="hf.co/MahmoodLab/UNI pytorch_model.bin (timm ViT-L/16; the "
               "reference's pretrained_image tower, factory.py:211-217)",
    ),
    "knowledge_bert": Entry(
        name="knowledge_bert", path="knowledge_bert.pt", kind="file",
        source="KEEP release knowledge-BERT checkpoint (the reference's "
               "pretrained text tower, factory.py:200-208)",
    ),
}

_runtime: dict[str, Entry] = {}


def _file_registry() -> dict[str, Entry]:
    path = os.path.join(cache_home(), "registry.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        raw = json.load(f)
    return {
        name: Entry(name=name, path=rec["path"], source=rec.get("source", ""),
                    sha256=rec.get("sha256"), kind=rec.get("kind", "dir"),
                    url=rec.get("url"))
        for name, rec in raw.items()
    }


def register(name: str, path: str, source: str = "", sha256: Optional[str] = None,
             kind: str = "dir", url: Optional[str] = None) -> None:
    """Add/override a registry entry for this process."""
    _runtime[name] = Entry(name=name, path=path, source=source, sha256=sha256,
                           kind=kind, url=url)


def entries() -> dict[str, Entry]:
    out = dict(_BUILTINS)
    out.update(_file_registry())
    out.update(_runtime)
    return out


def sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def download_pretrained_from_url(
    url: str,
    cache_dir: Optional[str] = None,
    expected_sha256: Optional[str] = None,
) -> str:
    """resolve → fetch → sha256-verify → cache (the reference's
    download_pretrained_from_url, pretrained.py:336-377): a cached file with
    a matching checksum is returned without re-fetching; a cached file with a
    MISmatching checksum is re-downloaded; a fresh download that still
    mismatches raises. ``file://`` URLs work offline; the
    openaipublic/mlfoundations URL forms carry their sha prefix in the URL
    and are sniffed the same way the reference does."""
    import urllib.request

    cache_dir = cache_dir or os.path.join(cache_home(), "downloads")
    os.makedirs(cache_dir, exist_ok=True)
    filename = os.path.basename(url)
    if expected_sha256 is None:
        if "openaipublic" in url:
            expected_sha256 = url.split("/")[-2]
        elif "mlfoundations" in url:
            expected_sha256 = os.path.splitext(filename)[0].split("-")[-1]
        else:
            expected_sha256 = ""

    target = os.path.join(cache_dir, filename)
    if os.path.exists(target) and not os.path.isfile(target):
        raise RuntimeError(f"{target} exists and is not a regular file")
    if os.path.isfile(target):
        if not expected_sha256 or sha256_file(target).startswith(expected_sha256):
            return target
        import warnings

        warnings.warn(f"{target} exists but its sha256 doesn't match; "
                      f"re-downloading")
    with urllib.request.urlopen(url) as src, open(target, "wb") as out:
        while True:
            buf = src.read(1 << 20)
            if not buf:
                break
            out.write(buf)
    if expected_sha256 and not sha256_file(target).startswith(expected_sha256):
        raise RuntimeError(
            f"downloaded {url} but sha256 {sha256_file(target)} doesn't match "
            f"expected {expected_sha256}")
    return target


def resolve(name: str, verify: bool = True) -> str:
    """Registry name → verified local path. Entries carrying a ``url`` are
    fetched into the cache when absent — FILE entries only
    (download_pretrained semantics, pretrained.py:400-427; directory
    entries have no archive convention and are never auto-fetched);
    URL-less entries raise FileNotFoundError with download directions
    (the offline default)."""
    reg = entries()
    if name not in reg:
        known = ", ".join(sorted(reg))
        raise KeyError(f"unknown pretrained name '{name}' (known: {known}); "
                       f"register() it or add it to "
                       f"{os.path.join(cache_home(), 'registry.json')}")
    e = reg[name]
    p = e.resolved_path()
    ok = os.path.isdir(p) if e.kind == "dir" else os.path.isfile(p)
    if not ok and e.url and e.kind == "file":
        os.makedirs(os.path.dirname(p), exist_ok=True)
        fetched = download_pretrained_from_url(
            e.url, cache_dir=os.path.dirname(p), expected_sha256=e.sha256)
        if fetched != p:
            os.replace(fetched, p)
        ok = os.path.isfile(p)
    if not ok:
        hint = ""
        if e.url and e.kind == "dir":
            hint = (" (its url is not auto-fetched: directory entries have "
                    "no archive convention — fetch/extract it yourself)")
        raise FileNotFoundError(
            f"pretrained '{name}' not found at {p}. This environment cannot "
            f"download; obtain it from: {e.source} and place it at that path "
            f"(or set KEEP_TPU_HOME / edit registry.json).{hint}"
        )
    if verify and e.sha256 and e.kind == "file":
        got = sha256_file(p)
        if not got.startswith(e.sha256):
            raise ValueError(
                f"sha256 mismatch for '{name}' at {p}: expected {e.sha256}, "
                f"got {got} — the file is corrupt or the wrong release."
            )
    return p


def fetch(name_or_path_or_url: str) -> str:
    """One front door for ``create_model(pretrained=...)``: an existing local
    path is returned as-is, a URL is downloaded+cached, anything else is
    treated as a registry name."""
    s = name_or_path_or_url
    if os.path.exists(s):
        return s
    if "://" in s:
        return download_pretrained_from_url(s)
    return resolve(s)
