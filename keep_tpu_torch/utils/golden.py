"""Golden-vector bundles: frozen oracle inputs/outputs as .npz files
(counterpart of ``keep_tpu/utils/golden.py``; numpy only).

``tests/golden/*.npz`` freeze small (input, output) pairs of the parity
oracles (the real ``transformers.BertModel``, the reference's WSI decision
functions), so that the contract survives without them: these helpers read
and write those bundles for the port too.

A pytree of nested dicts round-trips through a flat npz by joining key
paths with '/'; leaves are numpy arrays (scalars stored 0-d).
"""

from __future__ import annotations

import numpy as np

GOLDEN_DIR_DEFAULT = "tests/golden"


def flatten_tree(tree: dict, prefix: str = "") -> dict:
    """Nested dicts of array leaves → flat {'a/b/c': ndarray}."""
    out = {}
    for k, v in tree.items():
        if "/" in str(k):
            raise ValueError(f"key {k!r} contains the '/' separator")
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_tree(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def unflatten_tree(flat: dict) -> dict:
    """Inverse of :func:`flatten_tree`."""
    out: dict = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def pack_strings(strings: list[str]) -> dict:
    """List of str → {"bytes": uint8, "offsets": int64} arrays.

    numpy 'U' arrays silently truncate at NUL characters; the tokenizer
    golden cases deliberately include control bytes, so strings ride as
    raw UTF-8 with an offsets index instead."""
    blobs = [s.encode("utf-8") for s in strings]
    offsets = np.cumsum([0] + [len(b) for b in blobs]).astype(np.int64)
    buf = np.frombuffer(b"".join(blobs), np.uint8).copy() if blobs else \
        np.zeros(0, np.uint8)
    return {"bytes": buf, "offsets": offsets}


def unpack_strings(packed: dict) -> list[str]:
    """Inverse of :func:`pack_strings`."""
    buf = packed["bytes"].tobytes()
    off = packed["offsets"]
    return [buf[off[i]:off[i + 1]].decode("utf-8")
            for i in range(len(off) - 1)]


def save_bundle(path: str, tree: dict) -> None:
    """Write a nested dict of arrays as one compressed npz."""
    np.savez_compressed(path, **flatten_tree(tree))


def load_bundle(path: str) -> dict:
    """Read an npz written by :func:`save_bundle` back into nested dicts."""
    with np.load(path, allow_pickle=False) as z:
        return unflatten_tree({k: z[k] for k in z.files})
