"""Tile feature extraction: uint8 WSI tiles → KEEP image features
(counterpart of ``keep_tpu/wsi/extract.py``).

The CLAM step the reference delegates to other tools (its pipelines read
precomputed h5 features) as a batched device pipeline: uint8 tiles →
normalise (+ the bicubic resize) → ViT encode, at one batch shape with the
tail padded. On the card every batch in flight has its own pinned host
buffers: the tiles go up on one copy stream, the ViT runs on the current
stream, the features come down on a second copy stream into pinned memory,
and a CUDA event per batch says when they have landed, so the fetch of
batch k overlaps the compute of batch k+1 while the host fills the next
batch's buffer.

The mesh-sharded form (``mesh=``) and ``extract_wsi_to_h5`` (pyramidal
slides through the native reader) are not ported yet.
"""

from __future__ import annotations

from collections import deque
from typing import Iterable, Iterator

import numpy as np
import torch

from keep_tpu_torch.configs import PreprocessConfig
from keep_tpu_torch.ops.preprocess import normalize_only, preprocess

MESH_ITEM = "ROADMAP queue 1, item 10 (distributed)"


class _Slot:
    """Buffers of one batch in flight: pinned host tiles and features, the
    device tiles, and the events that order the two copies around the
    compute."""

    def __init__(self, shape, dim, device):
        self.host_in = torch.empty(shape, dtype=torch.uint8).pin_memory()
        self.dev_in = torch.empty(shape, dtype=torch.uint8, device=device)
        self.host_out = torch.empty((shape[0], dim),
                                    dtype=torch.float32).pin_memory()
        self.uploaded = torch.cuda.Event()
        self.computed = torch.cuda.Event()
        self.fetched = torch.cuda.Event()


def extract_features(
    model,
    tiles: np.ndarray | Iterable[np.ndarray],
    batch_size: int = 256,
    preprocess_cfg: PreprocessConfig = PreprocessConfig(),
    resize: bool = False,
    mesh=None,
    pipeline_depth: int = 2,
) -> np.ndarray:
    """uint8 tiles [N, S, S, 3] (or an iterable of such chunks) → [N, D]
    fp32 features, on the model's device. Every batch has ``batch_size``
    rows (the tail padded with zeros, its padded rows dropped), so one set
    of GEMM shapes serves the whole slide.

    ``resize``: the bicubic resize to ``preprocess_cfg.size``
    (``ops.preprocess.preprocess``) instead of ``normalize_only``.
    ``pipeline_depth``: batches kept in flight before the oldest is fetched
    (1 = double buffering); it changes the order of fetches, never a
    value."""
    if mesh is not None:
        raise NotImplementedError(
            f"extract_features(mesh=...) shards the tile axis over several "
            f"devices, which is {MESH_ITEM}, not ported yet")
    if isinstance(tiles, np.ndarray):
        chunks: Iterator[np.ndarray] = (
            tiles[i: i + batch_size] for i in range(0, len(tiles), batch_size))
    else:
        # an oversize chunk from a caller's iterable is cut to the batch
        # shape: one set of shapes, whatever the chunking
        def rechunk(it):
            for c in it:
                c = np.asarray(c)
                for i in range(0, len(c), batch_size):
                    yield c[i: i + batch_size]

        chunks = rechunk(tiles)
    if pipeline_depth < 1:
        raise ValueError(f"pipeline_depth must be >= 1, got {pipeline_depth}")

    device = next(model.parameters()).device
    dim = model.cfg.projection_dim
    cuda = device.type == "cuda"
    if cuda:
        up = torch.cuda.Stream(device)
        down = torch.cuda.Stream(device)
    free: list[_Slot] = []

    def encode(x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            pixels = (preprocess(x, preprocess_cfg) if resize
                      else normalize_only(x, preprocess_cfg))
            return model.encode_image(pixels)

    def dispatch(chunk: np.ndarray):
        n = chunk.shape[0]
        if not cuda:
            if n < batch_size:
                chunk = np.pad(chunk, ((0, batch_size - n), (0, 0), (0, 0),
                                       (0, 0)))
            return encode(torch.from_numpy(np.ascontiguousarray(
                chunk)).to(device)), n
        shape = (batch_size,) + chunk.shape[1:]
        if free:
            slot = free.pop()
        else:
            slot = _Slot(shape, dim, device)
            # the new device buffer may take memory that work queued on the
            # compute stream still uses (the allocator orders reuse on that
            # stream only): its upload waits for that work
            up.wait_stream(torch.cuda.current_stream(device))
        host = slot.host_in.numpy()
        host[:n] = chunk
        host[n:] = 0
        with torch.cuda.stream(up):
            slot.dev_in.copy_(slot.host_in, non_blocking=True)
            slot.uploaded.record(up)
        torch.cuda.current_stream(device).wait_event(slot.uploaded)
        feats = encode(slot.dev_in)
        slot.computed.record()
        with torch.cuda.stream(down):
            down.wait_event(slot.computed)
            feats.record_stream(down)
            slot.host_out.copy_(feats, non_blocking=True)
            slot.fetched.record(down)
        return slot, n

    def fetch(handle, n: int) -> np.ndarray:
        if not cuda:
            return handle.cpu().numpy()[:n]
        handle.fetched.synchronize()
        out = handle.host_out.numpy()[:n].copy()
        free.append(handle)
        return out

    pending: deque = deque()
    outs: list[np.ndarray] = []
    for c in chunks:
        pending.append(dispatch(c))
        if len(pending) > pipeline_depth:
            outs.append(fetch(*pending.popleft()))
    while pending:
        outs.append(fetch(*pending.popleft()))
    if not outs:  # a slide with no tissue tiles keeps the feature width
        return np.zeros((0, dim), np.float32)
    return np.concatenate(outs, axis=0)


def extract_to_h5(model, tiles: np.ndarray, coords: np.ndarray, out_path: str,
                  batch_size: int = 256, **kw) -> None:
    """Write the CLAM-style h5 (features + coords) the WSI pipelines read."""
    import h5py

    features = extract_features(model, tiles, batch_size=batch_size, **kw)
    with h5py.File(out_path, "w") as f:
        f.create_dataset("features", data=features)
        f.create_dataset("coords", data=np.asarray(coords))
