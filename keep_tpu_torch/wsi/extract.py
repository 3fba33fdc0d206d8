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

``extract_wsi_to_h5`` streams a pyramidal slide's tissue tiles
(``io.tiles.iter_wsi_tiles``) through the same pipeline into an h5 file.
With ``mesh=`` each device runs its own such pipeline on its chunk of
every batch.
"""

from __future__ import annotations

from collections import deque
from typing import Iterable, Iterator

import numpy as np
import torch

from keep_tpu_torch.configs import PreprocessConfig
from keep_tpu_torch.ops.preprocess import normalize_only, preprocess
from keep_tpu_torch.parallel import replicate

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


class _Pipeline:
    """One device's side of the extraction: ``dispatch`` a chunk (padded to
    ``batch_size`` rows) without waiting, ``fetch`` its features later."""

    def __init__(self, model, batch_size: int, encode):
        self.model = model
        self.batch_size = batch_size
        self.encode = encode  # (model, uint8 device tiles) -> features
        self.device = next(model.parameters()).device
        self.dim = model.cfg.projection_dim
        self.cuda = self.device.type == "cuda"
        if self.cuda:
            self.up = torch.cuda.Stream(self.device)
            self.down = torch.cuda.Stream(self.device)
        self.free: list[_Slot] = []

    def dispatch(self, chunk: np.ndarray):
        n = chunk.shape[0]
        if not self.cuda:
            if n < self.batch_size:
                chunk = np.pad(chunk, ((0, self.batch_size - n), (0, 0),
                                       (0, 0), (0, 0)))
            return self.encode(self.model, torch.from_numpy(
                np.ascontiguousarray(chunk)).to(self.device)), n
        with torch.cuda.device(self.device):
            return self._dispatch_cuda(chunk, n), n

    def _dispatch_cuda(self, chunk: np.ndarray, n: int) -> _Slot:
        device, up, down = self.device, self.up, self.down
        compute = torch.cuda.current_stream(device)
        shape = (self.batch_size,) + chunk.shape[1:]
        if self.free:
            slot = self.free.pop()
        else:
            slot = _Slot(shape, self.dim, device)
            # the new device buffer may take memory that work queued on the
            # compute stream still uses (the allocator orders reuse on that
            # stream only): its upload waits for that work
            up.wait_stream(compute)
        host = slot.host_in.numpy()
        host[:n] = chunk
        host[n:] = 0
        with torch.cuda.stream(up):
            slot.dev_in.copy_(slot.host_in, non_blocking=True)
            slot.uploaded.record(up)
        compute.wait_event(slot.uploaded)
        feats = self.encode(self.model, slot.dev_in)
        slot.computed.record(compute)
        with torch.cuda.stream(down):
            down.wait_event(slot.computed)
            feats.record_stream(down)
            slot.host_out.copy_(feats, non_blocking=True)
            slot.fetched.record(down)
        return slot

    def fetch(self, handle, n: int) -> np.ndarray:
        if not self.cuda:
            return handle.cpu().numpy()[:n]
        handle.fetched.synchronize()
        out = handle.host_out.numpy()[:n].copy()
        self.free.append(handle)
        return out


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
    ``mesh`` (``parallel.make_mesh``): shard the tile axis over its devices,
    the model replicated on each; ``batch_size`` is rounded up to a
    multiple of the mesh, and each batch splits into one contiguous chunk
    per device, dispatched on every device before the first is fetched.
    ``pipeline_depth``: batches kept in flight before the oldest is fetched
    (1 = double buffering); it changes the order of fetches, never a
    value."""
    if mesh is not None:
        mesh = tuple(mesh)
        batch_size += (-batch_size) % len(mesh)  # divisible batch shape
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

    def encode(m, x: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            pixels = (preprocess(x, preprocess_cfg) if resize
                      else normalize_only(x, preprocess_cfg))
            return m.encode_image(pixels)

    models = [model] if mesh is None else replicate(mesh, model)
    per = batch_size // len(models)
    pipes = [_Pipeline(m, per, encode) for m in models]

    def dispatch(chunk: np.ndarray) -> list:
        return [(pipe, pipe.dispatch(chunk[i * per: (i + 1) * per]))
                for i, pipe in enumerate(pipes) if i * per < len(chunk)]

    def fetch(handles: list) -> np.ndarray:
        return np.concatenate([pipe.fetch(*h) for pipe, h in handles])

    pending: deque = deque()
    outs: list[np.ndarray] = []
    for c in chunks:
        pending.append(dispatch(c))
        if len(pending) > pipeline_depth:
            outs.append(fetch(pending.popleft()))
    while pending:
        outs.append(fetch(pending.popleft()))
    if not outs:  # a slide with no tissue tiles keeps the feature width
        return np.zeros((0, model.cfg.projection_dim), np.float32)
    return np.concatenate(outs, axis=0)


def extract_wsi_to_h5(model, slide_path: str, out_path: str,
                      patch_size: int = 256, tissue_fraction: float = 0.25,
                      level: int = 0, batch_size: int = 256, **kw) -> int:
    """Pyramidal slide (.svs / .tif) → CLAM-style h5, streaming: the tissue
    tiles are read chunk by chunk at ``level`` (``io.tiles.iter_wsi_tiles``)
    and encoded at one batch shape, never holding the slide in memory.
    Returns the tile count. Coords are (x, y) at ``level`` (level 0: the
    CLAM convention)."""
    import h5py

    from keep_tpu_torch.io.tiles import iter_wsi_tiles

    coords_acc: list[np.ndarray] = []

    def tile_chunks():
        for tiles, coords in iter_wsi_tiles(
                slide_path, patch_size=patch_size,
                tissue_fraction=tissue_fraction, chunk=batch_size,
                level=level):
            coords_acc.append(coords)
            yield tiles

    features = extract_features(model, tile_chunks(), batch_size=batch_size,
                                **kw)
    coords = (np.concatenate(coords_acc) if coords_acc
              else np.zeros((0, 2), np.int64))
    with h5py.File(out_path, "w") as f:
        f.create_dataset("features", data=features)
        f.create_dataset("coords", data=coords)
    return len(coords)


def extract_to_h5(model, tiles: np.ndarray, coords: np.ndarray, out_path: str,
                  batch_size: int = 256, **kw) -> None:
    """Write the CLAM-style h5 (features + coords) the WSI pipelines read."""
    import h5py

    features = extract_features(model, tiles, batch_size=batch_size, **kw)
    with h5py.File(out_path, "w") as f:
        f.create_dataset("features", data=features)
        f.create_dataset("coords", data=np.asarray(coords))
