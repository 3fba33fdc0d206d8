"""Ahead-of-time export of the inference entry points through
``torch.export`` (counterpart of ``keep_tpu/compat/aot.py``, which
serializes StableHLO through ``jax.export``).

``torch.export`` traces ``encode_image`` / ``encode_text`` once into an
ATen graph and ``torch.export.save`` writes it to a ``.pt2`` file that a
later process loads (``load_aot``) and runs without re-tracing Python. The
hand-written kernels are ``keep::`` operators (``kernels._library``), so the
graph records them by name, and a loaded graph launches the same kernels
(on the card) or their plain versions (on the CPU) as the eager model does.

The JAX module's contract, in PyTorch terms:

- **A symbolic batch dimension** (``torch.export.Dim``): without buckets,
  one artifact serves every batch size. It is traced from an example of 2
  rows, since ``torch.export`` specialises a dimension whose example size
  is 1.
- **Batch buckets** for ``use_flash=True``: one artifact per bucket, and
  the loader pads to the smallest covering bucket and slices the rows back,
  as the JAX package's Pallas path must (its kernels need concrete block
  shapes); past the largest bucket it raises.
- **Weights stay in the checkpoint** by default: ``bake_params=False``
  keeps the parameters and buffers (the int8 codes and scales of a
  quantized model too) out of the artifact, and the loaded callable takes
  them first, as a ``{name: tensor}`` state dict. ``bake_params=True``
  writes them into the artifact, which is then self-contained.

An artifact is tied to the device type it was exported on (the graph's
factory calls carry it), as the JAX artifacts are to their platforms.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
from typing import Callable, Mapping, Sequence

import torch
from torch import nn

from keep_tpu_torch.presets import card_device
from keep_tpu_torch.quant import is_quantized

FORMAT = "torch.export"
_MANIFEST = "aot_manifest.json"
_SYM = "sym"
_MAX_BATCH = 1 << 16
# the dtype of the token ids and mask the text artifacts take
_IDS_DTYPE = torch.int64


class _Fn(nn.Module):
    """A plain callable as the module ``torch.export`` traces."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_fn(fn: Callable | nn.Module, *example_args,
              dynamic_shapes=None) -> bytes:
    """``torch.export`` of ``fn`` at ``example_args`` (``dynamic_shapes`` as
    ``torch.export.export`` takes them), serialized to bytes."""
    mod = fn if isinstance(fn, nn.Module) else _Fn(fn)
    with torch.no_grad():
        ep = torch.export.export(mod, tuple(example_args),
                                 dynamic_shapes=dynamic_shapes, strict=False)
    # the program keeps its example inputs, which it would save: for a lean
    # export those are the weights
    ep.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def load_fn(blob: bytes) -> Callable:
    """An ``export_fn`` artifact back to a callable. The ``keep::``
    operators are registered first, so the graph finds the kernels."""
    import keep_tpu_torch.kernels  # noqa: F401  (registers keep::*)

    return torch.export.load(io.BytesIO(blob)).module()


class _Image(nn.Module):
    """``encode_image`` of a ``KEEPModel`` as a module that holds the
    towers it runs (``visual``, ``visual_head``) under the model's names, so
    that nothing of the other tower is exported with it."""

    towers = ("visual", "visual_head")

    def __init__(self, model: nn.Module):
        super().__init__()
        self.__dict__["model"] = model
        for name in self.towers:
            setattr(self, name, getattr(model, name))

    def forward(self, pixels):
        return self.model.encode_image(pixels)


class _Text(_Image):
    """``encode_text`` as ``_Image`` holds ``encode_image``."""

    towers = ("text",)

    def forward(self, input_ids, attention_mask):
        return self.model.encode_text(input_ids, attention_mask)


def _lean(encoder: nn.Module, n_data: int) -> nn.Module:
    """``encoder`` with its parameters and buffers as the first input (a
    ``{name: tensor}`` dict): the encoder is held outside the module tree,
    so nothing of it is exported but the graph."""

    def call(params, data):
        return torch.func.functional_call(encoder, params, data)

    class Lean(nn.Module):
        if n_data == 1:
            def forward(self, params, pixels):
                return call(params, (pixels,))
        else:
            def forward(self, params, input_ids, attention_mask):
                return call(params, (input_ids, attention_mask))

    return Lean()


def _state(module: nn.Module) -> dict:
    return {k: v.detach() for k, v in module.state_dict().items()}


@contextlib.contextmanager
def _configured(model: nn.Module, **attrs):
    """``model`` with its compute attributes (``dtype``, ``use_flash``,
    ``gelu_approx``) set for the export, restored afterwards."""
    saved = {k: getattr(model, k) for k in attrs}
    try:
        for k, v in attrs.items():
            setattr(model, k, v)
        yield model
    finally:
        for k, v in saved.items():
            setattr(model, k, v)


def _example(model: nn.Module, b: int, device) -> tuple:
    """Example pixels, ids and mask of ``b`` rows (a seeded draw)."""
    cfg = model.cfg
    gen = torch.Generator().manual_seed(0)
    size = cfg.vision.img_size
    pixels = torch.randn(b, size, size, 3, generator=gen).to(device)
    seq = cfg.max_text_length
    ids = torch.randint(1, cfg.text.vocab_size, (b, seq), generator=gen,
                        dtype=_IDS_DTYPE).to(device)
    mask = torch.ones(b, seq, dtype=_IDS_DTYPE)
    mask[:, seq // 2:] = 0
    return pixels, ids, mask.to(device)


def export_encoders(model: nn.Module, *, dtype: torch.dtype | None = None,
                    use_flash: bool | None = None,
                    gelu_approx: bool | None = None,
                    bake_params: bool = False,
                    batch_sizes: Sequence[int] | None = None) -> dict:
    """Export a ``KEEPModel``'s ``encode_image`` and ``encode_text``.

    Returns ``{"encode_image": {key: bytes}, "encode_text": {...},
    "manifest": dict}`` where ``key`` is ``"sym"`` (symbolic batch: one
    artifact for every batch size) or a bucket's batch size. The text
    length is fixed at ``cfg.max_text_length`` (the tokenizer contract).
    ``dtype``, ``use_flash`` and ``gelu_approx`` default to the model's;
    the export runs on the model's device, and its artifacts load there.
    A quantized model (``KEEPModel.quantize()``) exports its int8 path.

    ``use_flash=True`` requires ``batch_sizes``, as in the JAX package,
    whose fused kernels need concrete shapes: each bucket is its own
    export."""
    use_flash = model.use_flash if use_flash is None else use_flash
    if use_flash and not batch_sizes:
        raise ValueError(
            "use_flash exports need concrete shapes (the JAX package's "
            "Pallas BlockSpecs are not shape-polymorphic, and the bundles "
            "keep one contract) — pass batch_sizes=(1, 8, 32, ...) for "
            "bucketed artifacts, or export with use_flash=False for one "
            "symbolic-batch artifact")
    dtype = model.dtype if dtype is None else dtype
    gelu_approx = model.gelu_approx if gelu_approx is None else gelu_approx
    device = next(model.parameters()).device
    if batch_sizes:
        keys_dims = [(str(int(b)), int(b)) for b in sorted(set(batch_sizes))]
    else:
        keys_dims = [(_SYM, torch.export.Dim("batch", min=1,
                                             max=_MAX_BATCH))]
    blobs = {"encode_image": {}, "encode_text": {}}
    params = {}
    with _configured(model, dtype=dtype, use_flash=use_flash,
                     gelu_approx=gelu_approx):
        for name, tower in (("encode_image", "image"), ("encode_text",
                                                        "text")):
            enc = (_Image if tower == "image" else _Text)(model)
            fn = enc if bake_params else _lean(enc, 1 if tower == "image"
                                               else 2)
            params[name] = list(_state(enc))
            for key, dim in keys_dims:
                pixels, ids, mask = _example(model, 2 if key == _SYM else dim,
                                             device)
                data = (pixels,) if tower == "image" else (ids, mask)
                shapes = tuple({0: dim} if key == _SYM else None
                               for _ in data)
                args = data
                if not bake_params:
                    args = (_state(enc),) + data
                    shapes = ({k: None for k in args[0]},) + shapes
                blobs[name][key] = export_fn(
                    fn, *args,
                    dynamic_shapes=shapes if key == _SYM else None)
    cfg = model.cfg
    manifest = {
        "format": FORMAT,
        "bake_params": bake_params,
        "dtype": str(dtype).removeprefix("torch."),
        "use_flash": use_flash,
        "gelu_approx": gelu_approx,
        "quantized": is_quantized(model),
        "buckets": [k for k, _ in keys_dims],
        # the state-dict entries each lean artifact takes first
        "params": {} if bake_params else params,
        "img_size": cfg.vision.img_size,
        "max_text_length": cfg.max_text_length,
        "platforms": [device.type],
        "torch": torch.__version__,
    }
    return {**blobs, "manifest": manifest}


def save_aot(model_dir: str, model: nn.Module, **kwargs) -> None:
    """Write ``encode_{image,text}.<bucket>.pt2`` + ``aot_manifest.json``
    into ``model_dir`` (beside the weight files that
    ``compat.export.save_pretrained`` writes). Each file is written under a
    temporary name and renamed into place."""
    arts = export_encoders(model, **kwargs)
    os.makedirs(model_dir, exist_ok=True)
    files = {f"{name}.{key}.pt2": blob
             for name in ("encode_image", "encode_text")
             for key, blob in arts[name].items()}
    files[_MANIFEST] = json.dumps(arts["manifest"], indent=1).encode()
    for fname, blob in files.items():
        path = os.path.join(model_dir, fname)
        with open(path + ".tmp", "wb") as f:
            f.write(blob)
        os.replace(path + ".tmp", path)


def _pad_rows(x: torch.Tensor, to: int) -> torch.Tensor:
    n = x.shape[0]
    if n == to:
        return x
    return torch.cat([x, x.new_zeros((to - n,) + tuple(x.shape[1:]))])


class AOTModel:
    """A loaded AOT bundle: ``encode_image(...)`` / ``encode_text(...)``.

    With ``bake_params=False`` (the default export) pass the model's state
    dict (``{name: tensor}``, on the bundle's device; each tower takes the
    entries the manifest's ``params`` lists) first; with baked parameters,
    only the data. Bucketed bundles pad each call to the
    smallest covering bucket and slice the rows back (each row's encode is
    independent of the others); a batch past the largest bucket raises."""

    def __init__(self, model_dir: str, device=None):
        with open(os.path.join(model_dir, _MANIFEST)) as f:
            self.manifest = json.load(f)
        fmt = self.manifest.get("format")
        if fmt != FORMAT:
            raise ValueError(
                f"{model_dir}: an AOT bundle of format {fmt!r}; the PyTorch "
                f"port loads {FORMAT!r} bundles (a jax.export/stablehlo "
                f"bundle loads with keep_tpu.compat.aot.load_aot)")
        self.device = card_device(device)
        platform = self.manifest["platforms"][0]
        if self.device.type != platform:
            raise ValueError(
                f"{model_dir}: the bundle was exported on {platform!r} and "
                f"runs there; asked for {self.device}")
        self._fns: dict[str, dict[str, Callable]] = {}
        for name in ("encode_image", "encode_text"):
            self._fns[name] = {}
            for key in self.manifest["buckets"]:
                with open(os.path.join(model_dir, f"{name}.{key}.pt2"),
                          "rb") as f:
                    self._fns[name][key] = load_fn(f.read())

    def _dispatch(self, name: str, params: Mapping | None, data: tuple):
        fns = self._fns[name]
        prefix = () if params is None else (
            {k: params[k] for k in self.manifest["params"][name]},)
        with torch.no_grad():
            if _SYM in fns:
                return fns[_SYM](*prefix, *data)
            n = data[0].shape[0]
            buckets = sorted(int(k) for k in fns)
            fit = next((b for b in buckets if b >= n), None)
            if fit is None:
                raise ValueError(f"batch {n} exceeds the largest exported "
                                 f"bucket {buckets[-1]}")
            out = fns[str(fit)](*prefix, *(_pad_rows(a, fit) for a in data))
        return out[:n]

    def _split(self, args: tuple, n_data: int) -> tuple:
        if self.manifest["bake_params"]:
            if len(args) != n_data:
                raise TypeError(f"a baked bundle takes {n_data} data "
                                f"argument(s), got {len(args)}")
            return None, args
        if len(args) != n_data + 1:
            raise TypeError(f"this bundle takes the parameters first, then "
                            f"{n_data} data argument(s); got {len(args)}")
        return args[0], args[1:]

    def _to(self, x, dtype) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device, dtype)

    def encode_image(self, *args) -> torch.Tensor:
        """([params,] pixels [B, H, W, 3] fp32) → [B, projection_dim]."""
        params, (pixels,) = self._split(args, 1)
        return self._dispatch("encode_image", params,
                              (self._to(pixels, torch.float32),))

    def encode_text(self, *args) -> torch.Tensor:
        """([params,] input_ids [B, S], attention_mask [B, S]) → [B,
        hidden], with S the manifest's ``max_text_length``."""
        params, (ids, mask) = self._split(args, 2)
        return self._dispatch("encode_text", params,
                              (self._to(ids, _IDS_DTYPE),
                               self._to(mask, _IDS_DTYPE)))


def load_aot(model_dir: str, device=None) -> AOTModel:
    """The bundle in ``model_dir`` on ``device`` (default: the card; raises
    without one unless ``device="cpu"``)."""
    return AOTModel(model_dir, device)
