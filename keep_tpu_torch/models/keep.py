"""The KEEP model and its published inference API (counterpart of
``keep_tpu/models/keep.py``).

  encode_image(pixels)       = l2_normalize(visual_head(vit(pixels)))
  encode_text(ids, mask, tt) = l2_normalize(bert(...).pooler_output)

with ``visual_head`` = Linear(1024→768) → exact GELU → Linear(768→768).
Both encoders train (``remat`` for per-block recompute); ``KEEPModel.init``
draws a random model for training from scratch. A config with
``vision.moe_experts > 0`` takes the Switch-MoE trunk
(``models.moe.MoEVisionTransformer``) as its image tower, whose
load-balancing loss ``encode_image(..., return_aux=True)`` returns beside
the features (0 for the dense trunk).
"""

from __future__ import annotations

import copy
import math
import os

import torch
from torch import nn

from keep_tpu_torch.configs import KEEPConfig
from keep_tpu_torch.models.bert import BertModel
from keep_tpu_torch.models.moe import MoEVisionTransformer
from keep_tpu_torch.models.vit import VisionTransformer
from keep_tpu_torch.ops.nn import (Linear, cast_linear_weights, gelu,
                                   l2_normalize)


class VisualHead(nn.Module):
    def __init__(self, d_in: int, d_out: int, *, device=None):
        super().__init__()
        self.fc1 = Linear(d_in, d_out, device=device)
        self.fc2 = Linear(d_out, d_out, device=device)
        # the tensor-parallel split of the fc1 / fc2 pair
        # (parallel.tp.shard_model_); None: whole on every rank
        self.tp = None

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        # the head's GELU is always the exact erf form
        if self.tp is not None and self.tp.mlp:
            from keep_tpu_torch.parallel import tp as ptp

            feats = ptp.mlp_pair(self, feats, self.tp)
        else:
            feats = self.fc2(gelu(self.fc1(feats)))
        return l2_normalize(feats.float())


class KEEPModel(nn.Module):
    """ViT-L/16 image tower, visual head and BERT text tower.

    ``dtype`` is the compute dtype. The matmul weights are stored in
    ``weight_dtype``, by default the same (``load_state_dict`` rounds fp32
    values into them; the JAX package casts its fp32 kernels to the same
    values on every call), while LayerNorm, biases and embedding tables stay
    fp32; a narrower weight keeps the fp32 values it was loaded from on the
    host, for ``quantize()``. ``use_flash`` routes attention
    through the fused kernel. ``gelu_approx=None`` means the tanh GELU under
    bf16 and the erf GELU otherwise, as in the JAX package. Parameters are
    created empty: load a state dict (``from_pretrained`` does)."""

    family = "keep"

    def __init__(self, cfg: KEEPConfig, *, dtype: torch.dtype = torch.float32,
                 use_flash: bool = False, gelu_approx: bool | None = None,
                 device=None, weight_dtype: torch.dtype | None = None):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.use_flash = use_flash
        self.gelu_approx = (dtype == torch.bfloat16 if gelu_approx is None
                            else gelu_approx)
        self.visual = (MoEVisionTransformer(cfg.vision, device=device)
                       if self.moe else
                       VisionTransformer(cfg.vision, device=device))
        self.visual_head = VisualHead(cfg.vision.embed_dim, cfg.projection_dim,
                                      device=device)
        self.text = BertModel(cfg.text, device=device)
        self.logit_scale = nn.Parameter(torch.tensor(
            math.log(1.0 / cfg.logit_scale_init), device=device))
        cast_linear_weights(self, weight_dtype or dtype)

    @property
    def moe(self) -> bool:
        """Whether the image tower is the Switch-MoE trunk."""
        return self.cfg.vision.moe_experts > 0

    def encode_image(self, pixels: torch.Tensor, remat: bool = False,
                     return_aux: bool = False, act_sharding=None):
        """[B, H, W, 3] normalised pixels → [B, projection_dim] unit fp32.
        ``remat`` recomputes each block in the backward. ``return_aux``
        also returns the MoE trunk's load-balancing loss (a 0 tensor for
        the dense trunk); the MoE trunk's attention is plain, as in the JAX
        package (``use_flash`` does not reach it). ``act_sharding``
        (``parallel.sp.SeqParallel``, dense trunk only) splits the stream
        along S between the blocks."""
        if self.moe:
            if act_sharding is not None:
                raise ValueError("sequence parallelism (solver.sp) is not "
                                 "composed with the MoE trunk")
            feats, aux = self.visual(pixels, dtype=self.dtype,
                                     gelu_approx=self.gelu_approx,
                                     remat=remat)
        else:
            feats = self.visual(pixels, dtype=self.dtype,
                                use_flash=self.use_flash,
                                gelu_approx=self.gelu_approx, remat=remat,
                                act_sharding=act_sharding)
            aux = torch.zeros((), device=feats.device)
        feats = self.visual_head(feats)
        return (feats, aux) if return_aux else feats

    def encode_image_pp(self, pixels: torch.Tensor, mesh=None,
                        remat: bool = False,
                        num_microbatches: int | None = None) -> torch.Tensor:
        """``encode_image`` with the ViT trunk pipelined over the 'pp' axis
        of ``mesh`` (default: the current process mesh; GPipe,
        ``parallel.pp.vit_forward_pp``): the same features on every pp
        rank; the stem, the head and the visual head run on every rank.
        The MoE trunk raises, as in the JAX package."""
        if self.moe:
            raise NotImplementedError(
                "pipeline parallelism does not compose with the MoE trunk "
                "(train it with dp/fsdp/ep) — same rule the CLI enforces")
        from keep_tpu_torch.parallel.pp import vit_forward_pp

        feats = vit_forward_pp(self.visual, pixels, mesh,
                               num_microbatches=num_microbatches,
                               dtype=self.dtype, use_flash=self.use_flash,
                               gelu_approx=self.gelu_approx, remat=remat)
        return self.visual_head(feats)

    def encode_text(self, input_ids: torch.Tensor,
                    attention_mask: torch.Tensor | None = None,
                    token_type_ids: torch.Tensor | None = None,
                    remat: bool = False, act_sharding=None) -> torch.Tensor:
        """[B, S] token ids (+ mask) → [B, hidden] unit fp32 features;
        ``act_sharding`` as for ``encode_image``."""
        out = self.text(input_ids, attention_mask, token_type_ids,
                        dtype=self.dtype, use_flash=self.use_flash,
                        gelu_approx=self.gelu_approx, remat=remat,
                        act_sharding=act_sharding)
        return l2_normalize(out["pooler_output"].float())

    @property
    def config(self) -> KEEPConfig:
        return self.cfg

    def forward(self, pixels: torch.Tensor, input_ids: torch.Tensor,
                attention_mask: torch.Tensor | None = None,
                return_aux: bool = False) -> dict:
        """Both towers' unit features, the JAX package's ``keep.forward``
        contract (the factory's uniform ``forward``); ``return_aux`` adds
        the MoE aux loss as ``"aux"``."""
        out = {}
        img = self.encode_image(pixels, return_aux=return_aux)
        if return_aux:
            img, out["aux"] = img
        out["image_features"] = img
        out["text_features"] = self.encode_text(input_ids, attention_mask)
        return out

    @classmethod
    @torch.no_grad()
    def init(cls, cfg: KEEPConfig, generator: torch.Generator, *,
             logit_scale: float | None = None, device=None,
             **kw) -> "KEEPModel":
        """A randomly initialised model, drawn from ``generator`` with the
        statistics of the JAX package's ``keep.init`` (ViT and head weights
        std fan_in^-0.5, BERT weights and embeddings std .02, zero biases,
        unit LayerNorms, LayerScale at ``layerscale_init``), with
        ``logit_scale = log(1 / logit_scale)`` (default: the config's
        ``logit_scale_init``). ``kw`` go to the constructor; for training
        pass ``weight_dtype=torch.float32`` to keep fp32 master weights."""
        from keep_tpu_torch.compat.torch_loader import (load_keep_state_dict,
                                                        random_keep_state_dict)

        if cfg.vision.moe_experts > 0:
            # the MoE trunk has no released layout: each tower draws its own
            model = cls(cfg, device=device, **kw)
            model.visual.init_weights(generator)
            for lin in (model.visual_head.fc1, model.visual_head.fc2):
                lin.weight.normal_(0.0, lin.weight.shape[1] ** -0.5,
                                   generator=generator)
                lin.bias.zero_()
            model.text.init_weights(generator)
        else:
            sd = load_keep_state_dict(random_keep_state_dict(
                cfg, generator, device=device, keep_init=True), cfg)
            model = cls(cfg, device=device, **kw)
            model.load_state_dict(sd, strict=True)
        model.logit_scale.fill_(math.log(
            1.0 / (cfg.logit_scale_init if logit_scale is None
                   else logit_scale)))
        return model

    def quantize(self, calib_pixels=None, smooth_alpha: float = 0.5,
                 calib_text=None, moe_w8a16: bool = False) -> "KEEPModel":
        """The W8A8 int8 inference variant (see ``keep_tpu_torch.quant``),
        as a new model; ``self`` stays float and unchanged, as in the JAX
        package, so that the two can be held against each other. In the
        copy, LayerScale is folded into proj and fc2 first (exact), then
        every targeted linear of both towers and the visual head is
        quantized, and the linears that stay float (the text pooler) are
        cast to the compute dtype. ``use_flash`` and ``gelu_approx`` are
        kept: with both on, the blocks run the int8 megakernels.

        Each weight is quantized from the fp32 values it was loaded from
        (``ops.nn.Linear.quantize_source``), whatever dtype stores it, so
        the int8 codes equal the JAX package's ``KEEPModel.quantize()`` bit
        for bit; a weight changed since it was loaded is quantized as
        stored.

        SmoothQuant calibration, as the JAX package's: ``calib_text``
        (``input_ids`` [N, S], or ``(input_ids, attention_mask)``) smooths
        the BERT tower in the ``pre_scale`` form (``quant.smooth_bert``);
        ``calib_pixels`` ([N, H, W, 3] normalised images) smooths the ViT's
        LayerNorm → qkv / fc1 edges (``quant.smooth_vit``) after the
        LayerScale fold. The statistics come from fp32 forwards with plain
        attention over the fp32 weights.

        An MoE trunk (``vision.moe_experts > 0``) has no LayerScale: its
        expert ``wi`` / ``wo`` are quantized too (``quant.MOE_TARGETS``; the
        router stays fp32), ``calib_pixels`` smooths it with
        ``quant.smooth_moe`` (norm2's scale folded into both the router and
        every expert's ``wi``, so routing is unchanged), and ``moe_w8a16``
        makes the experts weight-only int8 (W8A16); on a dense trunk
        ``moe_w8a16`` changes nothing, as in the JAX package."""
        from keep_tpu_torch.quant import is_quantized

        if is_quantized(self):
            raise ValueError(
                "the model is already quantized (QLinear present): "
                "double-quantizing int8 weights would corrupt them")
        # the host copies of the fp32 weights are read, never written:
        # the copy shares them
        memo = {id(m.fp32_weight): m.fp32_weight for m in self.modules()
                if isinstance(m, Linear) and m.fp32_weight is not None}
        model = copy.deepcopy(self, memo)
        model._quantize_in_place(calib_pixels, smooth_alpha, calib_text,
                                 moe_w8a16)
        return model

    @torch.no_grad()
    def _quantize_in_place(self, calib_pixels=None, smooth_alpha: float = 0.5,
                           calib_text=None, moe_w8a16: bool = False) -> None:
        """``quantize()``'s work on this float model itself."""
        from keep_tpu_torch import quant
        from keep_tpu_torch.models.vit import fold_layerscale

        for m in self.modules():
            if isinstance(m, Linear):
                m.weight.data = m.quantize_source()
                m.fp32_weight = None
        if calib_text is not None:
            ids, mask = (calib_text if isinstance(calib_text, (tuple, list))
                         else (calib_text, None))
            quant.smooth_bert(self.text, quant.bert_ln_stats(self.text, ids,
                                                             mask),
                              smooth_alpha)
        if self.moe:
            if calib_pixels is not None:
                quant.calibrate_smooth_moe(self.visual, calib_pixels,
                                           smooth_alpha)
            quant.quantize_linear_weights(
                self, quant.MOE_TARGETS,
                weight_only=("wi", "wo") if moe_w8a16 else ())
        else:
            fold_layerscale(self.visual)
            if calib_pixels is not None:
                quant.smooth_vit(self.visual,
                                 quant.vit_ln_stats(self.visual,
                                                    calib_pixels),
                                 smooth_alpha)
            quant.quantize_linear_weights(self)
        cast_linear_weights(self, self.dtype)

    @classmethod
    def from_pretrained(cls, model_dir: str,
                        dtype: torch.dtype = torch.float32,
                        use_flash: bool = False, device=None,
                        cfg: KEEPConfig | None = None,
                        quantize: bool = False) -> "KEEPModel":
        """Reads ``config.json`` and ``pytorch_model.bin`` (or
        ``model.safetensors``) in the released layout. ``quantize=True``
        returns the int8 model (``quantize()``), quantized from the
        checkpoint's fp32 values before the float linears are cast to
        ``dtype``.

        A model dir that carries this package's int8 deploy artifact
        (``compat.export.save_quantized``, under
        ``export.QUANTIZED_SUBDIR``) loads that, as the JAX package's
        ``from_pretrained`` loads its own: the int8 model as it was
        quantized and calibrated, in its compute dtype, with nothing
        re-quantized (``quantize`` and ``dtype`` then change nothing).
        The JAX package's artifact (a ``quantized/`` Orbax checkpoint) is
        not read by the port: a model dir that carries only that one
        raises.

        ``device`` defaults to the card (``cuda``); without one the call
        raises unless the caller asks for the CPU with ``device="cpu"``: it
        never moves to the CPU by itself."""
        from keep_tpu_torch.compat import export
        from keep_tpu_torch.compat.torch_loader import (load_keep_state_dict,
                                                        load_state_dict_file)

        def card_or_cpu() -> torch.device:
            dev = torch.device("cuda" if device is None else device)
            if dev.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError('no CUDA device: pass device="cpu" to load '
                                   'on the CPU')
            return dev

        if os.path.isdir(os.path.join(model_dir, export.QUANTIZED_SUBDIR)):
            return export.load_quantized(model_dir, use_flash=use_flash,
                                         device=card_or_cpu())
        if os.path.isdir(os.path.join(model_dir, "quantized")):
            raise NotImplementedError(
                f"{model_dir} carries the JAX package's quantized artifact "
                f"(quantized/, an Orbax checkpoint), which the PyTorch port "
                f"does not read; serve it with python -m keep_tpu.serve, or "
                f"load the fp checkpoint and quantize it here (--int8)")
        cfg = cfg or KEEPConfig.from_hf_json(os.path.join(model_dir,
                                                          "config.json"))
        for name in ("pytorch_model.bin", "model.safetensors"):
            weights = os.path.join(model_dir, name)
            if os.path.exists(weights):
                break
        else:
            raise FileNotFoundError(
                f"no pytorch_model.bin or model.safetensors in {model_dir}")
        device = card_or_cpu()
        sd = load_keep_state_dict(load_state_dict_file(weights), cfg)
        model = cls(cfg, dtype=dtype, use_flash=use_flash, device=device,
                    weight_dtype=torch.float32 if quantize else None)
        model.load_state_dict(sd, strict=True)
        if quantize:
            # the fresh model is quantized itself: no second copy on the card
            model._quantize_in_place()
        return model.eval()
