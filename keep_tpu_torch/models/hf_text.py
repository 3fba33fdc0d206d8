"""HF-architecture text towers for CLIP (counterpart of
``keep_tpu/models/hf_text.py``; the reference's ``HFTextEncoder``,
hf_model.py:93-169, and ``arch_dict`` in hf_configs.py), used by the
``roberta-*``, ``xlm-roberta-*`` and ``mt5-*`` presets.

- ``roberta`` / ``xlm-roberta``: the BERT encoder (``models.bert``, so the
  fused attention #1 under ``use_flash``) with RoBERTa's embeddings:
  positions from the padding (the first real token at ``pad_id + 1``),
  one token type, LayerNorm eps 1e-5;
- ``bert``: the plain BERT trunk;
- ``mt5``: the T5 encoder (``models.t5``).

Poolers (hf_model.py:46-91): ``mean`` (over the unpadded positions) and
``cls`` (BERT's tanh pooler output where the trunk has one). Projections
(hf_model.py:142-153): ``linear`` (``proj.w`` [d, out], no bias), ``mlp``
(``proj.fc1`` [d, (d+out)//2] → exact GELU → ``proj.fc2``, no biases) or
``none``; the matrices keep the JAX layout.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch
from torch import nn

from keep_tpu_torch.configs import BertConfig
from keep_tpu_torch.models.bert import BertModel
from keep_tpu_torch.models.t5 import T5Encoder
from keep_tpu_torch.ops.nn import gelu, l2_normalize


@dataclasses.dataclass(frozen=True)
class HFTextConfig:
    arch: str = "roberta"  # 'roberta' | 'xlm-roberta' | 'bert' | 'mt5'
    trunk: object = dataclasses.field(
        default_factory=lambda: BertConfig(
            vocab_size=50265, max_position_embeddings=514, type_vocab_size=1,
            ln_eps=1e-5, pad_token_id=1))
    output_dim: int = 512
    pooler: str = "mean"  # 'mean' | 'cls'
    proj: str = "mlp"  # 'mlp' | 'linear' | 'none'

    @property
    def context_length(self) -> int:
        """Usable positions: none fixed for mT5 (relative positions, 0);
        RoBERTa reserves the ``pad_id + 1`` leading slots."""
        if self.arch == "mt5":
            return 0
        if self.arch in ("roberta", "xlm-roberta"):
            return (self.trunk.max_position_embeddings
                    - self.trunk.pad_token_id - 1)
        return self.trunk.max_position_embeddings


def roberta_position_ids(input_ids: torch.Tensor,
                         pad_id: int) -> torch.Tensor:
    """``create_position_ids_from_input_ids``: pads stay at ``pad_id``,
    real tokens count up from ``pad_id + 1``."""
    mask = (input_ids != pad_id).long()
    return torch.cumsum(mask, dim=1) * mask + pad_id


class Projection(nn.Module):
    def __init__(self, kind: str, d: int, out: int, *, device=None):
        super().__init__()
        self.kind = kind
        def z(*shape):
            return nn.Parameter(torch.zeros(*shape, device=device))

        if kind == "mlp":
            hid = (d + out) // 2
            self.fc1, self.fc2 = z(d, hid), z(hid, out)
        elif kind == "linear":
            self.w = z(d, out)
        elif kind != "none":
            raise ValueError(f"unknown projection {kind!r}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dot = lambda a, w: torch.matmul(a, w.to(a.dtype))  # noqa: E731
        if self.kind == "mlp":
            return dot(gelu(dot(x, self.fc1)), self.fc2)
        if self.kind == "linear":
            return dot(x, self.w)
        return x


class HFText(nn.Module):
    def __init__(self, cfg: HFTextConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        if cfg.arch == "mt5":
            self.trunk = T5Encoder(cfg.trunk, device=device)
            d = cfg.trunk.d_model
        else:
            self.trunk = BertModel(cfg.trunk, device=device)
            d = cfg.trunk.hidden_size
        self.proj = Projection(cfg.proj, d, cfg.output_dim, device=device)

    def forward(self, input_ids: torch.Tensor, *,
                dtype: torch.dtype = torch.float32, normalize: bool = False,
                output_tokens: bool = False, **trunk_kw):
        """[B, S] ids → [B, output_dim] projected features (unnormalised,
        as ``HFTextEncoder.forward``; unit fp32 rows with ``normalize``).
        ``trunk_kw`` go to the BERT trunk (``use_flash``, ``gelu_approx``).
        ``output_tokens=True`` also returns the last hidden states [B, S,
        width] (without the CLS position under the ``cls`` pooler), the
        CoCa decoder's token stream."""
        cfg = self.cfg
        tc = cfg.trunk
        mask = (input_ids != tc.pad_token_id).long()
        if cfg.arch == "mt5":
            out = self.trunk(input_ids, mask, dtype=dtype)
        else:
            pos = (roberta_position_ids(input_ids, tc.pad_token_id)
                   if cfg.arch in ("roberta", "xlm-roberta") else None)
            out = self.trunk(input_ids, mask, dtype=dtype, position_ids=pos,
                             **trunk_kw)
        h = out["last_hidden_state"]
        if cfg.pooler == "mean":
            m = mask[:, :, None].to(h.dtype)
            pooled = (h * m).sum(dim=1) / m.sum(dim=1)
        elif cfg.pooler == "cls":
            pooled = out.get("pooler_output")
            if pooled is None:
                pooled = h[:, 0]
        else:
            raise ValueError(f"unknown pooler {cfg.pooler!r}")
        pooled = self.proj(pooled)
        if normalize:
            pooled = l2_normalize(pooled.float())
        if output_tokens:
            return pooled, (h[:, 1:] if cfg.pooler == "cls" else h)
        return pooled

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "HFText":
        """The trunk's init (``BertModel``'s / ``T5Encoder``'s), the
        projection's matrices normal with std fan_in^-0.5."""
        self.trunk.init_weights(generator)
        for p in self.proj.parameters():
            p.normal_(0.0, p.shape[0] ** -0.5, generator=generator)
        return self


def convert_hf_roberta(sd: Mapping, cfg: HFTextConfig,
                       proj_sd: Mapping | None = None) -> dict:
    """``transformers.RobertaModel`` / ``XLMRobertaModel`` state dict (the
    BERT encoder's keys) → ``HFText(cfg)``'s ``trunk.*`` entries, and with
    ``proj_sd`` (the reference's ``proj`` linears, [out, in]) its
    ``proj.*`` ones in the JAX layout."""
    from keep_tpu_torch.compat.torch_loader import _hf_bert, _tensor

    out = _hf_bert(sd, cfg.trunk, "", "trunk.")
    if proj_sd is not None:
        names = {"mlp": ("fc1", "fc2"), "linear": ("w",)}.get(cfg.proj, ())
        for n in names:
            out[f"proj.{n}"] = _tensor(proj_sd[n]).t().contiguous()
    return out
