"""T5 / mT5 encoder (counterpart of ``keep_tpu/models/t5.py``): the text
trunk of the reference's ``mt5-*-ViT-*`` presets (HF ``MT5EncoderModel``,
hf_model.py:93-169, whose encoder alone is kept).

- RMSNorm (no mean, no bias), in fp32;
- no absolute positions: a bucketed relative-position bias [H, S, S],
  taken from the FIRST layer's table and shared by every layer, added to
  scores that are NOT scaled by Dh^-0.5;
- no biases; the attention's inner width num_heads·d_kv may differ from
  d_model;
- mT5's gated feed-forward, wo(gelu_tanh(wi_0(x)) · wi_1(x)).

Attention is the JAX package's plain form (fp32 scores, the bias and the
key mask added in fp32, softmax in fp32, p rounded to v's dtype, p·v
summed in fp32). The matrices keep the JAX layout, [in, out], and names
(``blocks.{i}.attn.{q,k,v,o}``, ``wi_0``, ``wi_1``, ``wo``, ``embed``,
``rel_bias``); each product is ``x @ w`` in x's dtype.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from keep_tpu_torch.compat.torch_loader import _tensor


@dataclasses.dataclass(frozen=True)
class T5EncoderConfig:
    vocab_size: int = 250112  # mt5
    d_model: int = 768
    d_kv: int = 64
    num_heads: int = 12
    d_ff: int = 2048
    num_layers: int = 12
    rel_buckets: int = 32
    rel_max_distance: int = 128
    ln_eps: float = 1e-6
    gated_ff: bool = True  # mt5 'gated-gelu'; False = the original ReLU
    pad_token_id: int = 0

    @property
    def inner_dim(self) -> int:
        return self.num_heads * self.d_kv


class RMSNorm(nn.Module):
    def __init__(self, d: int, eps: float, *, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(d, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x·rsqrt(mean(x²) + eps) in fp32, rounded to x's dtype, then
        times the gain in x's dtype (the JAX package's order)."""
        xf = x.float()
        var = (xf * xf).mean(dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + self.eps)).to(x.dtype) \
            * self.weight.to(x.dtype)


@functools.lru_cache(maxsize=8)
def relative_position_buckets(qlen: int, klen: int, num_buckets: int,
                              max_distance: int) -> np.ndarray:
    """HF ``_relative_position_bucket`` (bidirectional) as a [qlen, klen]
    int table."""
    rel = np.arange(klen)[None, :] - np.arange(qlen)[:, None]
    nb = num_buckets // 2
    ret = (rel > 0).astype(np.int64) * nb
    rel = np.abs(rel)
    max_exact = nb // 2
    large = max_exact + (
        np.log(np.maximum(rel, 1) / max_exact)
        / np.log(max_distance / max_exact) * (nb - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, nb - 1)
    return ret + np.where(rel < max_exact, rel, large)


def _matrix(fin: int, fout: int, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(fin, fout, device=device))


def _dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, w.to(x.dtype))


class Attention(nn.Module):
    def __init__(self, cfg: T5EncoderConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        d, di = cfg.d_model, cfg.inner_dim
        self.q, self.k, self.v = (_matrix(d, di, device) for _ in range(3))
        self.o = _matrix(di, d, device)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        h, dk = self.cfg.num_heads, self.cfg.d_kv
        q, k, v = (_dot(x, w).reshape(b, s, h, dk).transpose(1, 2)
                   for w in (self.q, self.k, self.v))
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) + bias
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.matmul(probs.float(), v.float()).to(v.dtype)
        return _dot(out.transpose(1, 2).reshape(b, s, self.cfg.inner_dim),
                    self.o)


class Block(nn.Module):
    def __init__(self, cfg: T5EncoderConfig, *, device=None):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.gated = cfg.gated_ff
        self.ln1 = RMSNorm(d, cfg.ln_eps, device=device)
        self.attn = Attention(cfg, device=device)
        self.ln2 = RMSNorm(d, cfg.ln_eps, device=device)
        if cfg.gated_ff:
            self.wi_0, self.wi_1 = _matrix(d, f, device), _matrix(d, f, device)
        else:
            self.wi = _matrix(d, f, device)
        self.wo = _matrix(f, d, device)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), bias)
        y = self.ln2(x)
        if self.gated:
            hid = F.gelu(_dot(y, self.wi_0), approximate="tanh") \
                * _dot(y, self.wi_1)
        else:
            hid = F.relu(_dot(y, self.wi))
        return x + _dot(hid, self.wo)


class T5Encoder(nn.Module):
    def __init__(self, cfg: T5EncoderConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed = _matrix(cfg.vocab_size, cfg.d_model, device)
        self.rel_bias = _matrix(cfg.rel_buckets, cfg.num_heads, device)
        self.blocks = nn.ModuleList(Block(cfg, device=device)
                                    for _ in range(cfg.num_layers))
        self.final_ln = RMSNorm(cfg.d_model, cfg.ln_eps, device=device)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor | None = None, *,
                dtype: torch.dtype = torch.float32) -> dict:
        """[B, S] ids → {'last_hidden_state': [B, S, d_model]}."""
        b, s = input_ids.shape
        cfg = self.cfg
        if attention_mask is None:
            attention_mask = (input_ids != cfg.pad_token_id).long()
        x = self.embed[input_ids].to(dtype)
        buckets = torch.from_numpy(relative_position_buckets(
            s, s, cfg.rel_buckets, cfg.rel_max_distance)).to(x.device)
        bias = self.rel_bias[buckets].permute(2, 0, 1)[None].float()
        bias = bias + (1.0 - attention_mask[:, None, None, :].float()) * -1e9
        for blk in self.blocks:
            x = blk(x, bias)
        return {"last_hidden_state": self.final_ln(x)}

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "T5Encoder":
        """The JAX package's ``init`` statistics: q normal with std
        (d_model·d_kv)^-0.5, the other matrices std fan_in^-0.5, the
        embedding std 1, the bias table std inner_dim^-0.5, unit RMSNorm
        gains. Returns the module."""
        cfg = self.cfg
        for blk in self.blocks:
            blk.attn.q.normal_(0.0, (cfg.d_model * cfg.d_kv) ** -0.5,
                               generator=generator)
            mats = [blk.attn.k, blk.attn.v, blk.attn.o, blk.wo] + (
                [blk.wi_0, blk.wi_1] if blk.gated else [blk.wi])
            for w in mats:
                w.normal_(0.0, w.shape[0] ** -0.5, generator=generator)
        self.embed.normal_(0.0, 1.0, generator=generator)
        self.rel_bias.normal_(0.0, cfg.inner_dim ** -0.5, generator=generator)
        for m in self.modules():
            if isinstance(m, RMSNorm):
                m.weight.fill_(1.0)
        return self


def convert_hf_t5_encoder(sd: Mapping, cfg: T5EncoderConfig) -> dict:
    """``transformers.(M)T5EncoderModel`` state dict → ``T5Encoder(cfg)``'s:
    each linear's [out, in] weight transposed to the JAX layout."""
    g = lambda k: _tensor(sd[k])  # noqa: E731
    out = {"embed": g("shared.weight") if "shared.weight" in sd
           else g("encoder.embed_tokens.weight"),
           "rel_bias": g("encoder.block.0.layer.0.SelfAttention"
                         ".relative_attention_bias.weight"),
           "final_ln.weight": g("encoder.final_layer_norm.weight")}
    ff = ("wi_0", "wi_1") if cfg.gated_ff else ("wi",)
    for i in range(cfg.num_layers):
        src, dst = f"encoder.block.{i}.layer.", f"blocks.{i}."
        out[dst + "ln1.weight"] = g(src + "0.layer_norm.weight")
        out[dst + "ln2.weight"] = g(src + "1.layer_norm.weight")
        for n in ("q", "k", "v", "o"):
            out[dst + f"attn.{n}"] = g(src + f"0.SelfAttention.{n}.weight"
                                       ).t().contiguous()
        for n in ff + ("wo",):
            out[dst + n] = g(src + f"1.DenseReluDense.{n}.weight"
                             ).t().contiguous()
    return out
