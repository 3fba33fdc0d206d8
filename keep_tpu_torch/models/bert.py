"""BERT text encoder (counterpart of ``keep_tpu/models/bert.py``).

HF ``BertModel`` semantics: word + position + token-type embeddings with an
fp32 LayerNorm, post-LN blocks (attention → add & LN → GELU MLP → add & LN),
an additive fp32 key mask, and a tanh pooler over [CLS]. The q/k/v
projections are fused into one ``[3D, D]`` weight so that the attention
kernel reads the unsplit slab.

Parameter names follow the JAX pytree (``embeddings.word``,
``blocks.{i}.attn.qkv``, ``blocks.{i}.attn.out``, ``pooler``, ...). The
embedding tables stay fp32 whatever the compute dtype, as in the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from keep_tpu_torch.configs import BertConfig
from keep_tpu_torch.kernels.flash_attention import attention_qkv_slab
from keep_tpu_torch.kernels.qblock import quantized_attention_block_postln
from keep_tpu_torch.kernels.qmlp import quantized_mlp_bsd
from keep_tpu_torch.ops.nn import LayerNorm, Linear, Mlp, QLinear, mha_attention

# Additive bias on padded keys (the JAX package's constant): finite, so that
# bf16 arithmetic never meets an infinity, and large enough to zero the
# softmax weight.
MASK_VALUE = -1e9


class Embeddings(nn.Module):
    def __init__(self, cfg: BertConfig, *, device=None):
        super().__init__()
        d = cfg.hidden_size
        self.word = nn.Parameter(torch.zeros(cfg.vocab_size, d, device=device))
        self.position = nn.Parameter(
            torch.zeros(cfg.max_position_embeddings, d, device=device))
        self.token_type = nn.Parameter(
            torch.zeros(cfg.type_vocab_size, d, device=device))
        self.norm = LayerNorm(d, cfg.ln_eps, device=device)


class Attention(nn.Module):
    def __init__(self, cfg: BertConfig, *, device=None):
        super().__init__()
        d = cfg.hidden_size
        self.qkv = Linear(d, 3 * d, device=device)
        self.out = Linear(d, d, device=device)
        self.norm = LayerNorm(d, cfg.ln_eps, device=device)


class Block(nn.Module):
    def __init__(self, cfg: BertConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.attn = Attention(cfg, device=device)
        self.mlp = Mlp(cfg.hidden_size, cfg.intermediate_size, device=device)
        self.norm = LayerNorm(cfg.hidden_size, cfg.ln_eps, device=device)

    def int8_megakernel(self) -> bool:
        """Whether the block can run the int8 megakernel path: all four
        linears quantized."""
        return all(isinstance(m, QLinear) for m in (
            self.attn.qkv, self.attn.out, self.mlp.fc1, self.mlp.fc2))

    def forward(self, x: torch.Tensor, key_bias: torch.Tensor, *,
                use_flash: bool, gelu_approx: bool) -> torch.Tensor:
        b, s, d = x.shape
        h = self.cfg.num_attention_heads
        if use_flash and gelu_approx and self.int8_megakernel():
            # the post-LN attention sub-block (int8 qkv → masked MHA → int8
            # out → LN(x + ·)), then the int8 MLP pair with the exit LN; the
            # SmoothQuant pre_scales of qkv and fc1 ride into the quantize
            # steps
            eps = self.cfg.ln_eps
            x = quantized_attention_block_postln(
                x, key_bias, self.attn.norm, self.attn.qkv, self.attn.out,
                num_heads=h, eps=eps)
            m = self.mlp
            return quantized_mlp_bsd(
                x, m.fc1.weight_q, m.fc1.weight_scale, m.fc1.bias,
                m.fc2.weight_q, m.fc2.weight_scale, m.fc2.bias,
                out_dtype=x.dtype, ln_scale=self.norm.weight,
                ln_bias=self.norm.bias, eps=eps, post_ln=True,
                pre_scale1=m.fc1.pre_scale)
        qkv = self.attn.qkv(x)
        if use_flash:
            attn = attention_qkv_slab(qkv, key_bias=key_bias, num_heads=h)
        else:
            q, k, v = qkv.reshape(b, s, 3, h, d // h).permute(2, 0, 3, 1, 4)
            attn = mha_attention(q, k, v, bias=key_bias[:, None, None, :])
            attn = attn.transpose(1, 2).reshape(b, s, d)
        x = self.attn.norm(x + self.attn.out(attn))
        return self.norm(x + self.mlp(x, gelu_approx=gelu_approx))


class BertModel(nn.Module):
    def __init__(self, cfg: BertConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.embeddings = Embeddings(cfg, device=device)
        self.blocks = nn.ModuleList(
            Block(cfg, device=device) for _ in range(cfg.num_hidden_layers))
        self.pooler = Linear(cfg.hidden_size, cfg.hidden_size, device=device)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor | None = None,
                token_type_ids: torch.Tensor | None = None, *,
                dtype: torch.dtype = torch.float32, use_flash: bool = False,
                gelu_approx: bool = False, remat: bool = False) -> dict:
        """[B, S] token ids → {'last_hidden_state': [B, S, D],
        'pooler_output': [B, D]}. ``remat`` recomputes each block in the
        backward (``torch.utils.checkpoint``)."""
        b, s = input_ids.shape
        if s > self.cfg.max_position_embeddings:
            raise ValueError(
                f"sequence length {s} exceeds max_position_embeddings="
                f"{self.cfg.max_position_embeddings}; truncate at the "
                f"tokenizer")
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        emb = self.embeddings
        x = (emb.word[input_ids] + emb.position[:s][None]
             + emb.token_type[token_type_ids])
        x = emb.norm(x).to(dtype)
        key_bias = (1.0 - attention_mask.float()) * MASK_VALUE  # [B, S] fp32
        for blk in self.blocks:
            if remat:
                x = checkpoint(blk, x, key_bias, use_reentrant=False,
                               use_flash=use_flash, gelu_approx=gelu_approx)
            else:
                x = blk(x, key_bias, use_flash=use_flash,
                        gelu_approx=gelu_approx)
        return {"last_hidden_state": x,
                "pooler_output": torch.tanh(self.pooler(x[:, 0]))}
