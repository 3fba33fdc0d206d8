"""BERT text encoder (counterpart of ``keep_tpu/models/bert.py``).

HF ``BertModel`` semantics: word + position + token-type embeddings with an
fp32 LayerNorm, post-LN blocks (attention → add & LN → GELU MLP → add & LN),
an additive fp32 key mask, and a tanh pooler over [CLS]. The q/k/v
projections are fused into one ``[3D, D]`` weight so that the attention
kernel reads the unsplit slab.

Parameter names follow the JAX pytree (``embeddings.word``,
``blocks.{i}.attn.qkv``, ``blocks.{i}.attn.out``, ``pooler``, ...). The
embedding tables stay fp32 whatever the compute dtype, as in the JAX package.

Tensor and sequence parallelism (training over a process mesh): a block
split by ``parallel.tp.shard_model_`` (its ``tp``) runs its attention and
MLP pairs on this rank's heads and hidden slice; ``act_sharding``
(``parallel.sp.SeqParallel``) splits the stream along S between the
blocks, the key mask staying whole.

Calibration: ``forward(..., ln_stats=True)`` also returns the per-layer
per-channel abs-max of the qkv input (the block's input stream) and the fc1
input (the attention sub-block's exit LayerNorm), pad positions masked out
(``quant.smooth_bert``).
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
        # the tensor-parallel split of this block's pairs
        # (parallel.tp.shard_model_); None: the whole block on every rank
        self.tp = None

    def int8_megakernel(self) -> bool:
        """Whether the block can run the int8 megakernel path: all four
        linears quantized."""
        return all(isinstance(m, QLinear) for m in (
            self.attn.qkv, self.attn.out, self.mlp.fc1, self.mlp.fc2))

    def forward(self, x: torch.Tensor, key_bias: torch.Tensor, *,
                use_flash: bool, gelu_approx: bool,
                collect_ln_stats: bool = False, seq=None):
        """``collect_ln_stats`` (calibration) also returns the fp32 abs-max
        over the unpadded positions of the qkv and fc1 inputs, {"qkv": [D],
        "fc1": [D]}; it needs float linears. Under tensor parallelism
        (``self.tp``) and / or sequence parallelism (``seq``, this tower's
        ``parallel.sp.SeqShard``: ``x`` holds this rank's rows, ``key_bias``
        the whole sequence's) the pairs run split (``parallel.tp``)."""
        if self.tp is not None or seq is not None:
            from keep_tpu_torch.parallel import tp as ptp

            if collect_ln_stats or isinstance(self.attn.qkv, QLinear):
                raise ValueError("tensor / sequence parallelism is a "
                                 "training path: no int8 or calibration")
            attn = ptp.attention_pair(
                self.attn.qkv, self.attn.out, x,
                self.cfg.num_attention_heads, self.tp, seq,
                key_bias=key_bias,
                attend=attention_qkv_slab if use_flash else None)
            x = self.attn.norm(x + attn)
            return self.norm(x + ptp.mlp_pair(self.mlp, x, self.tp, seq,
                                              gelu_approx=gelu_approx))
        b, s, d = x.shape
        h = self.cfg.num_attention_heads
        if collect_ln_stats and isinstance(self.attn.qkv, QLinear):
            raise ValueError("LN-stats calibration needs unquantized params")
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
        if collect_ln_stats:
            # pad positions carry embedding noise that no output reads
            # ([CLS] pooling, masked keys): they are left out of the max
            valid = (key_bias == 0).float()[..., None]
            stat_qkv = (x.float().abs() * valid).amax(dim=(0, 1))
        qkv = self.attn.qkv(x)
        if use_flash:
            attn = attention_qkv_slab(qkv, key_bias=key_bias, num_heads=h)
        else:
            q, k, v = qkv.reshape(b, s, 3, h, d // h).permute(2, 0, 3, 1, 4)
            attn = mha_attention(q, k, v, bias=key_bias[:, None, None, :])
            attn = attn.transpose(1, 2).reshape(b, s, d)
        x = self.attn.norm(x + self.attn.out(attn))
        out = self.norm(x + self.mlp(x, gelu_approx=gelu_approx))
        if collect_ln_stats:
            return out, {"qkv": stat_qkv,
                         "fc1": (x.float().abs() * valid).amax(dim=(0, 1))}
        return out


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
                gelu_approx: bool = False, remat: bool = False,
                ln_stats: bool = False,
                position_ids: torch.Tensor | None = None,
                act_sharding=None):
        """[B, S] token ids → {'last_hidden_state': [B, S, D],
        'pooler_output': [B, D]}. ``position_ids`` [B, S] replace the
        default positions 0..S−1 (the RoBERTa-family towers derive them
        from the padding, ``models.hf_text``). ``remat`` recomputes each
        block in the backward (``torch.utils.checkpoint``).
        ``ln_stats=True`` returns ``(outputs, {"qkv": [L, D], "fc1": [L,
        D]})``, the calibration pass of ``quant.smooth_bert``.
        ``act_sharding`` (a ``parallel.sp.SeqParallel``) splits the stream
        along S over its group between the blocks (training only)."""
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
        pos = (emb.position[:s][None] if position_ids is None
               else emb.position[position_ids])
        x = emb.word[input_ids] + pos + emb.token_type[token_type_ids]
        x = emb.norm(x).to(dtype)
        key_bias = (1.0 - attention_mask.float()) * MASK_VALUE  # [B, S] fp32
        seq = None
        if act_sharding is not None:
            from keep_tpu_torch.parallel.sp import seq_shard

            seq = seq_shard(act_sharding, s)
            x = seq.enter(x)
        stats = []
        for blk in self.blocks:
            kw = dict(use_flash=use_flash, gelu_approx=gelu_approx,
                      collect_ln_stats=ln_stats)
            if seq is not None:
                kw["seq"] = seq
            if remat:
                x = checkpoint(blk, x, key_bias, use_reentrant=False, **kw)
            else:
                x = blk(x, key_bias, **kw)
            if ln_stats:
                x, st = x
                stats.append(st)
        if seq is not None:
            x = seq.leave(x)
        out = {"last_hidden_state": x,
               "pooler_output": torch.tanh(self.pooler(x[:, 0]))}
        if ln_stats:
            return out, {k: torch.stack([st[k] for st in stats])
                         for k in ("qkv", "fc1")}
        return out

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "BertModel":
        """Draws the weights in place with the JAX package's ``bert.init``
        statistics: linear weights and the embedding tables normal with std
        .02, zero biases, unit LayerNorms. Returns the module."""
        for m in self.modules():
            if isinstance(m, Linear):
                m.weight.normal_(0.0, 0.02, generator=generator)
                m.bias.zero_()
            elif isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        emb = self.embeddings
        for t in (emb.word, emb.position, emb.token_type):
            t.normal_(0.0, 0.02, generator=generator)
        return self
