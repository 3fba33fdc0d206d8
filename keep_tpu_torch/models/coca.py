"""CoCa, the contrastive captioner (counterpart of
``keep_tpu/models/coca.py``; the reference's coca_model.py and
transformer.py:634-726).

- image tower: the OpenCLIP ``VisionTransformer`` (``models.vit`` with
  ``ln_pre`` and ``pool="none"``; the fused attention #1 under
  ``use_flash``), then the attentional pooler at ``embed_dim`` (``n_queries``
  learned queries, keys and values from the trunk's width, ``ln_q`` /
  ``ln_k``), ``ln_post`` over all pooled tokens; the first pooled token
  @ ``visual_proj`` is the contrastive latent, the others the decoder's
  context. Without the pooler (``coca_base``, ``coca_roberta-ViT-B-32``)
  ``ln_post`` takes the CLS token alone and the context is the raw patch
  tokens;
- text tower: a causal transformer over the ids trimmed to S − 1 with a
  learned CLS appended at the END, positions over all slots, pads masked
  from the CLS row as ``build_cls_mask`` does (key j gated by id j − 1, key
  0 always open); ``ln_final`` only on the pooled CLS. Or, for
  ``coca_roberta``, the RoBERTa tower (``models.hf_text``, #1 with its key
  mask under ``use_flash``), whose hidden states feed the decoder;
- decoder: per layer a causal self-attention block, then a cross-attention
  block over the image context; final LayerNorm and the vocabulary
  projection;
- ``caption_loss`` / ``coca_loss``, greedy / top-k / top-p ``generate``
  and ``generate_beam``.

The text tower, the pooler and the decoder compute attention plainly
(score-level biases, or none), as the JAX package does. Parameter names
follow the JAX pytree (``text.blocks.{i}``, ``decoder.self_blocks.{i}``,
``attn_pool.q``, ...); the raw matrices (``text_projection``,
``visual_proj``, ``to_logits``, ``query``) keep the JAX layout [in, out].

``encode_image`` / ``encode_text`` return the unit latent alone (the
reference's CLIP-facing surface and the JAX ``PresetModel``'s);
``encode_image_tokens`` / ``encode_text_tokens`` return (latent, tokens),
the JAX package's ``coca.encode_image`` / ``encode_text``. Sampling draws
from a ``torch.Generator``: it cannot give the JAX PRNG's tokens.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
from torch import nn

from keep_tpu_torch.configs import ViTConfig
from keep_tpu_torch.models.vit import VisionTransformer, init_vit_weights
from keep_tpu_torch.ops.nn import (LayerNorm, Linear, Mlp, cast_linear_weights,
                                   l2_normalize, mha_attention)

MASK = -1e9  # the JAX package's additive mask value


@dataclasses.dataclass(frozen=True)
class CoCaConfig:
    embed_dim: int = 512
    vocab_size: int = 49408
    context_length: int = 76  # the text tower sees S − 1; CLS takes the last
    text_width: int = 512
    text_heads: int = 8
    text_layers: int = 12
    decoder_layers: int = 6
    decoder_heads: int = 8
    n_queries: int = 256
    attn_pooler_heads: int = 8
    mlp_ratio: float = 4.0
    ln_eps: float = 1e-5
    vision: ViTConfig = dataclasses.field(
        default_factory=lambda: ViTConfig(
            embed_dim=768, depth=12, num_heads=12, layerscale_init=None,
            ln_eps=1e-5, pool="none"))
    pad_id: int = 0
    sot_id: int = 49406
    eos_id: int = 49407
    # coca_roberta-ViT-B-32: an HF token tower (models.hf_text) whose raw
    # hidden states feed the decoder, and no attentional pooler
    hf_text: Any = None  # HFTextConfig | None
    use_attn_pool: bool = True


def _dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w (w [in, out]) in x's dtype, accumulated in fp32, returned in
    fp32 (``jnp.dot(..., preferred_element_type=float32)``)."""
    return torch.matmul(x.float(), w.to(x.dtype).float())


class CoCaAttention(nn.Module):
    """Self-attention's fused ``qkv``, or cross-attention's ``q`` and
    ``kv``, and the output ``proj``."""

    def __init__(self, width: int, cross: bool, *, device=None):
        super().__init__()
        if cross:
            self.q = Linear(width, width, device=device)
            self.kv = Linear(width, 2 * width, device=device)
        else:
            self.qkv = Linear(width, 3 * width, device=device)
        self.proj = Linear(width, width, device=device)


class AttnBlock(nn.Module):
    """Pre-LN residual attention block; a cross-attention block (keys and
    values from ``norm1_kv(kv)``) when built with ``cross``."""

    def __init__(self, width: int, mlp_ratio: float, eps: float,
                 cross: bool = False, *, device=None):
        super().__init__()
        self.norm1 = LayerNorm(width, eps, device=device)
        self.attn = CoCaAttention(width, cross, device=device)
        self.norm2 = LayerNorm(width, eps, device=device)
        self.mlp = Mlp(width, int(width * mlp_ratio), device=device)
        self.norm1_kv = LayerNorm(width, eps, device=device) if cross else None

    def forward(self, x: torch.Tensor, bias: torch.Tensor | None,
                heads: int, kv: torch.Tensor | None = None) -> torch.Tensor:
        b, s, d = x.shape
        dh = d // heads
        y = self.norm1(x)
        if kv is None:
            q, k, v = self.attn.qkv(y).reshape(b, s, 3, heads, dh).permute(
                2, 0, 3, 1, 4)
        else:
            ykv = self.norm1_kv(kv)
            q = self.attn.q(y).reshape(b, s, heads, dh).transpose(1, 2)
            k, v = self.attn.kv(ykv).reshape(b, kv.shape[1], 2, heads,
                                             dh).permute(2, 0, 3, 1, 4)
        attn = mha_attention(q, k, v, bias=bias)
        x = x + self.attn.proj(attn.transpose(1, 2).reshape(b, s, d))
        return x + self.mlp(self.norm2(x))


def _blocks(n: int, width: int, cfg: CoCaConfig, cross: bool = False,
            device=None) -> nn.ModuleList:
    return nn.ModuleList(AttnBlock(width, cfg.mlp_ratio, cfg.ln_eps, cross,
                                   device=device) for _ in range(n))


class CoCaText(nn.Module):
    """The causal CLIP-style token tower with the CLS appended at the end."""

    def __init__(self, cfg: CoCaConfig, *, device=None):
        super().__init__()
        w, e = cfg.text_width, cfg.embed_dim
        z = lambda *shape: nn.Parameter(torch.zeros(*shape, device=device))  # noqa: E731
        self.token_embedding = z(cfg.vocab_size, w)
        # positions cover the appended CLS (transformer.py:530-532)
        self.pos_embed = z(cfg.context_length + 1, w)
        self.cls_emb = z(w)
        self.blocks = _blocks(cfg.text_layers, w, cfg, device=device)
        self.ln_final = LayerNorm(w, cfg.ln_eps, device=device)
        self.text_projection = z(w, e)


class AttentionalPooler(nn.Module):
    """``n_queries`` learned queries at ``embed_dim`` over the trunk's
    tokens at its width (torch MHA with kdim ≠ embed_dim)."""

    def __init__(self, cfg: CoCaConfig, *, device=None):
        super().__init__()
        e, vw = cfg.embed_dim, cfg.vision.embed_dim
        self.query = nn.Parameter(torch.zeros(cfg.n_queries, e, device=device))
        self.ln_q = LayerNorm(e, cfg.ln_eps, device=device)
        self.ln_k = LayerNorm(vw, cfg.ln_eps, device=device)
        self.q = Linear(e, e, device=device)
        self.k = Linear(vw, e, device=device)
        self.v = Linear(vw, e, device=device)
        self.proj = Linear(e, e, device=device)


class Decoder(nn.Module):
    def __init__(self, cfg: CoCaConfig, *, device=None):
        super().__init__()
        w = cfg.text_width
        self.self_blocks = _blocks(cfg.decoder_layers, w, cfg, device=device)
        self.cross_blocks = _blocks(cfg.decoder_layers, w, cfg, cross=True,
                                    device=device)
        self.ln_final = LayerNorm(w, cfg.ln_eps, device=device)
        self.to_logits = nn.Parameter(torch.zeros(w, cfg.vocab_size,
                                                  device=device))


class CoCa(nn.Module):
    """The CoCa model. ``dtype`` is the compute dtype; the linear weights
    are stored in it, the raw matrices, embeddings, LayerNorms and biases
    in fp32 (cast on use, as in the JAX package). ``preset`` is the
    resolved preset when built from one."""

    family = "coca"

    def __init__(self, cfg: CoCaConfig, *, dtype: torch.dtype = torch.float32,
                 device=None, preset=None):
        super().__init__()
        self.cfg, self.dtype, self.preset = cfg, dtype, preset
        vw, e = cfg.vision.embed_dim, cfg.embed_dim
        # the open_clip trunk: ln_pre, and a final ``norm`` kept identity
        self.visual = VisionTransformer(cfg.vision, ln_pre=True, device=device)
        if cfg.hf_text is not None:
            from keep_tpu_torch.models.hf_text import HFText

            self.text = HFText(cfg.hf_text, device=device)
        else:
            self.text = CoCaText(cfg, device=device)
        self.decoder = Decoder(cfg, device=device)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07),
                                                     device=device))
        if cfg.use_attn_pool:
            self.attn_pool = AttentionalPooler(cfg, device=device)
            self.ln_post = LayerNorm(e, cfg.ln_eps, device=device)
            self.visual_proj = nn.Parameter(torch.zeros(e, e, device=device))
        else:
            self.attn_pool = None
            self.ln_post = LayerNorm(vw, cfg.ln_eps, device=device)
            self.visual_proj = nn.Parameter(torch.zeros(vw, e, device=device))
        cast_linear_weights(self, dtype)

    @property
    def config(self):
        return self.preset if self.preset is not None else self.cfg

    @property
    def device(self) -> torch.device:
        return self.logit_scale.device

    # -- towers ---------------------------------------------------------

    def encode_text_tokens(self, input_ids: torch.Tensor, *,
                           dtype: torch.dtype | None = None,
                           embed_cls: bool = True, use_flash: bool = False
                           ) -> tuple[torch.Tensor, torch.Tensor]:
        """[B, S] ids → (unit latent [B, E] fp32, token states [B, T, W]).

        ``embed_cls`` only sets the input trim, as the reference's
        ``_encode_text``: True drops the last id to make room for the CLS
        slot (training), False keeps them all (generation). ``use_flash``
        runs the RoBERTa tower's attention through #1 (the causal tower's
        biases are score-level: plain attention)."""
        cfg = self.cfg
        dtype = dtype or self.dtype
        ids = (input_ids[:, :-1] if embed_cls else input_ids).to(self.device)
        if cfg.hf_text is not None:
            pooled, tokens = self.text(ids, dtype=dtype, output_tokens=True,
                                       use_flash=use_flash)
            return l2_normalize(pooled.float()), tokens
        t = self.text
        b, s = ids.shape
        w = t.token_embedding.shape[-1]
        x = t.token_embedding[ids].to(dtype)
        cls = t.cls_emb.to(dtype).reshape(1, 1, w).expand(b, 1, w)
        x = torch.cat([x, cls], dim=1)  # CLS at the END
        sl = s + 1
        x = x + t.pos_embed[:sl].to(dtype)
        causal = torch.triu(torch.full((sl, sl), MASK, device=x.device),
                            diagonal=1)
        # build_cls_mask: only the CLS query's row masks pads, its columns
        # shifted by one (key j gated by ids[:, j − 1], key 0 always open)
        valid = torch.cat([torch.ones(b, 1, dtype=torch.bool,
                                      device=x.device), ids != cfg.pad_id], 1)
        rows = torch.zeros(b, sl, sl, device=x.device)
        rows[:, -1] = torch.where(valid, 0.0, MASK)
        bias = (causal[None] + rows)[:, None]  # [B, 1, sl, sl]
        for blk in t.blocks:
            x = blk(x, bias, cfg.text_heads)
        pooled = t.ln_final(x[:, -1])
        latent = _dot(pooled, t.text_projection).to(dtype)
        return l2_normalize(latent.float()), x[:, :-1]

    def encode_image_tokens(self, pixels: torch.Tensor, *,
                            dtype: torch.dtype | None = None,
                            use_flash: bool = False
                            ) -> tuple[torch.Tensor, torch.Tensor]:
        """[B, H, W, 3] normalised pixels → (unit latent [B, E] fp32, the
        decoder's context: [B, n_queries − 1, E] pooled tokens, or the raw
        patch tokens [B, N, width] without the pooler). ``use_flash`` runs
        the trunk's attention through #1."""
        cfg = self.cfg
        dtype = dtype or self.dtype
        tokens = self.visual(pixels.to(self.device), dtype=dtype,
                             use_flash=use_flash)  # pool="none"
        if self.attn_pool is None:
            # the reference pools first and ln_posts only the CLS; the
            # context is the raw patch tokens (transformer.py:494-495)
            pooled = self.ln_post(tokens[:, 0])
            latent = _dot(pooled, self.visual_proj).to(dtype)
            return l2_normalize(latent.float()), tokens[:, 1:]
        p = self.attn_pool
        b = tokens.shape[0]
        heads = cfg.attn_pooler_heads
        e = p.query.shape[-1]
        dh = e // heads
        q = p.ln_q(p.query.to(dtype)).expand(b, -1, -1)
        kv = p.ln_k(tokens)
        qh = p.q(q).reshape(b, -1, heads, dh).transpose(1, 2)
        kh = p.k(kv).reshape(b, -1, heads, dh).transpose(1, 2)
        vh = p.v(kv).reshape(b, -1, heads, dh).transpose(1, 2)
        pooled = mha_attention(qh, kh, vh).transpose(1, 2).reshape(b, -1, e)
        x = self.ln_post(p.proj(pooled))
        latent = _dot(x[:, 0], self.visual_proj).to(dtype)
        return l2_normalize(latent.float()), x[:, 1:]

    def encode_image(self, pixels: torch.Tensor, *, normalize: bool = False,
                     dtype: torch.dtype | None = None,
                     use_flash: bool = False) -> torch.Tensor:
        """The unit latent [B, E] fp32 (already normalised, as the JAX
        ``PresetModel``'s; ``normalize`` is accepted for the uniform
        surface)."""
        return self.encode_image_tokens(pixels, dtype=dtype,
                                        use_flash=use_flash)[0]

    def encode_text(self, input_ids: torch.Tensor, *, normalize: bool = False,
                    dtype: torch.dtype | None = None,
                    use_flash: bool = False) -> torch.Tensor:
        """The unit text latent [B, E] fp32 (see ``encode_image``)."""
        return self.encode_text_tokens(input_ids, dtype=dtype,
                                       use_flash=use_flash)[0]

    def decode(self, token_embs: torch.Tensor, image_embs: torch.Tensor, *,
               dtype: torch.dtype | None = None) -> torch.Tensor:
        """The multimodal decoder → fp32 vocabulary logits [B, T, V]."""
        cfg = self.cfg
        dtype = dtype or self.dtype
        d = self.decoder
        x = token_embs.to(dtype)
        kv = image_embs.to(dtype)
        t = x.shape[1]
        causal = torch.triu(torch.full((t, t), MASK, device=x.device),
                            diagonal=1)[None, None]
        for self_blk, cross_blk in zip(d.self_blocks, d.cross_blocks):
            x = self_blk(x, causal, cfg.decoder_heads)
            x = cross_blk(x, None, cfg.decoder_heads, kv=kv)
        return _dot(d.ln_final(x), d.to_logits)

    def forward(self, pixels: torch.Tensor, input_ids: torch.Tensor, *,
                dtype: torch.dtype | None = None,
                use_flash: bool = False) -> dict:
        """The training forward (coca_model.py:151-166): both latents, the
        captioning logits and their labels (the ids the decoder predicts)."""
        input_ids = input_ids.to(self.device)
        text_latent, token_embs = self.encode_text_tokens(
            input_ids, dtype=dtype, use_flash=use_flash)
        image_latent, image_embs = self.encode_image_tokens(
            pixels, dtype=dtype, use_flash=use_flash)
        logits = self.decode(token_embs, image_embs, dtype=dtype)
        return {"image_features": image_latent, "text_features": text_latent,
                "logits": logits, "labels": input_ids[:, -logits.shape[1]:],
                "logit_scale": self.logit_scale.exp()}

    # -- init -----------------------------------------------------------

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "CoCa":
        """Draws the weights in place with the JAX ``coca.init``
        statistics: the ViT's init (``ln_pre`` unit), linear weights normal
        with std fan_in^-0.5 and zero biases, unit LayerNorms, token
        embedding std .02, positions and CLS std .01, the projections and
        queries std fan_in^-0.5, the RoBERTa tower's own init,
        ``logit_scale = log(1 / 0.07)``."""
        init_vit_weights(self.visual, generator)
        for name, m in self.named_modules():
            if name.startswith(("visual.", "text.trunk", "text.proj")):
                continue
            if isinstance(m, Linear):
                m.weight.normal_(0.0, m.weight.shape[1] ** -0.5,
                                 generator=generator)
                m.bias.zero_()
            elif isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        if self.cfg.hf_text is not None:
            self.text.init_weights(generator)
        else:
            t = self.text
            t.token_embedding.normal_(0.0, 0.02, generator=generator)
            t.pos_embed.normal_(0.0, 0.01, generator=generator)
            t.cls_emb.normal_(0.0, 0.01, generator=generator)
            t.text_projection.normal_(0.0, t.text_projection.shape[0] ** -0.5,
                                      generator=generator)
        for w in (self.decoder.to_logits, self.visual_proj):
            w.normal_(0.0, w.shape[0] ** -0.5, generator=generator)
        if self.attn_pool is not None:
            query = self.attn_pool.query
            query.normal_(0.0, query.shape[1] ** -0.5, generator=generator)
        self.logit_scale.fill_(math.log(1 / 0.07))
        return self

    @classmethod
    def init(cls, cfg: CoCaConfig, generator: torch.Generator, *,
             dtype: torch.dtype = torch.float32, device=None) -> "CoCa":
        """A model with weights drawn from ``generator`` (``init_weights``),
        the linear weights stored in ``dtype``."""
        model = cls(cfg, device=device)
        model.init_weights(generator)
        cast_linear_weights(model, dtype)
        model.dtype = dtype
        return model


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------


def caption_loss(logits: torch.Tensor, labels: torch.Tensor,
                 pad_id: int = 0) -> torch.Tensor:
    """Next-token cross-entropy over the non-pad positions."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels[..., None].long())[..., 0]
    mask = (labels != pad_id).float()
    return -(ll * mask).sum() / mask.sum().clamp_min(1.0)


def coca_loss(out: dict, *, caption_weight: float = 2.0,
              contrastive_weight: float = 1.0,
              pad_id: int = 0) -> torch.Tensor:
    """The CoCa objective over ``forward``'s output: the local-batch
    contrastive loss plus the weighted captioning loss."""
    from keep_tpu_torch.train.loss import clip_loss

    contrastive = clip_loss(out["image_features"], out["text_features"],
                            out["logit_scale"])
    caption = caption_loss(out["logits"], out["labels"], pad_id=pad_id)
    return contrastive_weight * contrastive + caption_weight * caption


# --------------------------------------------------------------------------
# generation (a host loop over one next-token step)
# --------------------------------------------------------------------------


def _make_stepper(model: CoCa, image_embs: torch.Tensor, dtype):
    """The next-token step: ids [B, T] (numpy) → fp32 logits [B, V]
    (numpy). The causal CLIP tower right-pads the context-length window of
    the ids to a fixed width and reads the logits at ``cur_len − 1`` (the
    causal mask keeps right pads invisible to earlier positions), as the
    JAX package's one compiled step does; the RoBERTa tower is
    bidirectional, so it takes the window as it is (coca_model.py:257)."""
    cfg = model.cfg
    w = cfg.context_length

    @torch.no_grad()
    def run(ids_np: np.ndarray) -> np.ndarray:
        window = ids_np[:, -w:]
        cur = window.shape[1]
        if cfg.hf_text is None:
            pad = np.full((ids_np.shape[0], w - cur), cfg.pad_id, np.int64)
            window = np.concatenate([window, pad], 1)
        ids = torch.from_numpy(window.astype(np.int64)).to(model.device)
        _, tok = model.encode_text_tokens(ids, dtype=dtype, embed_cls=False)
        logits = model.decode(tok, image_embs, dtype=dtype)
        at = cur - 1 if cfg.hf_text is None else -1
        return logits[:, at].cpu().numpy()

    return run


def _categorical(masked: np.ndarray, generator: torch.Generator) -> np.ndarray:
    """One draw per row from softmax(masked) (``jax.random.categorical``'s
    distribution, from a ``torch.Generator`` on the host)."""
    probs = torch.softmax(torch.from_numpy(masked).double(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].numpy()


def generate(model: CoCa, pixels: torch.Tensor, seq_len: int = 30,
             generation_type: str = "greedy", top_k: int = 1,
             top_p: float = 0.1, temperature: float = 1.0,
             min_seq_len: int = 0, repetition_penalty: float = 1.0,
             generator: torch.Generator | None = None,
             dtype: torch.dtype | None = None,
             use_flash: bool = False) -> np.ndarray:
    """Captions [B, ≤ seq_len] (numpy int): from SOT, the next token by
    greedy argmax, top-k or nucleus (top-p, HF ``TopPLogitsWarper``
    semantics) sampling, until EOS; EOS suppressed below ``min_seq_len``;
    ``repetition_penalty`` divides the positive logits of tokens already
    generated and multiplies the negative ones (CTRL). Draws come from
    ``generator`` (default: a CPU generator seeded 0). ``use_flash`` runs
    the image trunk through #1."""
    cfg = model.cfg
    b = pixels.shape[0]
    with torch.no_grad():
        _, image_embs = model.encode_image_tokens(pixels, dtype=dtype,
                                                  use_flash=use_flash)
    step_logits = _make_stepper(model, image_embs, dtype)
    ids = np.full((b, 1), cfg.sot_id, np.int64)
    finished = np.zeros(b, bool)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    for _ in range(seq_len - 1):
        logits = step_logits(ids) / max(temperature, 1e-6)
        if repetition_penalty != 1.0:
            for bi in range(b):
                seen = np.unique(ids[bi])
                pos = logits[bi, seen] > 0
                logits[bi, seen] = np.where(
                    pos, logits[bi, seen] / repetition_penalty,
                    logits[bi, seen] * repetition_penalty)
        if ids.shape[1] < min_seq_len:
            logits[:, cfg.eos_id] = MASK
        if generation_type == "top_p":
            nxt = _categorical(np.where(top_p_drop(logits, top_p), MASK,
                                        logits), generator)
        elif generation_type == "greedy" or top_k <= 1:
            nxt = logits.argmax(-1)
        else:
            kth = np.sort(logits, axis=-1)[:, -top_k][:, None]
            nxt = _categorical(np.where(logits < kth, MASK, logits),
                               generator)
        nxt = np.where(finished, cfg.pad_id, nxt)
        ids = np.concatenate([ids, nxt[:, None].astype(np.int64)], axis=1)
        finished |= nxt == cfg.eos_id
        if finished.all():
            break
    return ids


def top_p_drop(logits: np.ndarray, top_p: float) -> np.ndarray:
    """The tokens nucleus sampling drops, per row: HF ``TopPLogitsWarper``
    semantics (what the reference runs, coca_model.py:31,232): token i is
    dropped iff the probability mass before it in descending order
    already exceeds ``top_p``; the argmax is always kept."""
    order = np.argsort(-logits, axis=-1)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    sorted_p = np.take_along_axis(probs, order, axis=-1)
    cum = np.cumsum(sorted_p, axis=-1)
    drop_sorted = (cum - sorted_p) > top_p
    drop_sorted[:, 0] = False
    drop = np.zeros_like(drop_sorted)
    np.put_along_axis(drop, order, drop_sorted, axis=-1)
    return drop


def generate_beam(model: CoCa, pixels: torch.Tensor, seq_len: int = 30,
                  num_beams: int = 6, min_seq_len: int = 0,
                  dtype: torch.dtype | None = None,
                  use_flash: bool = False) -> np.ndarray:
    """Beam-search captions [B, T]: length-normalised log-prob beams, EOS
    freezes a beam, EOS suppressed below ``min_seq_len``. Single-group beam
    search, as in the JAX package (the reference runs HF's grouped diverse
    beam search)."""
    cfg = model.cfg
    b = pixels.shape[0]
    with torch.no_grad():
        _, image_embs = model.encode_image_tokens(pixels, dtype=dtype,
                                                  use_flash=use_flash)
    stepper = _make_stepper(model, image_embs.repeat_interleave(num_beams, 0),
                            dtype)
    k, v = num_beams, cfg.vocab_size
    ids = np.full((b, k, 1), cfg.sot_id, np.int64)
    scores = np.full((b, k), MASK, np.float64)
    scores[:, 0] = 0.0  # all beams start identical; keep one live
    finished = np.zeros((b, k), bool)
    for _ in range(seq_len - 1):
        raw = stepper(ids.reshape(b * k, -1)).astype(np.float32)
        logp = torch.log_softmax(torch.from_numpy(raw), -1).numpy()
        logp = logp.reshape(b, k, v)
        if ids.shape[2] < min_seq_len:
            logp[:, :, cfg.eos_id] = MASK
        pad_only = np.full((b, k, v), MASK)
        pad_only[:, :, cfg.pad_id] = 0.0
        logp = np.where(finished[:, :, None], pad_only, logp)
        flat = (scores[:, :, None] + logp).reshape(b, k * v)
        top = np.argsort(-flat, axis=1)[:, :k]
        beam_idx, tok = top // v, top % v
        scores = np.take_along_axis(flat, top, axis=1)
        ids = np.concatenate(
            [np.take_along_axis(ids, beam_idx[:, :, None], axis=1),
             tok[:, :, None].astype(np.int64)], axis=2)
        finished = (np.take_along_axis(finished, beam_idx, axis=1)
                    | (tok == cfg.eos_id))
        if finished.all():
            break
    lengths = (ids != cfg.pad_id).sum(axis=2)
    best = (scores / np.maximum(lengths, 1)).argmax(axis=1)
    return ids[np.arange(b), best]
