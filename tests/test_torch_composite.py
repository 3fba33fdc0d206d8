"""``keep_tpu_torch.compat.composite`` (CoCa, PMC-CLIP, KEP full-model
converters) against the JAX package's: one synthetic state dict in the
reference's layout, drawn from a seed by the key and shape generators
below, goes through ``keep_tpu.compat.composite.load_*_checkpoint`` +
``compat.torch_loader.from_jax_*_params`` and through the port's
``load_*_checkpoint``. The state dicts are equal bit for bit, the inferred
configs are equal, and the port's state dict loads strictly into its
model."""

import dataclasses

import numpy as np
import pytest
import torch

from keep_tpu.compat import composite as jcomp
from keep_tpu_torch.compat import composite
from keep_tpu_torch.compat.torch_loader import (from_jax_coca_params,
                                                from_jax_kep_params,
                                                from_jax_pmc_params,
                                                released_keep_shapes)
from keep_tpu_torch.configs import BertConfig, KEEPConfig, ViTConfig


def _resblock(shapes: dict, prefix: str, d: int, cross: bool = False):
    for ln in ("ln_1", "ln_2") + (("ln_1_kv",) if cross else ()):
        shapes[f"{prefix}.{ln}.weight"] = shapes[f"{prefix}.{ln}.bias"] = (d,)
    shapes[f"{prefix}.attn.in_proj_weight"] = (3 * d, d)
    shapes[f"{prefix}.attn.in_proj_bias"] = (3 * d,)
    shapes[f"{prefix}.attn.out_proj.weight"] = (d, d)
    shapes[f"{prefix}.attn.out_proj.bias"] = (d,)
    shapes[f"{prefix}.mlp.c_fc.weight"] = (4 * d, d)
    shapes[f"{prefix}.mlp.c_fc.bias"] = (4 * d,)
    shapes[f"{prefix}.mlp.c_proj.weight"] = (d, 4 * d)
    shapes[f"{prefix}.mlp.c_proj.bias"] = (d,)


def coca_shapes(vw=64, patch=8, grid=2, vlayers=2, e=32, nq=6, w=64,
                tlayers=1, dlayers=2, vocab=50, ctx=7) -> dict:
    """The keys and shapes of a reference CoCa (attn-pool layout)."""
    s = {"visual.conv1.weight": (vw, 3, patch, patch),
         "visual.class_embedding": (vw,),
         "visual.positional_embedding": (grid * grid + 1, vw),
         "visual.ln_pre.weight": (vw,), "visual.ln_pre.bias": (vw,),
         "visual.attn_pool.query": (nq, e),
         "visual.attn_pool.ln_q.weight": (e,),
         "visual.attn_pool.ln_q.bias": (e,),
         "visual.attn_pool.ln_k.weight": (vw,),
         "visual.attn_pool.ln_k.bias": (vw,),
         "visual.attn_pool.attn.q_proj_weight": (e, e),
         "visual.attn_pool.attn.k_proj_weight": (e, vw),
         "visual.attn_pool.attn.v_proj_weight": (e, vw),
         "visual.attn_pool.attn.in_proj_bias": (3 * e,),
         "visual.attn_pool.attn.out_proj.weight": (e, e),
         "visual.attn_pool.attn.out_proj.bias": (e,),
         "visual.ln_post.weight": (e,), "visual.ln_post.bias": (e,),
         "visual.proj": (e, e),
         "text.token_embedding.weight": (vocab, w),
         "text.positional_embedding": (ctx + 1, w),
         "text.cls_emb": (w,),
         "text.ln_final.weight": (w,), "text.ln_final.bias": (w,),
         "text.text_projection": (w, e),
         "text_decoder.ln_final.weight": (w,),
         "text_decoder.ln_final.bias": (w,),
         "text_decoder.text_projection": (w, vocab),
         "logit_scale": ()}
    for i in range(vlayers):
        _resblock(s, f"visual.transformer.resblocks.{i}", vw)
    for i in range(tlayers):
        _resblock(s, f"text.transformer.resblocks.{i}", w)
    for i in range(dlayers):
        _resblock(s, f"text_decoder.resblocks.{i}", w)
        _resblock(s, f"text_decoder.cross_attn.{i}", w, cross=True)
    return s


def _bert_shapes(prefix: str, cfg: BertConfig) -> dict:
    """An HF BertModel's keys under ``prefix`` (released_keep_shapes')."""
    keep = KEEPConfig(vision=ViTConfig(img_size=16, patch_size=16,
                                       embed_dim=16, depth=0, num_heads=1),
                      text=cfg, projection_dim=16)
    return {prefix + k[len("text."):]: v
            for k, v in released_keep_shapes(keep).items()
            if k.startswith("text.")}


def _rn_shapes(width=16, layers=(1, 1, 1, 1), e=32, grid=7) -> dict:
    """A reference ModifiedResNet's keys (the OpenAI layout)."""
    s = {}

    def bn(p, c):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            s[f"{p}.{leaf}"] = (c,)

    stem = width // 2
    for i, (cout, cin) in enumerate(((stem, 3), (stem, stem), (width, stem)),
                                    start=1):
        s[f"visual.conv{i}.weight"] = (cout, cin, 3, 3)
        bn(f"visual.bn{i}", cout)
    inplanes = width
    for li, n in enumerate(layers, start=1):
        planes = width * 2 ** (li - 1)
        for bi in range(n):
            p = f"visual.layer{li}.{bi}"
            s[f"{p}.conv1.weight"] = (planes, inplanes, 1, 1)
            bn(f"{p}.bn1", planes)
            s[f"{p}.conv2.weight"] = (planes, planes, 3, 3)
            bn(f"{p}.bn2", planes)
            s[f"{p}.conv3.weight"] = (planes * 4, planes, 1, 1)
            bn(f"{p}.bn3", planes * 4)
            if bi == 0:
                s[f"{p}.downsample.0.weight"] = (planes * 4, inplanes, 1, 1)
                bn(f"{p}.downsample.1", planes * 4)
            inplanes = planes * 4
    d = width * 32
    s["visual.attnpool.positional_embedding"] = (grid * grid + 1, d)
    for n in "qkv":
        s[f"visual.attnpool.{n}_proj.weight"] = (d, d)
        s[f"visual.attnpool.{n}_proj.bias"] = (d,)
    s["visual.attnpool.c_proj.weight"] = (e, d)
    s["visual.attnpool.c_proj.bias"] = (e,)
    return s


PMC_TEXT = BertConfig(vocab_size=40, hidden_size=32, num_hidden_layers=2,
                      num_attention_heads=1, intermediate_size=48,
                      max_position_embeddings=16)


def pmc_shapes(e=32, fusion=2, mlm=True) -> dict:
    """The keys and shapes of a reference PMC_CLIP."""
    s = _rn_shapes(e=e)
    s.update(_bert_shapes("text_encoder.", PMC_TEXT))
    w = PMC_TEXT.hidden_size
    s.update({"text_projection": (w, e), "img_special_token": (1, 1, w),
              "logit_scale": ()})
    for i in range(fusion):
        _resblock(s, f"fusion_module.resblocks.{i}", w)
    if mlm:
        s["mlm_projection"] = (w, PMC_TEXT.vocab_size)
    return s


KEP_VISION = ViTConfig(img_size=32, patch_size=16, embed_dim=32, depth=2,
                       num_heads=1, layerscale_init=1e-5)
KEP_TEXT = BertConfig(vocab_size=40, hidden_size=32, num_hidden_layers=2,
                      num_attention_heads=1, intermediate_size=48,
                      max_position_embeddings=16)


def kep_shapes(e=16, heads=True, knowledge=True) -> dict:
    """The keys and shapes of a reference KEP training checkpoint."""
    keep = KEEPConfig(vision=KEP_VISION, text=KEP_TEXT, projection_dim=e)
    s = {k: v for k, v in released_keep_shapes(keep).items()
         if k.startswith("visual.") and not k.startswith("visual_head")}
    s["logit_scale"] = ()
    towers = ("text", "knowledge") if knowledge else ("text",)
    for t in towers:
        s.update(_bert_shapes(f"{t}.bert_model.", KEP_TEXT))
        s[f"{t}.mlp_embed.0.weight"] = (e, KEP_TEXT.hidden_size)
        s[f"{t}.mlp_embed.0.bias"] = (e,)
        s[f"{t}.mlp_embed.2.weight"] = (e, e)
        s[f"{t}.mlp_embed.2.bias"] = (e,)
    if heads:
        for h, d in (("visual_head", KEP_VISION.embed_dim), ("text_head", e)):
            s[f"{h}.0.weight"] = (e, d)
            s[f"{h}.0.bias"] = (e,)
            s[f"{h}.2.weight"] = (e, e)
            s[f"{h}.2.bias"] = (e,)
    return s


def draw(shapes: dict, seed: int = 0) -> dict:
    """fp32 values for every key, from a numpy seed; BatchNorm variances
    positive."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, shape in shapes.items():
        v = rng.standard_normal(shape).astype(np.float32)
        if k.endswith("running_var"):
            v = np.abs(v) + 0.5
        out[k] = torch.from_numpy(v)
    return out


def _same(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32, k
        assert torch.equal(got[k].reshape(want[k].shape), want[k]), k
        assert tuple(got[k].shape) == tuple(want[k].shape), k


FAMILIES = {
    "coca": (coca_shapes, jcomp.load_coca_checkpoint,
             composite.load_coca_checkpoint, from_jax_coca_params),
    "pmc_clip": (pmc_shapes, jcomp.load_pmc_clip_checkpoint,
                 composite.load_pmc_clip_checkpoint, from_jax_pmc_params),
    "kep": (kep_shapes, jcomp.load_kep_checkpoint,
            composite.load_kep_checkpoint, from_jax_kep_params),
}


def _model(family: str, cfg):
    from keep_tpu_torch.models.coca import CoCa
    from keep_tpu_torch.models.kep import KEPModel
    from keep_tpu_torch.models.pmc_clip import PMCCLIP

    cls = {"coca": CoCa, "pmc_clip": PMCCLIP, "kep": KEPModel}[family]
    return cls.init(cfg, torch.Generator().manual_seed(0), device="cpu")


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_matches_jax_bit_for_bit(family):
    """The port's converted state dict equals the JAX package's converted
    pytree carried across by ``from_jax_*_params``, bit for bit, and the
    inferred configs are equal; it loads strictly into the port's model."""
    shapes, jload, load, from_jax = FAMILIES[family]
    sd = draw(shapes())
    jparams, jcfg = jload({k: v.clone() for k, v in sd.items()})
    got, cfg = load(sd)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    want = from_jax(jax_to_numpy(jparams), cfg)
    _same(got, want)
    model = _model(family, cfg)
    model.load_state_dict(got, strict=True)


def jax_to_numpy(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_checkpoint_quirks(family, tmp_path):
    """DDP ``module.`` prefixes, a ``{'state_dict': ...}`` training wrapper,
    ``position_ids`` buffers and a file path give the same state dict."""
    shapes, _, load, _ = FAMILIES[family]
    sd = draw(shapes(), seed=1)
    ref, _ = load(sd)
    wrapped = {"epoch": 3, "state_dict": {
        **{f"module.{k}": v for k, v in sd.items()},
        "module.text.position_ids": torch.arange(4)}}
    path = tmp_path / "ckpt.pt"
    torch.save(wrapped, path)
    for src in (wrapped, str(path)):
        got, _ = load(src)
        _same(got, ref)


def test_coca_fused_pooler_projection():
    """A pooler whose kdim equals its width stores one fused
    ``in_proj_weight``: it splits into the same q, k, v as the separate
    projections."""
    sd = draw(coca_shapes(vw=32, e=32))
    sep, cfg = composite.load_coca_checkpoint(sd)
    ap = "visual.attn_pool.attn."
    fused = {k: v for k, v in sd.items()
             if k not in {ap + f"{n}_proj_weight" for n in "qkv"}}
    fused[ap + "in_proj_weight"] = torch.cat(
        [sd[ap + f"{n}_proj_weight"] for n in "qkv"])
    got, _ = composite.load_coca_checkpoint(fused, cfg)
    _same(got, sep)
    jgot, _ = jcomp.load_coca_checkpoint(fused, cfg=None)
    _same(from_jax_coca_params(jax_to_numpy(jgot), cfg), got)


def test_coca_without_attentional_pooler_raises():
    sd = draw(coca_shapes())
    del sd["visual.attn_pool.query"]
    with pytest.raises(ValueError, match="attentional pooler"):
        composite.load_coca_checkpoint(sd)
