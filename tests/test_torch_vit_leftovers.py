"""The ViT's leftovers in the port against the JAX package on the same
weights and inputs (CPU, tiny widths): image sizes other than the native
one through ``resample_pos_embed``, patch dropout from the same noise, the
gap ViT (no CLS token, average pooling, ``fc_norm``), the OpenAI-CLIP
``ln_pre``, ``pool="none"``, QuickGELU and ``cosine_attention``. Weights
are carried by ``compat.torch_loader.from_jax_clip_params``. fp32 at
2e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keep_tpu import configs as jcfgs
from keep_tpu.models import keep as jkeep
from keep_tpu.models import vit as jvit
from keep_tpu.ops import nn as jnn
from keep_tpu_torch import configs
from keep_tpu_torch.compat.torch_loader import (from_jax_clip_params,
                                                from_jax_params)
from keep_tpu_torch.models import vit
from keep_tpu_torch.models.keep import KEEPModel
from keep_tpu_torch.ops import nn

TOL = dict(atol=2e-5, rtol=2e-5)
SMALL = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4,
             mlp_ratio=2.0)
GAP = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4,
           layerscale_init=None, ln_eps=1e-6, num_prefix_tokens=0,
           pool="avg", fc_norm=True)


def _moving(params):
    """Non-trivial LayerScale and LayerNorms, so that every piece moves the
    result."""
    rng = np.random.default_rng(1)
    params = jax.tree.map(np.asarray, params)
    b = params["blocks"]
    if "ls1" in b:
        b["ls1"] = b["ls1"] + 0.3
        b["ls2"] = b["ls2"] + 0.2
    for node in (params["norm"], params.get("ln_pre")):
        if node is not None:
            node["scale"] = node["scale"] + 0.2 * rng.standard_normal(
                node["scale"].shape).astype(np.float32)
            node["bias"] = node["bias"] + 0.1 * rng.standard_normal(
                node["bias"].shape).astype(np.float32)
    return params


def _pair(fields, ln_pre=False, seed=0):
    """(JAX params, JAX config, the port's ViT on the same weights)."""
    jc = jcfgs.ViTConfig(**fields)
    params = jvit.init(jax.random.PRNGKey(seed), jc)
    if ln_pre:
        params["ln_pre"] = {"scale": jnp.ones(jc.embed_dim),
                            "bias": jnp.zeros(jc.embed_dim)}
    params = _moving(params)
    m = vit.VisionTransformer(configs.ViTConfig(**fields), ln_pre=ln_pre)
    sd = from_jax_clip_params({"visual": params}, jc.depth, 0)
    m.load_state_dict({k.removeprefix("visual."): v for k, v in sd.items()},
                      strict=True)
    return params, jc, m.eval()


def _run(m, x, **kw):
    with torch.no_grad():
        return m(torch.from_numpy(x), **kw).numpy()


@pytest.mark.parametrize("hw", [(48, 64), (32, 32), (24, 40)])
def test_dynamic_image_size(rng, hw):
    """Any multiple of the patch size runs, with the pos embed resampled to
    its grid (twin of tests/test_vit_parity.py::test_dynamic_image_size),
    equal to the JAX forward; the port's kernel route (the plain version on
    the CPU) too."""
    params, jc, m = _pair(SMALL)
    x = rng.standard_normal((2, *hw, 3), dtype=np.float32)
    ref = np.asarray(jvit.forward(params, jnp.asarray(x), jc))
    got = _run(m, x)
    assert got.shape == (2, jc.embed_dim) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(_run(m, x, use_flash=True), ref, **TOL)


def test_resample_pos_embed_matches_torch(rng):
    """resample_pos_embed is F.interpolate(mode='bicubic', antialias=True,
    align_corners=False), up- and downscale (twin of
    tests/test_vit_parity.py::test_resample_pos_embed_matches_torch), and
    the JAX package's resample; the prefix is kept and the native grid
    returned as it is."""
    import torch.nn.functional as F

    d = 6
    for old, (gh, gw) in [(14, (32, 32)), (16, (7, 9)), (8, (11, 5))]:
        pe = rng.standard_normal((1, 1 + old * old, d)).astype(np.float32)
        got = vit.resample_pos_embed(torch.from_numpy(pe), (gh, gw), 1)
        got = got.numpy()
        grid = torch.from_numpy(
            pe[0, 1:].reshape(1, old, old, d)).permute(0, 3, 1, 2)
        ref = F.interpolate(grid, size=(gh, gw), mode="bicubic",
                            antialias=True, align_corners=False)
        ref = ref.permute(0, 2, 3, 1).reshape(1, gh * gw, d).numpy()
        np.testing.assert_allclose(got[:, 1:], ref, atol=2e-5, rtol=1e-4)
        np.testing.assert_array_equal(got[:, :1], pe[:, :1])
        jax_ref = np.asarray(jvit.resample_pos_embed(jnp.asarray(pe),
                                                     (gh, gw), 1))
        np.testing.assert_allclose(got, jax_ref, **TOL)
    same = torch.from_numpy(pe)
    assert vit.resample_pos_embed(same, (old, old), 1) is same


@pytest.mark.parametrize("keep_rate,prefix", [(0.5, 1), (0.25, 0),
                                              (0.01, 1), (1.0, 1)])
def test_patch_dropout_from_the_same_noise(rng, keep_rate, prefix):
    """The gather from given noise equals the JAX package's patch_dropout
    drawn from its key: the same tokens, in the same order."""
    b, n, d = 3, 16, 8
    tokens = rng.standard_normal((b, prefix + n, d)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    noise = np.array(jax.random.uniform(key, (b, n)))
    ref = np.asarray(jvit.patch_dropout(jnp.asarray(tokens), key, keep_rate,
                                       prefix))
    got = vit.patch_dropout(torch.from_numpy(tokens), torch.from_numpy(noise),
                            keep_rate, prefix).numpy()
    np.testing.assert_array_equal(got, ref)


def test_patch_dropout_in_the_forward(rng):
    """With a generator the forward keeps prefix + floor(keep·N) tokens;
    without one (eval mode) it keeps them all; the noise comes from the
    generator alone."""
    fields = dict(SMALL, pool="none", layerscale_init=None)
    _, jc, m = _pair(fields)
    x = torch.from_numpy(rng.standard_normal((2, 32, 32, 3),
                                             dtype=np.float32))
    with torch.no_grad():
        full = m(x, patch_dropout_rate=0.5)
        a = m(x, patch_dropout_rate=0.5,
              dropout_generator=torch.Generator().manual_seed(3))
        b = m(x, patch_dropout_rate=0.5,
              dropout_generator=torch.Generator().manual_seed(3))
    assert full.shape == (2, 1 + jc.num_patches, jc.embed_dim)
    assert a.shape == (2, 1 + jc.num_patches // 2, jc.embed_dim)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_gap_vit_avg_pool_and_fc_norm(rng):
    """No CLS token, the mean of the patch tokens, then the final LayerNorm
    (timm's gap ViT, vit_medium_patch16_gap_256's trunk), at the native
    size and resampled."""
    params, jc, m = _pair(GAP)
    assert m.cls_token is None and "cls_token" not in params
    for hw in ((32, 32), (48, 40)):
        x = rng.standard_normal((2, *hw, 3), dtype=np.float32)
        ref = np.asarray(jvit.forward(params, jnp.asarray(x), jc))
        np.testing.assert_allclose(_run(m, x), ref, **TOL)


@pytest.mark.parametrize("pool,fc_norm", [("none", False), ("token", True),
                                          ("avg", False)])
def test_pool_variants(rng, pool, fc_norm):
    params, jc, m = _pair(dict(SMALL, pool=pool, fc_norm=fc_norm))
    x = rng.standard_normal((2, 32, 40, 3), dtype=np.float32)
    ref = np.asarray(jvit.forward(params, jnp.asarray(x), jc))
    got = _run(m, x)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **TOL)


def test_ln_pre(rng):
    """The OpenAI-CLIP LayerNorm after the pos embed moves the output and
    matches the JAX package's ``ln_pre`` leaf."""
    fields = dict(SMALL, layerscale_init=None, ln_eps=1e-5)
    params, jc, m = _pair(fields, ln_pre=True)
    x = rng.standard_normal((2, 32, 32, 3), dtype=np.float32)
    ref = np.asarray(jvit.forward(params, jnp.asarray(x), jc))
    np.testing.assert_allclose(_run(m, x), ref, **TOL)
    without = dict(params)
    del without["ln_pre"]
    assert np.abs(np.asarray(jvit.forward(without, jnp.asarray(x), jc))
                  - ref).max() > 1e-3


def test_quick_gelu_blocks(rng):
    """quick_gelu equals the JAX op, and ``act="quick_gelu"`` blocks equal
    the JAX ViT's (and differ from GELU blocks); an unknown act raises."""
    x = rng.standard_normal((4, 33)).astype(np.float32) * 3
    np.testing.assert_allclose(nn.quick_gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jnn.quick_gelu(jnp.asarray(x))),
                               atol=1e-6, rtol=1e-6)
    params, jc, m = _pair(dict(SMALL, act="quick_gelu"))
    px = rng.standard_normal((2, 32, 32, 3), dtype=np.float32)
    ref = np.asarray(jvit.forward(params, jnp.asarray(px), jc))
    np.testing.assert_allclose(_run(m, px), ref, **TOL)
    gelu_ref = np.asarray(jvit.forward(
        params, jnp.asarray(px), dataclasses.replace(jc, act="gelu")))
    assert np.abs(gelu_ref - ref).max() > 1e-4
    with pytest.raises(ValueError, match="unknown mlp act"):
        nn.Mlp(8, 16, act="relu")


@pytest.mark.parametrize("masked,head_scale,clamp", [
    (False, False, False), (True, True, False), (True, False, True)])
def test_cosine_attention_matches_jax(rng, masked, head_scale, clamp):
    b, h, s, dh = 2, 3, 9, 8
    q, k, v = (rng.standard_normal((b, h, s, dh)).astype(np.float32)
               for _ in range(3))
    ls = np.log(10.0) + 0.3 * rng.standard_normal(h).astype(np.float32)
    if clamp:
        ls[0] = 6.0  # above logit_scale_max: clamped
    bias = (np.triu(np.full((s, s), -1e9, np.float32), 1)[None, None]
            if masked else None)
    hs = (1 + 0.2 * rng.standard_normal(h)).astype(np.float32) \
        if head_scale else None
    ref = np.asarray(jnn.cosine_attention(
        *(jnp.asarray(t) for t in (q, k, v)), jnp.asarray(ls),
        bias=None if bias is None else jnp.asarray(bias),
        head_scale=None if hs is None else jnp.asarray(hs)))
    got = nn.cosine_attention(
        *(torch.from_numpy(t) for t in (q, k, v)), torch.from_numpy(ls),
        bias=None if bias is None else torch.from_numpy(bias),
        head_scale=None if hs is None else torch.from_numpy(hs)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_keep_tower_at_larger_images(rng):
    """The KEEP model's image tower at 1.5× and 1.75× its native size (the
    published ViT-L/16's 384² and 448² from 224²), the pos embed resampled,
    equal to the JAX KEEP encode_image on the same weights."""
    vision = dict(img_size=32, patch_size=8, embed_dim=64, depth=2,
                  num_heads=4)
    text = dict(vocab_size=64, hidden_size=32, num_hidden_layers=1,
                num_attention_heads=2, intermediate_size=64,
                max_position_embeddings=32)
    jc = jcfgs.KEEPConfig(vision=jcfgs.ViTConfig(**vision),
                          text=jcfgs.BertConfig(**text), projection_dim=32)
    cfg = configs.KEEPConfig(vision=configs.ViTConfig(**vision),
                             text=configs.BertConfig(**text),
                             projection_dim=32)
    params = jkeep.init(jax.random.PRNGKey(0), jc)
    blocks = dict(params["visual"]["blocks"])
    blocks["ls1"] = blocks["ls1"] + 0.3
    params["visual"] = dict(params["visual"], blocks=blocks)
    m = KEEPModel(cfg)
    m.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params), cfg))
    for size in (48, 56):
        x = rng.standard_normal((2, size, size, 3), dtype=np.float32)
        ref = np.asarray(jkeep.encode_image(params, jnp.asarray(x), jc))
        with torch.no_grad():
            got = m.encode_image(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, ref, **TOL)


def test_refusals():
    """``act_sharding`` is the port's own argument since sequence
    parallelism was ported (``parallel.sp.SeqParallel``): anything else
    raises TypeError naming it; the dense trunk refuses an MoE config
    (``models.moe.MoEVisionTransformer`` builds it); a size off the patch
    grid and register tokens raise as in JAX."""
    m = vit.VisionTransformer(configs.ViTConfig(**SMALL))
    x = torch.zeros(1, 32, 32, 3)
    with pytest.raises(TypeError, match="SeqParallel"):
        m(x, act_sharding=object())
    with pytest.raises(ValueError, match="multiple of patch_size"):
        m(torch.zeros(1, 30, 32, 3))
    # the MoE trunk is its own class: the dense
    # class refuses to stand in for it
    with pytest.raises(ValueError, match="MoEVisionTransformer"):
        vit.VisionTransformer(configs.ViTConfig(**SMALL, moe_experts=4))
    with pytest.raises(ValueError, match="register tokens"):
        vit.VisionTransformer(configs.ViTConfig(
            **SMALL, num_prefix_tokens=2))(x)
