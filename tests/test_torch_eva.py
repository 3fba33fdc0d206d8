"""The port's EVA02 trunk and relpos ViT (``keep_tpu_torch.models.eva``,
``.vit_relpos``) against the JAX package's on the CPU: the rope angles and
rotation, the relative-offset table, index and per-block bias equal JAX's;
the TrV block (split q / k / v with no k bias, rope on the patch tokens
only, inner and sub-LN, SwiGLU) and the E block (fused qkv, GELU,
post-norm, no rope) agree at 2e-5 in fp32, the pos embed resampled at
another image size too, and at cosine ≥ 0.999 in bf16; the relpos ViT
likewise; the JAX ``init``'s weights (norms and biases moved) carried by
``compat.torch_loader.from_jax_tree``. ``convert_timm_eva`` (both
layouts) and ``convert_timm_vit_relpos`` (with and without the qkv bias)
give the JAX converters' trees on synthetic timm state dicts."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keep_tpu.compat import torch_loader as jloader
from keep_tpu.models import eva as jeva
from keep_tpu.models import vit_relpos as jvrp
from keep_tpu_torch.compat import torch_loader as loader
from keep_tpu_torch.models import eva, vit_relpos
from torch_zoo import cos_min, moved

TOL = dict(atol=2e-5, rtol=2e-5)
TRV = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4,
           mlp_hidden=96, out_dim=48)
E = dict(TRV, swiglu=False, scale_mlp=False, scale_attn_inner=False,
         qkv_fused=True, rope=False, post_norm=True, mlp_hidden=160)
RP = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4,
          rel_pos_hidden=32)
VARIANTS = {"trv": TRV, "e": E}


def _eva_pair(shape, seed=0):
    jcfg, cfg = jeva.EvaConfig(**shape), eva.EvaConfig(**shape)
    params = moved(jeva.init(jax.random.PRNGKey(seed), jcfg))
    m = eva.Eva(cfg)
    m.load_state_dict(loader.from_jax_tree(params, lambda p: cfg.depth),
                      strict=True)
    return params, m.eval(), jcfg


def test_rope_matches_jax(rng):
    for gh, gw, dh in ((4, 4, 16), (3, 5, 64), (24, 24, 64)):
        ang = eva.rope_2d_angles(gh, gw, dh)
        np.testing.assert_allclose(ang.numpy(), np.asarray(
            jeva.rope_2d_angles(gh, gw, dh)), rtol=1e-6, atol=1e-6)
        x = rng.standard_normal((2, 3, gh * gw, dh)).astype(np.float32)
        np.testing.assert_allclose(
            eva.apply_rope(torch.from_numpy(x), ang).numpy(),
            np.asarray(jeva.apply_rope(jnp.asarray(x), jnp.asarray(
                ang.numpy()))), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="divisible by 4"):
        eva.rope_2d_angles(2, 2, 18)


@pytest.mark.parametrize("size", [32, 48])
@pytest.mark.parametrize("variant", ["trv", "e"])
def test_eva_matches_jax(rng, variant, size):
    params, m, jcfg = _eva_pair(VARIANTS[variant])
    x = rng.standard_normal((2, size, size, 3), dtype=np.float32)
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    ref = jeva.forward(params, jnp.asarray(x), jcfg)
    assert got.shape == ref.shape == (2, 48)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("variant", ["trv", "e"])
def test_eva_bf16_matches_jax(rng, variant):
    params, m, jcfg = _eva_pair(VARIANTS[variant], seed=1)
    x = rng.standard_normal((2, 32, 32, 3), dtype=np.float32)
    with torch.no_grad():
        got = m(torch.from_numpy(x), dtype=torch.bfloat16)
    ref = jeva.forward(params, jnp.asarray(x), jcfg, dtype=jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    assert cos_min(got, np.asarray(ref.astype(jnp.float32))) >= 0.999


def test_eva_k_has_no_bias_and_e_is_post_norm():
    trv, e = eva.Eva(eva.EvaConfig(**TRV)), eva.Eva(eva.EvaConfig(**E))
    assert trv.blocks[0].attn.k.bias is None
    assert {"blocks.0.attn.q.bias", "blocks.0.attn.v.bias"} <= set(
        trv.state_dict())
    assert "blocks.0.attn.k.bias" not in trv.state_dict()
    assert e.blocks[0].post_norm and not hasattr(e.blocks[0].attn, "q")


def test_named_configs_match_jax():
    assert {k: dataclasses.asdict(v) for k, v in eva.EVA02_CONFIGS.items()} \
        == {k: dataclasses.asdict(v) for k, v in jeva.EVA02_CONFIGS.items()}


def _timm_eva_sd(cfg, rng, qkv_bias=False):
    d, f, n = cfg.embed_dim, cfg.mlp_hidden, cfg.grid ** 2
    r = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    sd = {"patch_embed.proj.weight": r(d, 3, cfg.patch_size, cfg.patch_size),
          "patch_embed.proj.bias": r(d), "cls_token": r(1, 1, d),
          "pos_embed": r(1, 1 + n, d), "norm.weight": r(d),
          "norm.bias": r(d), "head.weight": r(cfg.out_dim, d),
          "head.bias": r(cfg.out_dim)}
    for i in range(cfg.depth):
        p = f"blocks.{i}."
        for n_ in ("norm1", "norm2", "attn.proj"):
            sd[p + n_ + ".weight"] = r(d, d) if "proj" in n_ else r(d)
            sd[p + n_ + ".bias"] = r(d)
        if cfg.qkv_fused:
            sd[p + "attn.qkv.weight"] = r(3 * d, d)
            if qkv_bias:
                sd[p + "attn.qkv.bias"] = r(3 * d)
            else:
                sd[p + "attn.q_bias"], sd[p + "attn.v_bias"] = r(d), r(d)
        else:
            sd[p + "attn.q_proj.weight"], sd[p + "attn.q_proj.bias"] = \
                r(d, d), r(d)
            sd[p + "attn.k_proj.weight"] = r(d, d)
            sd[p + "attn.v_proj.weight"], sd[p + "attn.v_proj.bias"] = \
                r(d, d), r(d)
            sd[p + "attn.norm.weight"], sd[p + "attn.norm.bias"] = r(d), r(d)
        mlp = (("fc1_g", (f, d)), ("fc1_x", (f, d)), ("norm", (f,)),
               ("fc2", (d, f))) if cfg.swiglu else (("fc1", (f, d)),
                                                    ("fc2", (d, f)))
        for n_, shape in mlp:
            sd[p + f"mlp.{n_}.weight"] = r(*shape)
            sd[p + f"mlp.{n_}.bias"] = r(shape[0])
    return sd


@pytest.mark.parametrize("variant,qkv_bias", [("trv", False), ("e", False),
                                              ("e", True)])
def test_convert_timm_eva_matches_jax(rng, variant, qkv_bias):
    jcfg, cfg = (jeva.EvaConfig(**VARIANTS[variant]),
                 eva.EvaConfig(**VARIANTS[variant]))
    sd = _timm_eva_sd(cfg, rng, qkv_bias)
    got = loader.convert_timm_eva(sd, cfg)
    ref = loader.from_jax_tree(jloader.convert_timm_eva(sd, jcfg),
                               lambda p: cfg.depth)
    assert got.keys() == ref.keys()
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    eva.Eva(cfg).load_state_dict(got, strict=True)


# ---- relpos ViT -------------------------------------------------------------


def _relpos_pair(seed=0):
    jcfg = jvrp.ViTRelPosConfig(**RP)
    cfg = vit_relpos.ViTRelPosConfig(**RP)
    params = moved(jvrp.init(jax.random.PRNGKey(seed), jcfg))
    m = vit_relpos.ViTRelPos(cfg)
    m.load_state_dict(loader.from_jax_tree(params, lambda p: cfg.depth),
                      strict=True)
    return params, m.eval(), jcfg


def test_relpos_tables_and_bias_match_jax():
    for gh, gw in ((4, 4), (3, 5), (14, 14)):
        np.testing.assert_allclose(vit_relpos.rel_log_coords(gh, gw).numpy(),
                                   np.asarray(jvrp.rel_log_coords(gh, gw)),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(vit_relpos.rel_index(gh, gw).numpy(),
                                      np.asarray(jvrp.rel_index(gh, gw)))
    params, m, _ = _relpos_pair()
    layer0 = jax.tree.map(lambda a: a[0], params["blocks"]["attn"]["rel_pos"])
    with torch.no_grad():
        got = m.blocks[0].attn.rel_pos(4, 4)
    ref = np.asarray(jvrp.rel_pos_bias(layer0, 4, 4, 4))
    assert got.shape == ref.shape == (4, 17, 17)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    assert float(got[:, 0].abs().max()) == float(got[:, :, 0].abs().max()) \
        == 0.0


def test_relpos_matches_jax(rng):
    params, m, jcfg = _relpos_pair()
    x = rng.standard_normal((2, 32, 32, 3), dtype=np.float32)
    with torch.no_grad():
        got = m(torch.from_numpy(x))
        flash = m(torch.from_numpy(x), use_flash=True)  # accepted, ignored
        approx = m(torch.from_numpy(x), gelu_approx=True)
    ref = jvrp.forward(params, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert torch.equal(flash, got)
    np.testing.assert_allclose(approx.numpy(), np.asarray(jvrp.forward(
        params, jnp.asarray(x), jcfg, gelu_approx=True)), **TOL)
    with pytest.raises(ValueError, match="fixed"):
        m(torch.zeros(1, 40, 40, 3))


def test_relpos_bf16_matches_jax(rng):
    params, m, jcfg = _relpos_pair(1)
    x = rng.standard_normal((2, 32, 32, 3), dtype=np.float32)
    with torch.no_grad():
        got = m(torch.from_numpy(x), dtype=torch.bfloat16)
    ref = jvrp.forward(params, jnp.asarray(x), jcfg, dtype=jnp.bfloat16)
    assert cos_min(got, np.asarray(ref.astype(jnp.float32))) >= 0.999


@pytest.mark.parametrize("qkv_bias", [True, False])
def test_convert_timm_vit_relpos_matches_jax(rng, qkv_bias):
    cfg = vit_relpos.ViTRelPosConfig(**RP)
    d, f, h = cfg.embed_dim, cfg.mlp_hidden, cfg.rel_pos_hidden
    r = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    sd = {"patch_embed.proj.weight": r(d, 3, 8, 8),
          "patch_embed.proj.bias": r(d), "cls_token": r(1, 1, d),
          "norm.weight": r(d), "norm.bias": r(d)}
    for i in range(cfg.depth):
        p = f"blocks.{i}."
        for n, shape in (("norm1", (d,)), ("norm2", (d,)),
                         ("attn.qkv", (3 * d, d)), ("attn.proj", (d, d)),
                         ("attn.rel_pos.mlp.fc1", (h, 2)),
                         ("attn.rel_pos.mlp.fc2", (cfg.num_heads, h)),
                         ("mlp.fc1", (f, d)), ("mlp.fc2", (d, f))):
            sd[p + n + ".weight"] = r(*shape)
            if n != "attn.qkv" or qkv_bias:
                sd[p + n + ".bias"] = r(shape[0])
    got = loader.convert_timm_vit_relpos(sd, cfg)
    ref = loader.from_jax_tree(jloader.convert_timm_vit_relpos(sd, cfg),
                               lambda p: cfg.depth)
    assert got.keys() == ref.keys()
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    assert bool((got["blocks.1.attn.qkv.bias"] == 0).all()) != qkv_bias
    vit_relpos.ViTRelPos(cfg).load_state_dict(got, strict=True)
