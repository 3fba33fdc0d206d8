"""The port's Swin (``keep_tpu_torch.models.swin``) against the JAX
package's on the CPU: the window helpers and the seam mask equal JAX's;
both stems (the linear 4×4 patch embed and CTransPath's conv stem) on a
config with shifted stages and a last stage whose window covers the map
(no shift there) agree at 2e-5 in fp32 and at cosine ≥ 0.999 in bf16,
the JAX ``init``'s weights (norms and biases moved) carried by
``compat.torch_loader.from_jax_tree``; ``convert_timm_swin`` gives the
JAX converter's tree on one synthetic timm state dict."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keep_tpu.models import swin as jswin
from keep_tpu_torch.compat.torch_loader import from_jax_tree
from keep_tpu_torch.models import swin
from torch_zoo import cos_min, moved

TOL = dict(atol=2e-5, rtol=2e-5)
# 64² → a 16² map at stride 4: stages of 16², 8² (window 4, shifted on
# the odd blocks) and 4² (the window covers it: no shift)
SHAPE = dict(img_size=64, embed_dim=16, depths=(2, 2, 2), heads=(2, 2, 4),
             window=4, num_features_mult=4)


def _cfgs(conv_stem):
    return (jswin.SwinConfig(**SHAPE, conv_stem=conv_stem),
            swin.SwinConfig(**SHAPE, conv_stem=conv_stem))


def _count(path):
    return SHAPE["depths"][int(path[-2][len("stage"):])]


def _pair(conv_stem, seed=0):
    jcfg, cfg = _cfgs(conv_stem)
    params = moved(jswin.init(jax.random.PRNGKey(seed), jcfg))
    m = swin.Swin(cfg)
    m.load_state_dict(from_jax_tree(params, _count), strict=True)
    return params, m.eval(), jcfg


def test_window_helpers_match_jax(rng):
    x = rng.standard_normal((2, 8, 12, 5)).astype(np.float32)
    wins = swin.window_partition(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(wins.numpy(), np.asarray(
        jswin.window_partition(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(
        swin.window_reverse(wins, 4, 8, 12).numpy(), x)
    for w in (3, 4, 7):
        np.testing.assert_array_equal(swin.relative_position_index(w),
                                      jswin.relative_position_index(w))
    for h, ww, w, shift in ((8, 8, 4, 2), (16, 16, 4, 2), (14, 14, 7, 3)):
        np.testing.assert_array_equal(swin.shift_attn_mask(h, ww, w, shift),
                                      jswin.shift_attn_mask(h, ww, w, shift))


@pytest.mark.parametrize("conv_stem", [False, True])
def test_swin_matches_jax(rng, conv_stem):
    params, m, jcfg = _pair(conv_stem)
    x = rng.standard_normal((2, 64, 64, 3), dtype=np.float32)
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    ref = jswin.forward(params, jnp.asarray(x), jcfg)
    assert got.shape == ref.shape == (2, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_shift_and_its_rule(rng, monkeypatch):
    """The shifted blocks move the features (a roll-free run differs), and
    the last stage, whose 4² map the window covers, runs unshifted."""
    params, m, jcfg = _pair(False, seed=2)
    x = torch.from_numpy(rng.standard_normal((1, 64, 64, 3),
                                             dtype=np.float32))
    shifts = []
    forward = swin.SwinBlock.forward

    def spy(self, y, shift):
        shifts.append((y.shape[1], shift))
        return forward(self, y, shift)

    monkeypatch.setattr(swin.SwinBlock, "forward", spy)
    with torch.no_grad():
        a = m(x)
    assert shifts == [(16, 0), (16, 2), (8, 0), (8, 2), (4, 0), (4, 0)]
    monkeypatch.setattr(swin.SwinBlock, "forward",
                        lambda self, y, shift: forward(self, y, 0))
    with torch.no_grad():
        b = m(x)
    assert (a - b).abs().max().item() > 1e-4


@pytest.mark.parametrize("conv_stem", [False, True])
def test_swin_bf16_matches_jax(rng, conv_stem):
    params, m, jcfg = _pair(conv_stem, seed=1)
    x = rng.standard_normal((2, 64, 64, 3), dtype=np.float32)
    with torch.no_grad():
        got = m(torch.from_numpy(x), dtype=torch.bfloat16)
    ref = jswin.forward(params, jnp.asarray(x), jcfg, dtype=jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    assert cos_min(got, np.asarray(ref.astype(jnp.float32))) >= 0.999


def _timm_sd(rng, cfg):
    r = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32) * 0.1)
    c = cfg.embed_dim
    sd = {"patch_embed.proj.weight": r(c, 3, 4, 4),
          "patch_embed.proj.bias": r(c), "patch_embed.norm.weight": r(c),
          "patch_embed.norm.bias": r(c)}
    for si, depth in enumerate(cfg.depths):
        for bi in range(depth):
            pre = f"layers.{si}.blocks.{bi}."
            for n, (o, i) in (("attn.qkv", (3 * c, c)),
                              ("attn.proj", (c, c)), ("mlp.fc1", (4 * c, c)),
                              ("mlp.fc2", (c, 4 * c))):
                sd[pre + n + ".weight"], sd[pre + n + ".bias"] = r(o, i), r(o)
            for n in ("norm1", "norm2"):
                sd[pre + n + ".weight"], sd[pre + n + ".bias"] = r(c), r(c)
            sd[pre + "attn.relative_position_bias_table"] = r(
                (2 * cfg.window - 1) ** 2, cfg.heads[si])
        if si < len(cfg.depths) - 1:
            d = f"layers.{si}.downsample."
            sd[d + "norm.weight"], sd[d + "norm.bias"] = r(4 * c), r(4 * c)
            sd[d + "reduction.weight"] = r(2 * c, 4 * c)
            c *= 2
    sd["norm.weight"], sd["norm.bias"] = r(c), r(c)
    return sd


def test_convert_timm_swin_matches_jax(rng):
    jcfg, cfg = _cfgs(False)
    sd = _timm_sd(rng, cfg)
    got = swin.convert_timm_swin(sd, cfg)
    jtree = jswin.convert_timm_swin(sd, jcfg)
    ref = from_jax_tree(jtree, _count)
    assert got.keys() == ref.keys()
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    m = swin.Swin(cfg)
    m.load_state_dict(got, strict=True)
    x = rng.standard_normal((1, 64, 64, 3), dtype=np.float32)
    with torch.no_grad():
        out = m.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jswin.forward(
        jax.tree.map(jnp.asarray, jtree), jnp.asarray(x), jcfg)), **TOL)
