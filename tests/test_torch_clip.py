"""The port's CLIP text tower, CLIP model and OpenAI checkpoint loader
against the JAX package on the same weights (CPU, tiny widths): twins of
``tests/test_models_extra.py::test_text_transformer_matches_torch``,
``::test_eot_pooling_position``, ``::test_clip_model_api``,
``::test_openai_clip_loader``, ``::test_openai_loader_path_legs`` and
``::test_quick_gelu_parity``, and the custom block's four options
(``scaled_cosine``, ``scale_heads``, ``scale_attn``, ``scale_fc``). Weights
go from JAX to the port through ``from_jax_clip_params``. Port against
torch at the JAX twin's 3e-5, against JAX at 2e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keep_tpu.compat import openai as jopenai
from keep_tpu.configs import ViTConfig as JViTConfig
from keep_tpu.models import clip as jclip
from keep_tpu.models import text_transformer as jtext
from keep_tpu_torch.compat import openai
from keep_tpu_torch.compat.torch_loader import from_jax_clip_params
from keep_tpu_torch.configs import ViTConfig
from keep_tpu_torch.models import clip, text_transformer
from tests.test_models_extra import TT_CFG as J_TT_CFG
from tests.test_models_extra import TorchOpenAIText

TT = dict(vocab_size=100, context_length=24, width=32, heads=4, layers=2,
          output_dim=16)
TT_CFG = text_transformer.TextTransformerConfig(**TT)
TOL = dict(atol=2e-5, rtol=2e-5)


def _ids(rng, n=3, eot=99):
    ids = rng.integers(1, 80, size=(n, 24))
    ids[:, -1] = eot  # EOT = the highest id
    return ids


def _text_pair(options, seed=0):
    """(JAX text params, JAX config, the port's tower on them), with the
    custom block's extras and the LayerNorms moved off their init."""
    jc = jtext.TextTransformerConfig(**TT, **options)
    params = jax.tree.map(np.array, jtext.init(jax.random.PRNGKey(seed), jc))
    rng = np.random.default_rng(seed + 1)
    b = params["blocks"]
    for node in (b["norm1"], b["norm2"], b.get("ln_attn"),
                 b["mlp"].get("ln"), params["ln_final"]):
        if node is not None:
            node["scale"] += 0.2 * rng.standard_normal(node["scale"].shape
                                                       ).astype(np.float32)
            node["bias"] += 0.1 * rng.standard_normal(node["bias"].shape
                                                      ).astype(np.float32)
    for k in ("logit_scale", "head_scale"):
        if k in b["attn"]:
            b["attn"][k] += 0.3 * rng.standard_normal(b["attn"][k].shape
                                                      ).astype(np.float32)
    m = text_transformer.TextTransformer(
        text_transformer.TextTransformerConfig(**TT, **options))
    sd = from_jax_clip_params({"text": params}, 0, jc.layers)
    m.load_state_dict({k.removeprefix("text."): v for k, v in sd.items()},
                      strict=True)
    return params, jc, m.eval()


def _text(m, ids, **kw):
    with torch.no_grad():
        return m(torch.from_numpy(ids), **kw).numpy()


def test_text_transformer_matches_torch(rng):
    """The OpenAI text tower in torch (nn.MultiheadAttention, causal mask,
    argmax pooling), converted with convert_openclip_text, equals the
    port's tower; the JAX tower too."""
    tmodel = TorchOpenAIText(J_TT_CFG).eval()
    sd = tmodel.state_dict()
    m = text_transformer.TextTransformer(TT_CFG)
    m.load_state_dict(text_transformer.convert_openclip_text(sd, TT_CFG,
                                                             prefix=""))
    ids = _ids(rng)
    with torch.no_grad():
        ref = tmodel(torch.from_numpy(ids)).numpy()
    got = _text(m.eval(), ids)
    np.testing.assert_allclose(got, ref, atol=3e-5, rtol=3e-5)
    jref = np.asarray(jtext.forward(jtext.convert_openclip_text(sd, J_TT_CFG),
                                    jnp.asarray(ids), J_TT_CFG))
    np.testing.assert_allclose(got, jref, **TOL)


def test_eot_pooling_position(rng):
    """Pooling follows argmax(ids): EOT mid-sequence changes the output."""
    _, _, m = _text_pair({})
    ids = np.full((1, 24), 5, np.int64)
    ids[0, 10] = 99
    ids2 = ids.copy()
    ids2[0, 10] = 5
    ids2[0, 20] = 99
    assert np.abs(_text(m, ids) - _text(m, ids2)).max() > 1e-4


@pytest.mark.parametrize("options", [
    {},
    dict(scaled_cosine=True, scale_heads=True, scale_attn=True,
         scale_fc=True),
    dict(scale_heads=True),
    dict(scaled_cosine=True),
    dict(scale_attn=True, scale_fc=True, act="quick_gelu"),
], ids=["plain", "all_four", "scale_heads", "scaled_cosine",
        "scale_attn_fc_quick_gelu"])
def test_custom_block_options_match_jax(rng, options):
    params, jc, m = _text_pair(options)
    ids = _ids(rng)
    ref = np.asarray(jtext.forward(params, jnp.asarray(ids), jc))
    np.testing.assert_allclose(_text(m, ids), ref, **TOL)


def test_convert_openclip_text_with_the_extras(rng):
    """An OpenCLIP-layout state dict with the custom block's keys
    (attn.logit_scale [H, 1, 1], attn.head_scale, ln_attn.*, mlp.ln.*)
    converts in both packages to the same tower."""
    options = dict(scaled_cosine=True, scale_heads=True, scale_attn=True,
                   scale_fc=True)
    tmodel = TorchOpenAIText(J_TT_CFG).eval()
    sd = dict(tmodel.state_dict())
    g = torch.Generator().manual_seed(0)
    for i in range(TT["layers"]):
        pre = f"transformer.resblocks.{i}."
        sd[pre + "attn.logit_scale"] = (np.log(10.0) + 0.3 * torch.randn(
            TT["heads"], 1, 1, generator=g))
        sd[pre + "attn.head_scale"] = 1 + 0.2 * torch.randn(TT["heads"], 1, 1,
                                                            generator=g)
        for ln, w in (("ln_attn", TT["width"]), ("mlp.ln", 4 * TT["width"])):
            sd[pre + ln + ".weight"] = 1 + 0.1 * torch.randn(w, generator=g)
            sd[pre + ln + ".bias"] = 0.1 * torch.randn(w, generator=g)
    jc = dataclasses.replace(J_TT_CFG, **options)
    cfg = dataclasses.replace(TT_CFG, **options)
    m = text_transformer.TextTransformer(cfg)
    m.load_state_dict(text_transformer.convert_openclip_text(sd, cfg,
                                                             prefix=""))
    ids = _ids(rng)
    ref = np.asarray(jtext.forward(jtext.convert_openclip_text(sd, jc),
                                   jnp.asarray(ids), jc))
    np.testing.assert_allclose(_text(m.eval(), ids), ref, **TOL)


def _jax_clip_cfg():
    return jclip.CLIPConfig(
        embed_dim=16,
        vision=JViTConfig(img_size=16, patch_size=8, embed_dim=32, depth=2,
                          num_heads=2, layerscale_init=None, ln_eps=1e-5),
        text=J_TT_CFG)


def _port_clip_cfg(jc):
    return clip.CLIPConfig(
        embed_dim=jc.embed_dim,
        vision=ViTConfig(**dataclasses.asdict(jc.vision)),
        text=text_transformer.TextTransformerConfig(
            **dataclasses.asdict(jc.text)),
        logit_scale_init=jc.logit_scale_init)


def test_clip_model_api(rng):
    """encode_image / encode_text / forward of the port's CLIP on the JAX
    CLIP's weights: the JAX features at 2e-5, unit rows, exp(logit_scale)
    = 1/0.07; CLIP.init draws the same structure from a generator."""
    jc = _jax_clip_cfg()
    params = jax.tree.map(np.asarray, jclip.init(jax.random.PRNGKey(0), jc))
    cfg = _port_clip_cfg(jc)
    m = clip.CLIP(cfg)
    m.load_state_dict(from_jax_clip_params(params, jc.vision.depth,
                                           jc.text.layers), strict=True)
    pixels = rng.standard_normal((2, 16, 16, 3), dtype=np.float32)
    ids = rng.integers(1, 99, size=(2, 24))
    ref = jclip.forward(params, jnp.asarray(pixels), jnp.asarray(ids), jc)
    with torch.no_grad():
        out = m.eval()(torch.from_numpy(pixels), torch.from_numpy(ids))
    for k in ("image_features", "text_features"):
        assert out[k].shape == (2, 16)
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), **TOL)
        np.testing.assert_allclose(out[k].norm(dim=1).numpy(), 1.0,
                                   atol=1e-5)
    assert float(out["logit_scale"]) == pytest.approx(1 / 0.07, rel=1e-4)
    drawn = clip.CLIP.init(cfg, torch.Generator().manual_seed(0))
    assert drawn.state_dict().keys() == m.state_dict().keys()
    assert float(drawn.logit_scale.exp()) == pytest.approx(1 / 0.07,
                                                           rel=1e-4)


def openai_state_dict(D=64, P=8, L=2, W=32, TL=2, V=96, CTX=20, E=16,
                      grid=4):
    """A synthetic OpenAI-layout CLIP checkpoint (the JAX twin's)."""
    torch.manual_seed(0)
    sd = {"visual.conv1.weight": torch.randn(D, 3, P, P) * 0.05,
          "visual.class_embedding": torch.randn(D) * 0.02,
          "visual.positional_embedding": torch.randn(grid * grid + 1, D) * 0.02,
          "visual.ln_pre.weight": torch.rand(D) + 0.5,
          "visual.ln_pre.bias": torch.randn(D) * 0.1}

    def blocks(prefix, n, w):
        for i in range(n):
            pre = f"{prefix}transformer.resblocks.{i}."
            sd[pre + "ln_1.weight"] = torch.rand(w) + 0.5
            sd[pre + "ln_1.bias"] = torch.randn(w) * 0.1
            sd[pre + "attn.in_proj_weight"] = torch.randn(3 * w, w) * 0.05
            sd[pre + "attn.in_proj_bias"] = torch.zeros(3 * w)
            sd[pre + "attn.out_proj.weight"] = torch.randn(w, w) * 0.05
            sd[pre + "attn.out_proj.bias"] = torch.zeros(w)
            sd[pre + "ln_2.weight"] = torch.rand(w) + 0.5
            sd[pre + "ln_2.bias"] = torch.randn(w) * 0.1
            sd[pre + "mlp.c_fc.weight"] = torch.randn(4 * w, w) * 0.05
            sd[pre + "mlp.c_fc.bias"] = torch.zeros(4 * w)
            sd[pre + "mlp.c_proj.weight"] = torch.randn(w, 4 * w) * 0.05
            sd[pre + "mlp.c_proj.bias"] = torch.zeros(w)

    blocks("visual.", L, D)
    sd["visual.ln_post.weight"] = torch.rand(D) + 0.5
    sd["visual.ln_post.bias"] = torch.randn(D) * 0.1
    sd["visual.proj"] = torch.randn(D, E) * 0.05
    sd["token_embedding.weight"] = torch.randn(V, W) * 0.02
    sd["positional_embedding"] = torch.randn(CTX, W) * 0.01
    blocks("", TL, W)
    sd["ln_final.weight"] = torch.rand(W) + 0.5
    sd["ln_final.bias"] = torch.randn(W) * 0.1
    sd["text_projection"] = torch.randn(W, E) * 0.05
    sd["logit_scale"] = torch.ones([]) * np.log(1 / 0.07)
    return sd


def test_openai_clip_loader(rng):
    """Config inference equal to the JAX package's, field for field; the
    converted checkpoint's features equal the JAX loader's."""
    sd = openai_state_dict()
    jc = jopenai.infer_clip_config(sd)
    cfg = openai.infer_clip_config(sd)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jc)
    assert cfg.vision.img_size == 32 and cfg.vision.depth == 2
    assert cfg.text.vocab_size == 96 and cfg.embed_dim == 16
    # head counts are inferred as width // 64; tiny widths need an override
    jc = dataclasses.replace(jc, vision=dataclasses.replace(jc.vision,
                                                            num_heads=4),
                             text=dataclasses.replace(jc.text, heads=4))
    cfg = dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision,
                                                              num_heads=4),
                              text=dataclasses.replace(cfg.text, heads=4))
    jparams, jc = jopenai.load_openai_clip(sd, jc)
    state, cfg = openai.load_openai_clip(sd, cfg)
    m = clip.CLIP(cfg, ln_pre=True)
    m.load_state_dict(state, strict=True)
    pixels = rng.standard_normal((2, 32, 32, 3), dtype=np.float32)
    ids = rng.integers(1, 95, size=(2, 20))
    ref = jclip.forward(jparams, jnp.asarray(pixels), jnp.asarray(ids), jc)
    with torch.no_grad():
        out = m.eval()(torch.from_numpy(pixels), torch.from_numpy(ids))
    for k in ("image_features", "text_features"):
        assert out[k].shape == (2, 16) and torch.isfinite(out[k]).all()
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), **TOL)


def test_openai_loader_path_legs(tmp_path):
    """A plain torch.save state dict loads weights-only; a TorchScript
    archive (every original OpenAI release) goes through torch.jit.load; a
    dict without a ViT tower and no config raises the RN-tower error."""
    plain = tmp_path / "plain.pt"
    torch.save({"token_embedding.weight": torch.zeros(4, 8)}, plain)
    with pytest.raises(ValueError, match="RN-tower"):
        openai.load_openai_clip(str(plain))

    class M(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.register_buffer("weight", torch.zeros(2))

    scripted = tmp_path / "scripted.pt"
    torch.jit.save(torch.jit.script(M()), str(scripted))
    with pytest.raises(ValueError, match="RN-tower"):
        openai.load_openai_clip(str(scripted))
    full = tmp_path / "full.pt"
    torch.save(openai_state_dict(), full)
    state, cfg = openai.load_openai_clip(str(full))
    assert cfg.vision.act == cfg.text.act == "quick_gelu"
    clip.CLIP(cfg, ln_pre=True).load_state_dict(state, strict=True)


def test_quick_gelu_parity(rng):
    """act='quick_gelu' equals torch's x·sigmoid(1.702x) through the text
    tower, and differs from the erf GELU; the OpenAI config's inference
    sets it on both towers."""
    qcfg = dataclasses.replace(TT_CFG, act="quick_gelu")
    tmodel = TorchOpenAIText(J_TT_CFG).eval()

    class QuickGELU(torch.nn.Module):
        def forward(self, x):
            return x * torch.sigmoid(1.702 * x)

    for blk in tmodel.transformer.resblocks:
        blk.mlp.gelu = QuickGELU()
    sd = tmodel.state_dict()
    ids = _ids(rng)
    with torch.no_grad():
        ref = tmodel(torch.from_numpy(ids)).numpy()
    m = text_transformer.TextTransformer(qcfg)
    m.load_state_dict(text_transformer.convert_openclip_text(sd, qcfg,
                                                             prefix=""))
    got = _text(m.eval(), ids)
    np.testing.assert_allclose(got, ref, atol=3e-5, rtol=3e-5)
    plain = text_transformer.TextTransformer(TT_CFG)
    plain.load_state_dict(m.state_dict())
    assert np.abs(_text(plain.eval(), ids) - ref).max() > 1e-4
    sd = {"visual.conv1.weight": torch.randn(64, 3, 8, 8),
          "visual.positional_embedding": torch.randn(17, 64),
          "text_projection": torch.randn(32, 16),
          "ln_final.weight": torch.rand(32),
          "token_embedding.weight": torch.randn(96, 32),
          "positional_embedding": torch.randn(20, 32),
          "visual.transformer.resblocks.0.ln_1.weight": torch.rand(64),
          "transformer.resblocks.0.ln_1.weight": torch.rand(32)}
    inferred = openai.infer_clip_config(sd)
    assert inferred.vision.act == inferred.text.act == "quick_gelu"
