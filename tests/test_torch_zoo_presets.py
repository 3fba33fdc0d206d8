"""The port's presets of every tower kind beside the ViT family, and the
registry's ``kep`` and ``rn50-clip``, against the JAX package (CPU): one
preset per kind (ModifiedResNet, ConvNeXt with its linear and MLP heads,
Swin, EVA02 TrV and E, the relpos ViT, the path-BERT, RoBERTa, XLM-R and
mT5 text towers) shrunk to 1–2 blocks a stage at its own head width,
held to JAX's ``create_preset`` ``encode_image`` / ``encode_text`` /
``forward`` at its component's tolerance in fp32 (the BERT-family text
towers through the fused attention #1 too) and at cosine ≥ 0.999 in
bf16, weights carried by ``from_jax_preset_params``, which counts each
stack by its own config; and twins of ``tests/test_factory_cov.py``'s
``kep`` and ``rn50-clip`` cases, held to the JAX factory's models."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keep_tpu import presets as jpresets
from keep_tpu.configs import ViTConfig as JViTConfig
from keep_tpu_torch import configs, factory, presets
from keep_tpu_torch.compat.torch_loader import from_jax_preset_params

TOL = dict(atol=2e-5, rtol=2e-5)
TINY_VIT = dict(img_size=32, patch_size=16, embed_dim=32, depth=1,
                num_heads=2)
TINY_BERT = dict(vocab_size=64, hidden_size=32, num_hidden_layers=1,
                 num_attention_heads=2, intermediate_size=64,
                 max_position_embeddings=32)
# ---- every other tower kind, shrunk, against JAX's create_preset -----------

def _to_jax(cfg):
    """A port config as the JAX package's class of the same name."""
    from keep_tpu import configs as jconfigs
    from keep_tpu.models import (convnext, eva, hf_text, resnet, swin, t5,
                                 text_transformer, vit_relpos)

    classes = {c.__name__: c for c in (
        jconfigs.ViTConfig, jconfigs.BertConfig,
        text_transformer.TextTransformerConfig,
        resnet.ModifiedResNetConfig, convnext.ConvNeXtConfig,
        swin.SwinConfig, eva.EvaConfig, vit_relpos.ViTRelPosConfig,
        hf_text.HFTextConfig, t5.T5EncoderConfig)}
    return classes[type(cfg).__name__](**{
        f.name: (_to_jax(getattr(cfg, f.name))
                 if dataclasses.is_dataclass(getattr(cfg, f.name))
                 else getattr(cfg, f.name))
        for f in dataclasses.fields(cfg)})


def _shrink_any(r, embed=32):
    """``r``'s towers at 1–2 blocks a stage, narrow widths at their own head
    width, small images, a 100-id vocabulary and 16-token CLIP context."""
    v, t = r.vision_cfg, r.text_cfg
    k = r.vision_kind
    if k in ("vit", "vit_gap", "eva01_g"):
        v = dataclasses.replace(v, depth=2, num_heads=2,
                                embed_dim=2 * v.head_dim,
                                img_size=4 * v.patch_size)
    elif k == "rn":
        v = dataclasses.replace(v, layers=(1, 1, 1, 1), width=16,
                                image_size=64, heads=8, output_dim=embed)
    elif k == "convnext":
        v = dataclasses.replace(v, depths=(1, 2, 1, 1),
                                dims=(16, 32, 48, 64), img_size=64)
    elif k == "swin":
        # three stages at 112²: 28² and 14² shifted, 7² (the window) not
        v = dataclasses.replace(v, img_size=112, embed_dim=64,
                                depths=(2, 2, 2), heads=(2, 4, 8),
                                num_features_mult=4)
    elif k == "eva02":
        v = dataclasses.replace(v, depth=2, num_heads=2,
                                embed_dim=2 * v.head_dim, mlp_hidden=96,
                                img_size=4 * v.patch_size, out_dim=embed)
    elif k == "vit_relpos":
        v = dataclasses.replace(v, depth=2, num_heads=2,
                                embed_dim=2 * v.head_dim, rel_pos_hidden=32,
                                img_size=4 * v.patch_size)
    if r.text_kind == "clip":
        t = dataclasses.replace(t, layers=2, heads=2, width=2 * t.head_dim,
                                context_length=16, vocab_size=100,
                                output_dim=embed)
    elif r.text_kind == "path_bert":
        t = dataclasses.replace(t, num_hidden_layers=2,
                                num_attention_heads=1, hidden_size=64,
                                intermediate_size=96, vocab_size=100,
                                max_position_embeddings=32)
    elif t.arch == "mt5":
        t = dataclasses.replace(t, output_dim=embed, trunk=dataclasses.replace(
            t.trunk, vocab_size=100, d_model=32, num_heads=4, d_kv=8,
            d_ff=64, num_layers=2))
    else:
        t = dataclasses.replace(t, output_dim=embed, trunk=dataclasses.replace(
            t.trunk, vocab_size=100, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=1, intermediate_size=96,
            max_position_embeddings=32))
    return dataclasses.replace(r, vision_cfg=v, text_cfg=t, embed_dim=embed)


# one preset per tower kind not covered above, with its component's
# tolerance (the JAX tests': ResNet 5e-5, ConvNeXt 1e-4 / 1e-3, RoBERTa
# 3e-5, T5 5e-5, the ViT family 2e-5)
KINDS = [("RN50", 5e-5, 5e-5), ("convnext_base", 1e-4, 1e-3),
         ("convnext_large_d", 1e-4, 1e-3),
         ("swin_base_patch4_window7_224", 2e-5, 2e-5),
         ("EVA02-B-16", 2e-5, 2e-5), ("EVA02-E-14", 2e-5, 2e-5),
         ("vit_relpos_medium_patch16_cls_224", 2e-5, 2e-5),
         ("ViT-B-32-bert", 2e-5, 2e-5), ("roberta-ViT-B-32", 3e-5, 3e-5),
         ("xlm-roberta-base-ViT-B-32", 3e-5, 3e-5),
         ("mt5-base-ViT-B-32", 5e-5, 5e-5)]


def _shrunk_pair(monkeypatch, name, seed=0):
    r = _shrink_any(presets.resolve(name))
    jr = jpresets.ResolvedPreset(r.name, r.family, r.embed_dim,
                                 r.vision_kind, _to_jax(r.vision_cfg),
                                 r.vision_proj, r.text_kind,
                                 _to_jax(r.text_cfg), r.quick_gelu)
    monkeypatch.setattr(jpresets, "resolve", lambda _: jr)
    params, jmodel = jpresets.create_preset(name, seed=seed)
    from torch_zoo import moved

    params = moved(params)
    m = presets.build_preset(r, device="cpu")
    m.load_state_dict(from_jax_preset_params(params, r), strict=True)
    return r, params, jmodel, m


def _jit(r, fn):
    """``jax.jit(fn)``, or ``fn`` for the JAX Swin, whose seam mask is
    built with numpy from traced values."""
    return fn if r.vision_kind == "swin" else jax.jit(fn)


def _ids(r, rng):
    t = r.text_cfg
    pad = t.trunk.pad_token_id if r.text_kind == "hf" else 0
    ids = rng.integers(3, 99, size=(3, 16))
    ids[1, 9:] = pad
    if r.text_kind == "clip":
        ids[:, 9] = 99  # the EOT id, the highest
    return ids


@pytest.mark.parametrize("name,atol,rtol", KINDS)
def test_shrunk_tower_kind_matches_jax(monkeypatch, rng, name, atol, rtol):
    """JAX's ``create_preset`` on the shrunk resolution (its Pallas kernel
    in interpret mode under ``use_flash`` for the BERT-family text towers)
    and the port's ``build_preset`` on the same weights, carried by
    ``from_jax_preset_params``, give the same features."""
    tol = dict(atol=atol, rtol=rtol)
    r, params, jmodel, m = _shrunk_pair(monkeypatch, name)
    v = r.vision_cfg
    size = getattr(v, "img_size", None) or v.image_size
    pixels = rng.standard_normal((2, size, size, 3), dtype=np.float32)
    ids = _ids(r, rng)
    jx, jids = jnp.asarray(pixels), jnp.asarray(ids)
    tx, tids = torch.from_numpy(pixels), torch.from_numpy(ids)
    text_kw = ([{}, {"use_flash": True}] if r.text_kind != "clip"
               and getattr(r.text_cfg, "arch", "") != "mt5" else [{}])
    with torch.no_grad():
        np.testing.assert_allclose(
            m.encode_image(tx).numpy(),
            np.asarray(_jit(r, jmodel.encode_image)(params, jx)), **tol)
        for kw in text_kw:
            np.testing.assert_allclose(
                m.encode_text(tids, **kw).numpy(),
                np.asarray(jax.jit(functools.partial(
                    jmodel.encode_text, **kw))(params, jids)), **tol)
        out = m(tx, tids)
    ref = _jit(r, jmodel.forward)(params, jx, jids)
    for k in ("image_features", "text_features"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), **tol)
    assert float(out["logit_scale"]) == pytest.approx(
        float(ref["logit_scale"]), rel=1e-6)


@pytest.mark.parametrize("name", ["RN50", "swin_base_patch4_window7_224",
                                  "convnext_base", "EVA02-B-16",
                                  "roberta-ViT-B-32"])
def test_shrunk_tower_kind_bf16_matches_jax(monkeypatch, rng, name):
    """bf16 on both sides at cosine ≥ 0.999. The RN and Swin towers compute
    in fp32 whatever ``dtype`` is asked, in both packages (the JAX
    closures drop their keywords): their features come back fp32 and equal
    to the default call's."""
    r, params, jmodel, m = _shrunk_pair(monkeypatch, name, seed=1)
    v = r.vision_cfg
    size = getattr(v, "img_size", None) or v.image_size
    pixels = rng.standard_normal((2, size, size, 3), dtype=np.float32)
    ids = _ids(r, rng)
    with torch.no_grad():
        img = m.encode_image(torch.from_numpy(pixels), dtype=torch.bfloat16)
        txt = m.encode_text(torch.from_numpy(ids), dtype=torch.bfloat16)
        img32 = m.encode_image(torch.from_numpy(pixels))
    jimg = _jit(r, functools.partial(jmodel.encode_image, dtype=jnp.bfloat16)
                )(params, jnp.asarray(pixels))
    jtxt = jax.jit(functools.partial(jmodel.encode_text, dtype=jnp.bfloat16)
                   )(params, jnp.asarray(ids))
    fp32_tower = r.vision_kind in presets.FP32_VISION
    assert (img.dtype == torch.float32) == fp32_tower
    assert (jimg.dtype == jnp.float32) == fp32_tower
    if fp32_tower:
        assert torch.equal(img, img32)
    from torch_zoo import cos_min

    assert cos_min(img, np.asarray(jimg.astype(jnp.float32))) >= 0.999
    assert cos_min(txt, np.asarray(jtxt.astype(jnp.float32))) >= 0.999


def test_preset_params_count_each_stack(monkeypatch):
    """``from_jax_preset_params`` takes each stack's count from the
    resolution: a ConvNeXt stage or a Swin stage of another depth, or a
    stack the config does not have, is refused."""
    r, params, _, _ = _shrunk_pair(monkeypatch, "convnext_base")
    bad = dataclasses.replace(r, vision_cfg=dataclasses.replace(
        r.vision_cfg, depths=(1, 1, 1, 1)))
    with pytest.raises(ValueError, match="stages.1.blocks has 2"):
        from_jax_preset_params(params, bad)
    r, params, _, _ = _shrunk_pair(monkeypatch,
                                   "swin_base_patch4_window7_224")
    blocks = params["visual"]["stage1"]["blocks"]
    last = blocks.pop()
    with pytest.raises(ValueError, match="stage1.blocks has 1"):
        from_jax_preset_params(params, r)
    blocks.append(last)
    params["extra"] = {"blocks": {"w": np.zeros((2, 3))}}
    with pytest.raises(ValueError, match="extra.blocks"):
        from_jax_preset_params(params, r)


def test_kep_builder_with_overrides():
    """The registry's ``kep`` at tiny override shapes, held to the JAX
    factory's model at the same shapes."""
    from keep_tpu import factory as jfactory
    from keep_tpu.configs import BertConfig as JBertConfig

    from keep_tpu_torch.compat.torch_loader import from_jax_kep_params

    m = factory.create_model("kep", device="cpu",
                             vision=configs.ViTConfig(**TINY_VIT),
                             text=configs.BertConfig(**TINY_BERT),
                             embed_dim=32, with_knowledge=False)
    assert m.family == "kep" and m.knowledge is None
    assert any(k.startswith("visual.") for k in m.state_dict())
    params, spec = jfactory.create_model(
        "kep", vision=JViTConfig(**TINY_VIT), text=JBertConfig(**TINY_BERT),
        embed_dim=32, with_knowledge=False)
    assert spec.family == "kep"
    m.load_state_dict(from_jax_kep_params(jax.tree.map(np.asarray, params),
                                          m.config), strict=True)
    x = np.linspace(-1, 1, 32 * 32 * 3, dtype=np.float32).reshape(
        1, 32, 32, 3)
    ids = np.arange(1, 9)[None]
    with torch.no_grad():
        img = m.encode_image(torch.from_numpy(x), normalize=True)
        txt = m.encode_text(torch.from_numpy(ids), normalize=True)
    np.testing.assert_allclose(img.numpy(), np.asarray(spec.encode_image(
        params, jnp.asarray(x), spec.config, normalize=True)), **TOL)
    np.testing.assert_allclose(txt.numpy(), np.asarray(spec.encode_text(
        params, jnp.asarray(ids), None, spec.config, normalize=True)), **TOL)


def test_rn50_builder_with_overrides():
    from keep_tpu import factory as jfactory

    m = factory.create_model("rn50-clip", device="cpu", layers=(1, 1, 1, 1),
                             width=8, heads=2, output_dim=16, image_size=32)
    assert m.family == "clip" and m.config.width == 8
    x = np.linspace(-1, 1, 32 * 32 * 3, dtype=np.float32).reshape(
        1, 32, 32, 3)
    with torch.no_grad():
        assert m.encode_image(torch.from_numpy(x)).shape == (1, 16)
    params, spec = jfactory.create_model(
        "rn50-clip", layers=(1, 1, 1, 1), width=8, heads=2, output_dim=16,
        image_size=32)
    from keep_tpu_torch.compat.torch_loader import from_jax_tree

    m.load_state_dict(from_jax_tree(jax.tree.map(np.asarray, params),
                                    lambda path: 1), strict=True)
    with torch.no_grad():
        got = m.encode_image(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.jit(
        lambda p, x: spec.encode_image(p, x, spec.config))(
            params, jnp.asarray(x))), atol=5e-5, rtol=5e-5)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        import unittest.mock as mock

        with mock.patch.object(torch.cuda, "is_available", lambda: False):
            factory.create_model("rn50-clip")


def test_zoo_towers_phase_runs_on_the_cpu(monkeypatch):
    """``chip_smoke.py``'s ``zoo_towers`` phase, rehearsed on the CPU at a
    tiny size: every listed preset (shrunk as above), the registry's two
    entries, the card-against-CPU and BERT bf16 checks; the attention
    wrappers counted so that the launch gates hold as on the card."""
    import chip_smoke
    from keep_tpu_torch.kernels import flash_attention as fa
    from keep_tpu_torch.models import bert, kep, resnet, vit

    plain = fa.attention_qkv_slab

    def counted(*a, **k):
        with fa._launch_lock:
            fa.LAUNCHES += 1
        return plain(*a, **k)

    for mod in (bert, vit):
        monkeypatch.setattr(mod, "attention_qkv_slab", counted)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(chip_smoke, "ZOO_TEXT_TOWERS", tuple(
        (n, 16) for n, _ in chip_smoke.ZOO_TEXT_TOWERS))
    kep_cfg = kep.KEPConfig(
        vision=configs.ViTConfig(**dict(TINY_VIT, depth=2)),
        text=configs.BertConfig(**dict(TINY_BERT, num_hidden_layers=2)),
        embed_dim=16)
    rn_cfg = resnet.ModifiedResNetConfig(layers=(1, 1, 1, 1), width=8,
                                         heads=2, output_dim=16,
                                         image_size=32)
    out = chip_smoke.drive_zoo_towers(torch, fa, device="cpu", batch=(2, 3),
                                      shrink=_shrink_any, kep_cfg=kep_cfg,
                                      rn_cfg=rn_cfg)
    assert set(out["image"]) == set(chip_smoke.ZOO_IMAGE_TOWERS)
    assert {k: v["attention_launches"] for k, v in out["text"].items()} == {
        "ViT-B-32-bert": 2, "xlm-roberta-large-ViT-H-14": 2,
        "roberta-ViT-B-32": 2, "mt5-xl-ViT-H-14": 0}
    assert [t["attention_launches"] for t in (
        out["registry"]["kep"][k] for k in ("image", "text", "knowledge"))
            ] == [2, 2, 2]
    assert len(out["card_vs_cpu"]) == len(chip_smoke.ZOO_CARD_VS_CPU)
    assert out["bert_flash_bf16"]["pooler_1_minus_cos"] < 1e-6
