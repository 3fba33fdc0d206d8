"""The port's OpenCLIP presets and model factory against the JAX package
(CPU): the 62 names; the 58 presets of every tower kind but CoCa's
resolved field for field as there, with the same tokenizer kind (or the
same refusal, for the HF text towers); the 4 CoCa presets, which raised
until ``models.coca`` was ported, built and encoding (their parity:
``tests/test_torch_coca.py``); one shrunk preset per tower kind (at its own head
width) held to JAX's ``encode_image`` / ``encode_text`` / ``forward`` at
its component's tolerance, weights carried by ``from_jax_clip_params``
(the ViT family) or ``from_jax_preset_params`` (every kind); and twins of
``tests/test_factory_cov.py``'s cases for the ported registry entries,
``kep`` and ``rn50-clip`` among them."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keep_tpu import presets as jpresets
from keep_tpu.configs import ViTConfig as JViTConfig
from keep_tpu.models.text_transformer import \
    TextTransformerConfig as JTextConfig
from keep_tpu_torch import configs, factory, presets
from keep_tpu_torch.compat.torch_loader import from_jax_clip_params
from keep_tpu_torch.models.text_transformer import TextTransformerConfig

TOL = dict(atol=2e-5, rtol=2e-5)
BUILT = [n for n in jpresets.preset_names()
         if jpresets.PRESETS[n].get("family") != "coca"]
REFUSED = sorted(set(jpresets.preset_names()) - set(BUILT))


def test_all_62_names():
    assert presets.preset_names() == jpresets.preset_names()
    assert len(presets.preset_names()) == 62
    assert len(BUILT) == 58 and len(REFUSED) == 4
    assert all(n.startswith("coca") for n in REFUSED)
    assert presets.PRESETS == jpresets.PRESETS
    assert presets.OPENAI_DATASET_MEAN == jpresets.OPENAI_DATASET_MEAN
    assert presets.ENCODER_STATS == jpresets.ENCODER_STATS


@pytest.mark.parametrize("name", BUILT)
def test_built_presets_resolve_like_jax(name):
    r, j = presets.resolve(name), jpresets.resolve(name)
    for f in ("name", "family", "embed_dim", "vision_kind", "vision_proj",
              "text_kind", "quick_gelu"):
        assert getattr(r, f) == getattr(j, f), f
    for f in ("vision_cfg", "text_cfg"):
        a, b = getattr(r, f), getattr(j, f)
        assert type(a).__name__ == type(b).__name__, f
        assert dataclasses.asdict(a) == dataclasses.asdict(b), f
    for prop in ("mlp_dim", "num_features", "head_dim", "grid", "spatial",
                 "context_length", "mlp_hidden"):
        if hasattr(j.vision_cfg, prop):
            assert getattr(r.vision_cfg, prop) == getattr(j.vision_cfg, prop)
        if hasattr(j.text_cfg, prop):
            assert getattr(r.text_cfg, prop) == getattr(j.text_cfg, prop)
    try:
        want = jpresets.tokenizer_kind(name)
    except NotImplementedError as e:  # the HF text towers
        with pytest.raises(NotImplementedError) as got:
            presets.tokenizer_kind(name)
        assert str(got.value) == str(e)
    else:
        assert presets.tokenizer_kind(name) == want
    assert presets.preprocess_config(name) == configs.PreprocessConfig(
        **dataclasses.asdict(jpresets.preprocess_config(name)))


@pytest.mark.parametrize("name", REFUSED)
def test_other_presets_raise_naming_item_11(name):
    """The four CoCa presets, which raised naming ROADMAP item 11 until
    ``models.coca`` was ported, now resolve to the ``coca`` family and
    build and encode (shrunk to one block a stack; the published widths on
    the card, ``chip_smoke.py`` phase ``coca``; the JAX parity in
    ``tests/test_torch_coca.py``)."""
    from keep_tpu_torch.models.coca import CoCa

    r = presets.resolve(name)
    assert r.family == "coca"
    c = r.text_cfg
    small = dataclasses.replace(
        c, vision=dataclasses.replace(c.vision, img_size=64, depth=1),
        text_layers=1, decoder_layers=1, n_queries=4, vocab_size=64,
        hf_text=None if c.hf_text is None else dataclasses.replace(
            c.hf_text, trunk=dataclasses.replace(
                c.hf_text.trunk, num_hidden_layers=1, vocab_size=64)))
    m = presets.build_preset(dataclasses.replace(r, text_cfg=small),
                             device="cpu")
    assert isinstance(m, CoCa)
    px = torch.zeros(1, 64 // c.vision.patch_size * c.vision.patch_size,
                     64 // c.vision.patch_size * c.vision.patch_size, 3)
    with torch.no_grad():
        img = m.encode_image(px, normalize=True)
        txt = m.encode_text(torch.full((1, 8), 5), normalize=True)
    assert img.shape == txt.shape == (1, r.embed_dim)
    assert torch.isfinite(img).all() and torch.isfinite(txt).all()


def _shrink(r, img_patches=4, embed=32):
    """``r`` at 2 layers and 2 heads of its own head width (vision and
    text), a 4 × 4 patch grid, a 16-token context and a 100-id vocab."""
    v, t = r.vision_cfg, r.text_cfg
    v = dataclasses.replace(v, depth=2, num_heads=2,
                            embed_dim=2 * v.head_dim,
                            img_size=img_patches * v.patch_size)
    t = dataclasses.replace(t, layers=2, heads=2, width=2 * t.head_dim,
                            context_length=16, vocab_size=100,
                            output_dim=embed)
    return dataclasses.replace(r, vision_cfg=v, text_cfg=t, embed_dim=embed)


def _jax_resolved(r):
    return jpresets.ResolvedPreset(
        r.name, r.family, r.embed_dim, r.vision_kind,
        JViTConfig(**dataclasses.asdict(r.vision_cfg)), r.vision_proj,
        r.text_kind, JTextConfig(**dataclasses.asdict(r.text_cfg)),
        r.quick_gelu)


def _moved(params):
    """The init's unit LayerNorms and zero biases moved, so that every
    piece of the towers shows in the features."""
    rng = np.random.default_rng(3)
    params = jax.tree.map(np.array, params)

    def walk(node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v)
            elif k in ("scale", "bias", "b", "fc1_b"):
                node[k] = v + 0.1 * rng.standard_normal(v.shape).astype(
                    v.dtype)

    walk(params)
    return params


@pytest.mark.parametrize("name,kw", [
    ("ViT-H-14", {}), ("ViT-H-14", {"use_flash": True}), ("ViT-g-14", {}),
    ("EVA01-g-14", {}), ("vit_medium_patch16_gap_256", {})])
def test_shrunk_preset_matches_jax(monkeypatch, rng, name, kw):
    """The preset at its own head width (80, 88, 88, 64), shrunk: JAX's
    ``create_preset`` on the shrunk resolution (its Pallas kernel in
    interpret mode under ``use_flash``) and the port's ``build_preset`` on
    the same weights give the same features."""
    r = _shrink(presets.resolve(name))
    assert r.vision_cfg.head_dim == presets.resolve(name).vision_cfg.head_dim
    monkeypatch.setattr(jpresets, "resolve", lambda _: _jax_resolved(r))
    params, jmodel = jpresets.create_preset(name, seed=0)
    params = _moved(params)
    m = presets.build_preset(r, device="cpu")
    m.load_state_dict(from_jax_clip_params(params, 2, 2), strict=True)
    size = r.vision_cfg.img_size
    pixels = rng.standard_normal((2, size, size, 3), dtype=np.float32)
    ids = rng.integers(1, 99, size=(3, 16))
    ids[:, 9] = 99
    jx, jids = jnp.asarray(pixels), jnp.asarray(ids)
    tx, tids = torch.from_numpy(pixels), torch.from_numpy(ids)
    with torch.no_grad():
        np.testing.assert_allclose(
            m.encode_image(tx, **kw).numpy(),
            np.asarray(jmodel.encode_image(params, jx, **kw)), **TOL)
        np.testing.assert_allclose(
            m.encode_text(tids).numpy(),
            np.asarray(jmodel.encode_text(params, jids)), **TOL)
        out = m(tx, tids, **kw)
    ref = jmodel.forward(params, jx, jids, **kw)
    for k in ("image_features", "text_features"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), **TOL)
    assert float(out["logit_scale"]) == pytest.approx(
        float(ref["logit_scale"]), rel=1e-6)


def test_build_preset_draws_from_the_seed():
    """The same seed gives the same weights, another seed others; the JAX
    pytree's leaves are there."""
    r = _shrink(presets.resolve("ViT-B-32"))
    a = presets.build_preset(r, seed=1, device="cpu")
    b = presets.build_preset(r, seed=1, device="cpu")
    c = presets.build_preset(r, seed=2, device="cpu")
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
    assert not torch.equal(a.visual.patch_embed.weight,
                           c.visual.patch_embed.weight)
    assert {"visual.ln_pre.weight", "visual_head.proj", "text.text_projection",
            "logit_scale"} <= set(a.state_dict())


# ---- the factory (twins of tests/test_factory_cov.py) -----------------------

TINY_VIT = dict(img_size=32, patch_size=16, embed_dim=32, depth=1,
                num_heads=2)
TINY_BERT = dict(vocab_size=64, hidden_size=32, num_hidden_layers=1,
                 num_attention_heads=2, intermediate_size=64,
                 max_position_embeddings=32)


def test_list_models_merges_registry_and_presets():
    from keep_tpu import factory as jfactory

    names = factory.list_models()
    assert names == jfactory.list_models()
    assert "keep" in names and "ViT-B-32" in names
    assert names == sorted(names)


def test_keep_builder_with_overrides():
    m = factory.create_model("keep", device="cpu",
                             vision=configs.ViTConfig(**TINY_VIT),
                             text=configs.BertConfig(**TINY_BERT),
                             projection_dim=16)
    assert m.family == "keep" and m.config.vision.depth == 1
    with torch.no_grad():
        assert m.encode_image(torch.zeros(1, 32, 32, 3)).shape == (1, 16)


def test_clip_builders_with_overrides():
    tiny_tt = TextTransformerConfig(vocab_size=64, context_length=8,
                                    width=32, heads=2, layers=1,
                                    output_dim=32)
    for name in ("clip-vit-b-16", "clip-vit-l-14"):
        m = factory.create_model(name, device="cpu",
                                 vision=configs.ViTConfig(**TINY_VIT,
                                                          layerscale_init=None),
                                 text=tiny_tt, embed_dim=32)
        assert m.family == "clip"
        with torch.no_grad():
            assert m.encode_image(torch.zeros(1, 32, 32, 3)).shape == (1, 32)
            assert m.encode_text(torch.ones(2, 8, dtype=torch.long)
                                 ).shape == (2, 32)


def test_preset_passthrough():
    """The smallest real preset, ViT-B-32, at full size (the preset leg)."""
    m = factory.create_model("ViT-B-32", device="cpu")
    assert m.family == "clip" and m.config.name == "ViT-B-32"
    with torch.no_grad():
        assert m.encode_image(torch.zeros(1, 224, 224, 3)).shape == (1, 512)


def test_error_legs(tmp_path, monkeypatch):
    monkeypatch.setenv("KEEP_TPU_HOME", str(tmp_path / "home"))
    with pytest.raises(KeyError, match="unknown model"):
        factory.create_model("not-a-model", device="cpu")
    with pytest.raises(NotImplementedError, match="pretrained"):
        factory.create_model("coca", pretrained="x", device="cpu")
    with pytest.raises(ValueError, match="overrides"):
        factory.create_model("ViT-B-32", embed_dim=99, device="cpu")
    with pytest.raises(FileNotFoundError, match="no weights file"):
        factory.create_model("keep", pretrained=str(tmp_path), device="cpu")
    # the coca and pmc-clip entries build
    coca_m = factory.create_model("coca", device="cpu", text_layers=1,
                                  decoder_layers=1, vision=configs.ViTConfig(
                                      img_size=32, patch_size=16,
                                      embed_dim=64, depth=1, num_heads=1,
                                      layerscale_init=None, ln_eps=1e-5,
                                      pool="none"))
    assert coca_m.family == "coca" and len(coca_m.decoder.self_blocks) == 1
    pmc = factory.create_model("pmc-clip", device="cpu", fusion_layers=1)
    assert pmc.family == "pmc_clip" and len(pmc.fusion) == 1
    with torch.no_grad():
        assert coca_m.encode_image(torch.zeros(1, 32, 32, 3)).shape == (1,
                                                                         512)
        out = pmc(torch.zeros(1, 224, 224, 3), torch.full((1, 8), 2))
    assert out["text_features"].shape == (1, 768)
    # pretrained= goes through the local registry (compat.registry.fetch):
    # an unknown name raises naming the registry, a URL whose file is
    # missing fails to fetch
    import urllib.error

    for ref, err, match in (
            ("keep-vit-l16", KeyError, "unknown pretrained name"),
            ((tmp_path / "missing" / "keep.bin").as_uri(), urllib.error.URLError,
             "")):
        with pytest.raises(err, match=match):
            factory.create_model("keep", pretrained=ref, device="cpu")


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        factory.create_model("clip-vit-b-16")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        presets.create_preset("ViT-B-32")


def test_pretrained_dir_with_config_and_weights(tmp_path):
    """A released-layout directory written by the JAX package: its config
    (with the caller's overrides on top) and weights, features equal to
    the JAX model's; a weights file alone loads with the given config."""
    from keep_tpu.compat.export import save_pretrained
    from keep_tpu.configs import BertConfig as JBert
    from keep_tpu.configs import KEEPConfig as JKEEP
    from keep_tpu.models import keep as jkeep

    jc = JKEEP(vision=JViTConfig(**TINY_VIT), text=JBert(**TINY_BERT),
               projection_dim=16)
    params = jkeep.init(jax.random.PRNGKey(0), jc)
    d = tmp_path / "release"
    save_pretrained(str(d), params, jc)
    m = factory.create_model("keep", pretrained=str(d), device="cpu")
    assert m.config.projection_dim == 16 and m.config.vision.depth == 1
    x = np.zeros((1, 32, 32, 3), np.float32)
    x[0, :16] = 1.0
    ref = np.asarray(jkeep.encode_image(params, jnp.asarray(x), jc))
    with torch.no_grad():
        np.testing.assert_allclose(m.encode_image(torch.from_numpy(x)).numpy(),
                                   ref, atol=1e-5)
    m2 = factory.create_model("keep", pretrained=str(d), device="cpu",
                              max_text_length=17)
    assert m2.config.max_text_length == 17 and m2.config.projection_dim == 16
    m3 = factory.create_model("keep", pretrained=str(d / "pytorch_model.bin"),
                              device="cpu", vision=m.config.vision,
                              text=m.config.text, projection_dim=16)
    with torch.no_grad():
        np.testing.assert_allclose(
            m3.encode_image(torch.from_numpy(x)).numpy(), ref, atol=1e-5)


VOCAB = "\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]",
                   "an", "image", "of", "tumor", "##s", "a"])
MERGES = ["t u", "tu m", "tum or</w>", "o f</w>", "a n</w>"]


def test_get_tokenizer_bert_file_and_dir(tmp_path):
    vocab = tmp_path / "vocab.txt"
    vocab.write_text(VOCAB)
    for path in (str(vocab), str(tmp_path)):
        enc = factory.get_tokenizer("bert", path)(["an image of tumors"],
                                                  max_length=8)
        assert enc["input_ids"].shape == (1, 8) and enc["input_ids"][0, 0] == 2
    with pytest.raises(ValueError, match="unknown tokenizer kind"):
        factory.get_tokenizer("sentencepiece", "x")


def test_get_tokenizer_clip_matches_jax(tmp_path):
    from keep_tpu.text.bpe import BPETokenizer as JBPE

    merges = tmp_path / "merges.txt"
    merges.write_text("#version: 0.2\n" + "\n".join(MERGES) + "\n")
    tok = factory.get_tokenizer("clip", str(merges), context_length=16)
    ids = tok(["tumor of an"])
    assert ids.shape == (1, 16)
    np.testing.assert_array_equal(ids, JBPE(str(merges),
                                            context_length=16)(["tumor of an"]))

