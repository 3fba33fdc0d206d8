"""The port's KEP model and poolers (``keep_tpu_torch.models.kep``,
``.poolers``) against the JAX package's on the CPU: KEP with each image
tower (``vit``; ``rn_clip``; ``res_ssl``, its trunk installed from a
torchvision checkpoint by ``install_res_ssl``), its text and knowledge
PATH_BERTs and optional heads, every feature of ``forward`` at 2e-5 in
fp32 (the text towers through the fused attention #1 too, the JAX side's
Pallas kernel in interpret mode) and at cosine ≥ 0.999 in bf16, the JAX
``init``'s weights (norms and biases moved) carried by
``compat.torch_loader.from_jax_kep_params``; ``load_knowledge_bert`` from
one knowledge-BERT checkpoint; the four poolers on the same inputs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keep_tpu.configs import BertConfig as JBertConfig
from keep_tpu.configs import ViTConfig as JViTConfig
from keep_tpu.models import kep as jkep
from keep_tpu.models import poolers as jpoolers
from keep_tpu.models import resnet as jresnet
from keep_tpu_torch.compat.torch_loader import from_jax_kep_params
from keep_tpu_torch.configs import BertConfig, ViTConfig
from keep_tpu_torch.models import kep, poolers, resnet
from test_torch_resnet import _torchvision_sd
from torch_zoo import cos_min, moved

TOL = dict(atol=2e-5, rtol=2e-5)
VIT = dict(img_size=32, patch_size=8, embed_dim=32, depth=2, num_heads=2)
BERT = dict(vocab_size=60, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=1, intermediate_size=96,
            max_position_embeddings=32)
RN = dict(layers=(1, 2, 1, 1), width=16, image_size=64, heads=4,
          output_dim=32)


def _cfgs(encoder="vit", **kw):
    rn = encoder == "rn_clip"
    j = jkep.KEPConfig(vision=JViTConfig(**VIT), text=JBertConfig(**BERT),
                       embed_dim=24, image_encoder=encoder,
                       vision_rn=jresnet.ModifiedResNetConfig(**RN) if rn
                       else None, **kw)
    p = kep.KEPConfig(vision=ViTConfig(**VIT), text=BertConfig(**BERT),
                      embed_dim=24, image_encoder=encoder,
                      vision_rn=resnet.ModifiedResNetConfig(**RN) if rn
                      else None, **kw)
    return j, p


def _pair(encoder="vit", seed=0, **kw):
    jcfg, cfg = _cfgs(encoder, **kw)
    params = jkep.init(jax.random.PRNGKey(seed), jcfg)
    m = kep.KEPModel.init(cfg, torch.Generator().manual_seed(seed))
    if encoder == "res_ssl":
        sd = _torchvision_sd(np.random.default_rng(seed), (1, 1, 1, 1), 64)
        kep.install_res_ssl(m, sd)
        params["visual"] = jresnet.convert_torchvision_resnet(sd,
                                                              (1, 1, 1, 1))
    params = moved(params)
    m.load_state_dict(from_jax_kep_params(params, cfg), strict=True)
    return params, m.eval(), jcfg


def _inputs(rng, size):
    pixels = rng.standard_normal((2, size, size, 3), dtype=np.float32)
    ids = rng.integers(1, 60, size=(2, 16))
    ids[1, 9:] = 0
    return pixels, ids, (ids != 0).astype(np.int64)


@pytest.mark.parametrize("encoder,use_flash", [
    ("vit", False), ("vit", True), ("rn_clip", False), ("res_ssl", False)])
def test_kep_matches_jax(rng, encoder, use_flash):
    params, m, jcfg = _pair(encoder)
    size = 64 if encoder != "vit" else 32
    pixels, ids, mask = _inputs(rng, size)
    with torch.no_grad():
        out = m(torch.from_numpy(pixels), torch.from_numpy(ids),
                torch.from_numpy(mask), use_flash=use_flash)
    ref = jkep.forward(params, jnp.asarray(pixels), jnp.asarray(ids),
                       jnp.asarray(mask), cfg=jcfg, use_flash=use_flash)
    assert out.keys() == ref.keys()
    for k in ("image_features", "text_features", "knowledge_features"):
        assert out[k].shape == (2, 24)
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), **TOL)
    assert float(out["logit_scale"]) == pytest.approx(
        float(ref["logit_scale"]), rel=1e-6)


def test_kep_heads_and_no_knowledge(rng):
    """A text head, no visual head and no knowledge tower."""
    params, m, jcfg = _pair(seed=1, text_embedding_head=True,
                            visual_embedding_head=False,
                            with_knowledge=False)
    assert m.knowledge is None and m.visual_head is None
    pixels, ids, mask = _inputs(rng, 32)
    with torch.no_grad():
        out = m(torch.from_numpy(pixels), torch.from_numpy(ids),
                torch.from_numpy(mask))
    ref = jkep.forward(params, jnp.asarray(pixels), jnp.asarray(ids),
                       jnp.asarray(mask), cfg=jcfg)
    assert out.keys() == ref.keys()
    for k in ("image_features", "text_features"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), **TOL)
    with pytest.raises(ValueError, match="no knowledge tower"):
        m.encode_knowledge(torch.from_numpy(ids))


@pytest.mark.parametrize("encoder", ["vit", "rn_clip"])
def test_kep_bf16_matches_jax(rng, encoder):
    params, m, jcfg = _pair(encoder, seed=2)
    pixels, ids, mask = _inputs(rng, 64 if encoder == "rn_clip" else 32)
    with torch.no_grad():
        img = m.encode_image(torch.from_numpy(pixels), dtype=torch.bfloat16)
        txt = m.encode_text(torch.from_numpy(ids), torch.from_numpy(mask),
                            dtype=torch.bfloat16)
    jimg = jkep.encode_image(params, jnp.asarray(pixels), jcfg,
                             dtype=jnp.bfloat16)
    jtxt = jkep.encode_text(params, jnp.asarray(ids), jnp.asarray(mask),
                            jcfg, dtype=jnp.bfloat16)
    assert img.dtype == txt.dtype == torch.bfloat16
    assert cos_min(img, np.asarray(jimg.astype(jnp.float32))) >= 0.999
    assert cos_min(txt, np.asarray(jtxt.astype(jnp.float32))) >= 0.999


def test_res_ssl_placeholder_and_install(rng):
    """``init`` leaves the trunk an empty placeholder, as the JAX package's
    does; encoding raises until ``install_res_ssl`` puts one in, whose
    weights are the JAX converter's."""
    jcfg, cfg = _cfgs("res_ssl")
    assert jkep.init(jax.random.PRNGKey(0), jcfg)["visual"] == {}
    m = kep.KEPModel.init(cfg, torch.Generator().manual_seed(0))
    assert not any(k.startswith("visual.") for k in m.state_dict())
    with pytest.raises(ValueError, match="install_res_ssl"):
        m.encode_image(torch.zeros(1, 64, 64, 3))
    sd = _torchvision_sd(rng, (1, 1, 1, 1), 64)
    kep.install_res_ssl(m, sd)
    ref = from_jax_kep_params(
        {"visual": jresnet.convert_torchvision_resnet(sd, (1, 1, 1, 1))},
        cfg)
    got = {f"visual.{k}": v for k, v in m.visual.state_dict().items()}
    assert got.keys() == ref.keys()
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


def test_load_knowledge_bert_matches_jax(tmp_path, rng):
    """A knowledge-BERT checkpoint (``bert_model.*`` HF keys and
    ``mlp_embed.{0,2}``) into the knowledge tower: the tower then encodes
    as the JAX package's after its ``load_knowledge_bert``."""
    from test_torch_hf_text import _hf_roberta_sd

    jcfg, cfg = _cfgs()
    bert_sd = _hf_roberta_sd(rng, dataclasses.replace(
        cfg.text, type_vocab_size=2))
    r = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32) * 0.1)
    sd = {"state_dict": {**{f"bert_model.{k}": v
                            for k, v in bert_sd.items()},
                         "mlp_embed.0.weight": r(24, 64),
                         "mlp_embed.0.bias": r(24),
                         "mlp_embed.2.weight": r(24, 24),
                         "mlp_embed.2.bias": r(24)}}
    path = str(tmp_path / "knowledge.pt")
    torch.save(sd, path)
    params = jkep.load_knowledge_bert(jkep.init(jax.random.PRNGKey(0), jcfg),
                                      path, jcfg, into="knowledge")
    m = kep.KEPModel.init(cfg, torch.Generator().manual_seed(0))
    kep.load_knowledge_bert(m, path, into="knowledge")
    _, ids, mask = _inputs(rng, 32)
    with torch.no_grad():
        got = m.encode_knowledge(torch.from_numpy(ids),
                                 torch.from_numpy(mask))
    ref = jkep.encode_knowledge(params, jnp.asarray(ids), jnp.asarray(mask),
                                jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_init_statistics():
    _, cfg = _cfgs()
    m = kep.KEPModel.init(cfg, torch.Generator().manual_seed(0))
    emb = m.text.mlp_embed.fc1.weight.detach()
    assert abs(emb.std().item() - 24 ** -0.5) < 0.15 * 24 ** -0.5
    head = m.visual_head.fc1.weight.detach()
    assert abs(head.std().item() - 0.01) < 0.0015
    assert float(m.logit_scale.detach()) == pytest.approx(np.log(1 / 0.04))
    assert m.family == "kep" and m.config is cfg


@pytest.mark.parametrize("name", ["mean_pooler", "max_pooler", "cls_pooler",
                                  "cls_last_hidden_state_pooler"])
def test_poolers_match_jax(rng, name):
    hidden = rng.standard_normal((2, 5, 4), dtype=np.float32)
    mask = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]])
    po = rng.standard_normal((2, 4), dtype=np.float32)
    got = poolers.get_pooler(name)(torch.from_numpy(hidden),
                                   torch.from_numpy(mask),
                                   torch.from_numpy(po))
    ref = jpoolers.get_pooler(name)(jnp.asarray(hidden), jnp.asarray(mask),
                                    jnp.asarray(po))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(KeyError, match="unknown pooler"):
        poolers.get_pooler("nope")
