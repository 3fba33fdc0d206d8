"""The port's HF text towers (``keep_tpu_torch.models.hf_text``, BERT with
``position_ids``) against the JAX package's on the CPU: RoBERTa's
positions from the padding equal JAX's; the RoBERTa tower with ragged
padding (mean pooler, MLP projection) at the JAX test's 3e-5 in fp32, with
the fused attention #1 too (the JAX side's Pallas kernel in interpret
mode) and at cosine ≥ 0.999 in bf16; the cls pooler with the linear and
with no projection; ``output_tokens``; the context-length legs;
``convert_hf_roberta`` against the JAX converter on one synthetic HF state
dict. Weights: the JAX ``init``'s (norms and biases moved), carried by
``compat.torch_loader.from_jax_tree``.

Also ROADMAP queue 3's "to check" item: at BERT-base width (2 layers,
bf16), how far the JAX package's Pallas #1 (interpret mode) sits from its
plain attention, beside the port's two routes on the same weights (on the
CPU the port's #1 is its plain version; ``chip_smoke.py``'s ``zoo_towers``
phase takes the card kernel's distance on the same seeded weights)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from keep_tpu.compat import torch_loader as jloader
from keep_tpu.configs import BertConfig as JBertConfig
from keep_tpu.models import bert as jbert
from keep_tpu.models import hf_text as jhf
from keep_tpu_torch.compat.torch_loader import from_jax_tree
from keep_tpu_torch.configs import BertConfig
from keep_tpu_torch.models import bert, hf_text
from torch_zoo import cos_min, moved

TOL = dict(atol=3e-5, rtol=3e-5)
TRUNK = dict(vocab_size=120, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=1, intermediate_size=128,
             max_position_embeddings=40, type_vocab_size=1, ln_eps=1e-5,
             pad_token_id=1)


def _cfgs(**kw):
    return (jhf.HFTextConfig(trunk=JBertConfig(**TRUNK), output_dim=16, **kw),
            hf_text.HFTextConfig(trunk=BertConfig(**TRUNK), output_dim=16,
                                 **kw))


def _pair(seed=0, **kw):
    jcfg, cfg = _cfgs(**kw)
    params = moved(jhf.init(jax.random.PRNGKey(seed), jcfg))
    m = hf_text.HFText(cfg)
    m.load_state_dict(from_jax_tree(params, lambda p: 2), strict=True)
    return params, m.eval(), jcfg


def _batch(rng):
    ids = rng.integers(4, 119, size=(3, 12))
    ids[0, 8:] = 1  # ragged: pads mid-batch move the mask and the positions
    ids[2, 5:] = 1
    return ids


def test_roberta_position_ids_match_jax(rng):
    ids = np.asarray([[5, 6, 1, 1], [1, 7, 8, 9]])
    got = hf_text.roberta_position_ids(torch.from_numpy(ids), 1)
    np.testing.assert_array_equal(got.numpy(), [[2, 3, 1, 1], [1, 2, 3, 4]])
    ids = _batch(rng)
    np.testing.assert_array_equal(
        hf_text.roberta_position_ids(torch.from_numpy(ids), 1).numpy(),
        np.asarray(jhf.roberta_position_ids(jnp.asarray(ids), 1)))


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("arch", ["roberta", "xlm-roberta"])
def test_roberta_matches_jax(rng, arch, use_flash):
    params, m, jcfg = _pair(arch=arch)
    ids = _batch(rng)
    with torch.no_grad():
        got = m(torch.from_numpy(ids), use_flash=use_flash)
        unit = m(torch.from_numpy(ids), normalize=True)
    ref = jhf.forward(params, jnp.asarray(ids), jcfg, use_flash=use_flash)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(unit.norm(dim=-1).numpy(), 1.0, atol=1e-6)


def test_bert_position_ids_default_is_unchanged(rng):
    """``position_ids`` = 0..S−1 gives the default's bits."""
    cfg = BertConfig(**TRUNK)
    m = bert.BertModel(cfg).init_weights(torch.Generator().manual_seed(0))
    ids = torch.from_numpy(_batch(rng))
    with torch.no_grad():
        a = m(ids)["last_hidden_state"]
        b = m(ids, position_ids=torch.arange(12).expand(3, 12))[
            "last_hidden_state"]
    assert torch.equal(a, b)


def test_roberta_bf16_matches_jax(rng):
    params, m, jcfg = _pair(1)
    ids = _batch(rng)
    with torch.no_grad():
        got = m(torch.from_numpy(ids), dtype=torch.bfloat16)
    ref = jhf.forward(params, jnp.asarray(ids), jcfg, dtype=jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    assert cos_min(got, np.asarray(ref.astype(jnp.float32))) >= 0.999


@pytest.mark.parametrize("pooler,proj", [("cls", "linear"), ("cls", "none"),
                                         ("mean", "linear")])
def test_poolers_and_projections_match_jax(rng, pooler, proj):
    params, m, jcfg = _pair(2, pooler=pooler, proj=proj)
    ids = _batch(rng)
    with torch.no_grad():
        got, tokens = m(torch.from_numpy(ids), output_tokens=True)
    ref, ref_tokens = jhf.forward(params, jnp.asarray(ids), jcfg,
                                  output_tokens=True)
    assert got.shape == ((3, 16) if proj != "none" else (3, 64))
    assert tokens.shape == (3, 11 if pooler == "cls" else 12, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(tokens.numpy(), np.asarray(ref_tokens), **TOL)


def test_context_length_legs_and_unknown_pooler(rng):
    jcfg, cfg = _cfgs()
    assert cfg.context_length == jcfg.context_length == 40 - 1 - 1
    for arch in ("bert", "mt5"):
        assert dataclasses.replace(cfg, arch=arch).context_length == \
            dataclasses.replace(jcfg, arch=arch).context_length
    _, m, _ = _pair()
    m.cfg = dataclasses.replace(m.cfg, pooler="max")
    with pytest.raises(ValueError, match="unknown pooler"):
        m(torch.from_numpy(_batch(rng)))


def _hf_roberta_sd(rng, cfg):
    d, f = cfg.hidden_size, cfg.intermediate_size
    r = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32) * 0.1)
    e = "embeddings."
    sd = {e + "word_embeddings.weight": r(cfg.vocab_size, d),
          e + "position_embeddings.weight": r(cfg.max_position_embeddings,
                                              d),
          e + "token_type_embeddings.weight": r(cfg.type_vocab_size, d),
          e + "LayerNorm.weight": r(d), e + "LayerNorm.bias": r(d),
          e + "position_ids": torch.arange(cfg.max_position_embeddings)[None],
          "pooler.dense.weight": r(d, d), "pooler.dense.bias": r(d)}
    for i in range(cfg.num_hidden_layers):
        p = f"encoder.layer.{i}."
        for n, shape in (("attention.self.query", (d, d)),
                         ("attention.self.key", (d, d)),
                         ("attention.self.value", (d, d)),
                         ("attention.output.dense", (d, d)),
                         ("intermediate.dense", (f, d)),
                         ("output.dense", (d, f)),
                         ("attention.output.LayerNorm", (d,)),
                         ("output.LayerNorm", (d,))):
            sd[p + n + ".weight"], sd[p + n + ".bias"] = r(*shape), \
                r(shape[0])
    return sd


@pytest.mark.parametrize("proj", ["mlp", "linear"])
def test_convert_hf_roberta_matches_jax(rng, proj):
    jcfg, cfg = _cfgs(proj=proj)
    sd = _hf_roberta_sd(rng, cfg.trunk)
    r = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32) * 0.1)
    proj_sd = ({"fc1": r(40, 64), "fc2": r(16, 40)} if proj == "mlp"
               else {"w": r(16, 64)})
    got = hf_text.convert_hf_roberta(sd, cfg, proj_sd)
    ref = from_jax_tree(jhf.convert_hf_roberta(sd, jcfg, proj_sd),
                        lambda p: 2)
    assert got.keys() == ref.keys()
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    hf_text.HFText(cfg).load_state_dict(got, strict=True)
    assert jloader.convert_hf_bert  # the JAX side's trunk converter


def test_bert_base_flash_bf16_distance():
    """ROADMAP queue 3's check: BERT-base width, 2 layers, bf16, the
    seeded weights and ragged ids of ``chip_smoke.bert_check_inputs``.
    The JAX package's Pallas #1 (interpret mode) against its plain
    attention, and the port's two routes on the same weights; each
    distance is printed (``-s``) and held at the repo's 0.999 gate."""
    cfg = BertConfig(num_hidden_layers=chip_smoke.BERT_CHECK["layers"])
    tree, ids, mask = chip_smoke.bert_check_inputs(cfg)
    jcfg = JBertConfig(**dataclasses.asdict(cfg))
    jtree = jax.tree.map(jnp.asarray, tree)
    out = {}
    for flash in (False, True):
        out[flash] = jbert.forward(jtree, jnp.asarray(ids), jnp.asarray(mask),
                                   cfg=jcfg, dtype=jnp.bfloat16,
                                   use_flash=flash)
    m = bert.BertModel(cfg)
    m.load_state_dict(from_jax_tree(tree, lambda p: 2), strict=True)
    with torch.no_grad():
        port = {flash: m(torch.from_numpy(ids), torch.from_numpy(mask),
                         dtype=torch.bfloat16, use_flash=flash)
                for flash in (False, True)}
    valid = mask.astype(bool)

    def rows(x, key):  # the pooled rows, or the unpadded hidden rows
        a = x[key].float().numpy() if isinstance(x[key], torch.Tensor) \
            else np.asarray(x[key], np.float32)
        return a[valid] if key == "last_hidden_state" else a

    for key in ("pooler_output", "last_hidden_state"):
        jd = cos_min(rows(out[True], key), rows(out[False], key))
        pd = cos_min(rows(port[True], key), rows(port[False], key))
        print(f"{key}: JAX Pallas #1 (interpret) vs plain, 1 − min cos "
              f"{1 - jd:.3e}; port (CPU: #1's plain version) vs plain "
              f"{1 - pd:.3e}")
        assert jd >= 0.999 and pd >= 0.999
    assert torch.equal(port[True]["pooler_output"],
                       port[False]["pooler_output"])
