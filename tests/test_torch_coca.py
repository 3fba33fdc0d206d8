"""The port's CoCa (``keep_tpu_torch.models.coca``) against the JAX
package's on the CPU: twins of ``tests/test_coca.py``'s CoCa cases on the
same tiny config, with the JAX ``coca.init`` weights (norms and biases
moved) carried by ``compat.torch_loader.from_jax_coca_params``. Latents
and logits at atol 1e-5 in fp32; greedy and beam captions token for
token; top-k and top-p draws held by the set of tokens JAX would allow at
each step (the port samples from a ``torch.Generator``); ``caption_loss``
/ ``coca_loss`` and their gradients against ``jax.grad``; the no-pool
route and ``coca_roberta``'s RoBERTa tower (its per-length stepper, #1's
plain version under ``use_flash``); the four presets' resolution and
build."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keep_tpu import presets as jpresets
from keep_tpu.configs import ViTConfig as JViTConfig
from keep_tpu.models import coca as jcoca
from keep_tpu_torch import configs, factory, presets
from keep_tpu_torch.compat.torch_loader import from_jax_coca_params
from keep_tpu_torch.models import coca
from torch_zoo import moved

TOL = dict(atol=1e-5, rtol=1e-5)
# tests/test_coca.py's config
JCFG = jcoca.CoCaConfig(
    embed_dim=32, vocab_size=64, context_length=12, text_width=32,
    text_heads=4, text_layers=2, decoder_layers=2, decoder_heads=4,
    n_queries=6, attn_pooler_heads=4,
    vision=JViTConfig(img_size=16, patch_size=8, embed_dim=32, depth=2,
                      num_heads=4, layerscale_init=None, ln_eps=1e-5,
                      pool="none"),
    sot_id=62, eos_id=63)


def to_port(jc):
    """A JAX ``CoCaConfig`` as the port's."""
    from keep_tpu_torch.models.hf_text import HFTextConfig

    kw = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)}
    kw["vision"] = configs.ViTConfig(**dataclasses.asdict(jc.vision))
    if jc.hf_text is not None:
        h = jc.hf_text
        kw["hf_text"] = HFTextConfig(
            arch=h.arch, trunk=configs.BertConfig(
                **dataclasses.asdict(h.trunk)),
            output_dim=h.output_dim, pooler=h.pooler, proj=h.proj)
    return coca.CoCaConfig(**kw)


def pair(jc=JCFG, seed=0):
    """(JAX params with their norms and biases moved, the port's model on
    the same weights)."""
    params = moved(jcoca.init(jax.random.PRNGKey(seed), jc))
    cfg = to_port(jc)
    m = coca.CoCa(cfg)
    m.load_state_dict(from_jax_coca_params(params, cfg), strict=True)
    return jax.tree.map(jnp.asarray, params), m.eval()


@pytest.fixture(scope="module")
def models():
    return pair()


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _inputs(rng, b=2, s=12):
    px = rng.standard_normal((b, 16, 16, 3), dtype=np.float32)
    ids = rng.integers(1, 60, size=(b, s))
    ids[0, -3:] = 0  # a padded row: the CLS row masks its pads
    return px, ids


def test_forward_matches_jax(models, rng):
    params, m = models
    px, ids = _inputs(rng)
    j = jax.jit(lambda p, x, i: jcoca.forward(p, x, i, JCFG))(
        params, jnp.asarray(px), jnp.asarray(ids))
    with torch.no_grad():
        out = m(torch.from_numpy(px), torch.from_numpy(ids))
    assert out["logits"].shape == (2, 11, 64)
    for k in ("image_features", "text_features", "logits", "logit_scale"):
        np.testing.assert_allclose(_np(out[k]), _np(j[k]), **TOL, err_msg=k)
    np.testing.assert_array_equal(out["labels"].numpy(), np.asarray(
        j["labels"]))
    np.testing.assert_allclose(
        np.linalg.norm(_np(out["image_features"]), axis=1), 1.0, atol=1e-5)


def test_token_streams_match_jax(models, rng):
    """``encode_*_tokens`` are the JAX ``encode_image`` / ``encode_text``:
    (latent, tokens), the latter untrimmed with ``embed_cls=False``."""
    params, m = models
    px, ids = _inputs(rng)
    for embed_cls in (True, False):
        jl, jt = jcoca.encode_text(params, jnp.asarray(ids), JCFG,
                                   embed_cls=embed_cls)
        with torch.no_grad():
            pl, pt = m.encode_text_tokens(torch.from_numpy(ids),
                                          embed_cls=embed_cls)
        np.testing.assert_allclose(_np(pl), _np(jl), **TOL)
        np.testing.assert_allclose(_np(pt), _np(jt), **TOL)
    jl, jt = jcoca.encode_image(params, jnp.asarray(px), JCFG)
    with torch.no_grad():
        pl, pt = m.encode_image_tokens(torch.from_numpy(px))
    assert pt.shape == (2, JCFG.n_queries - 1, 32)
    np.testing.assert_allclose(_np(pt), _np(jt), **TOL)
    with torch.no_grad():
        assert torch.equal(m.encode_image(torch.from_numpy(px)), pl)


def test_decoder_causality(models, rng):
    """Changing a future token moves no earlier logit (twin)."""
    _, m = models
    px = torch.from_numpy(rng.standard_normal((1, 16, 16, 3),
                                              dtype=np.float32))
    ids = rng.integers(1, 60, size=(1, 12))
    ids2 = ids.copy()
    ids2[0, 8] = (ids2[0, 8] + 7) % 60 + 1
    with torch.no_grad():
        a = m(px, torch.from_numpy(ids))["logits"].numpy()
        b = m(px, torch.from_numpy(ids2))["logits"].numpy()
    np.testing.assert_allclose(a[0, :8], b[0, :8], atol=1e-5)
    assert np.abs(a[0, 8:] - b[0, 8:]).max() > 1e-6


def test_image_conditioning(models, rng):
    """Another image changes the caption logits: cross-attention works."""
    _, m = models
    ids = torch.from_numpy(rng.integers(1, 60, size=(1, 12)))
    with torch.no_grad():
        l1, l2 = (m(torch.from_numpy(rng.standard_normal(
            (1, 16, 16, 3), dtype=np.float32)), ids)["logits"]
            for _ in range(2))
    assert (l1 - l2).abs().max() > 1e-5


@pytest.mark.parametrize("kw", [dict(seq_len=8),
                                dict(seq_len=6, min_seq_len=6),
                                dict(seq_len=8, repetition_penalty=10.0)])
def test_generate_greedy_matches_jax(models, rng, kw):
    """Greedy captions token for token, with the knobs of
    ``test_generate_knobs``: EOS suppressed below ``min_seq_len``, the
    repetition penalty."""
    params, m = models
    px = rng.standard_normal((2, 16, 16, 3), dtype=np.float32)
    want = jcoca.generate(params, jnp.asarray(px), JCFG, **kw)
    got = coca.generate(m, torch.from_numpy(px), **kw)
    np.testing.assert_array_equal(got, want)
    assert (got[:, 0] == JCFG.sot_id).all()
    if kw.get("min_seq_len"):
        assert not (got[:, 1:5] == JCFG.eos_id).any()


def test_generate_beam_matches_jax(models, rng):
    params, m = models
    px = rng.standard_normal((2, 16, 16, 3), dtype=np.float32)
    want = jcoca.generate_beam(params, jnp.asarray(px), JCFG, seq_len=7,
                               num_beams=3)
    got = coca.generate_beam(m, torch.from_numpy(px), seq_len=7, num_beams=3)
    np.testing.assert_array_equal(got, want)


def _allowed(step, ids, kind, k_or_p):
    """The tokens JAX's ``generate`` may draw after ``ids`` (``step``, its
    stepper's logits; its top-k threshold or its nucleus)."""
    logits = step(ids.astype(np.int32))
    if kind == "top_k":
        kth = np.sort(logits, axis=-1)[:, -k_or_p][:, None]
        return logits >= kth
    order = np.argsort(-logits, axis=-1)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    sp = np.take_along_axis(probs, order, axis=-1)
    drop_sorted = (np.cumsum(sp, axis=-1) - sp) > k_or_p
    drop_sorted[:, 0] = False
    drop = np.zeros_like(drop_sorted)
    np.put_along_axis(drop, order, drop_sorted, axis=-1)
    return ~drop


@pytest.mark.parametrize("kind,k_or_p", [("top_k", 8), ("top_p", 0.5)])
def test_sampling_draws_within_jax_sets(models, rng, kind, k_or_p):
    """Every sampled token lies in the set JAX's top-k / nucleus allows
    after the same prefix; two generators give different captions."""
    params, m = models
    px = rng.standard_normal((1, 16, 16, 3), dtype=np.float32)
    kw = dict(top_k=k_or_p) if kind == "top_k" else dict(top_p=k_or_p)
    caps = [coca.generate(m, torch.from_numpy(px), seq_len=8,
                          generation_type=kind,
                          generator=torch.Generator().manual_seed(s), **kw)
            for s in (1, 2, 3)]
    _, embs = jcoca.encode_image(params, jnp.asarray(px), JCFG)
    step = jcoca._make_stepper(params, JCFG, embs, jnp.float32)
    for cap in caps:
        for t in range(1, cap.shape[1]):
            ok = _allowed(step, cap[:, :t], kind, k_or_p)
            assert ok[0, cap[0, t]], (t, cap)
    assert any(a.shape != caps[0].shape or (a != caps[0]).any()
               for a in caps[1:])


def test_top_p_is_hf_nucleus_semantics():
    """``top_p_drop`` keeps the smallest prefix whose mass reaches top_p
    (twin of the JAX test, on the port's function)."""
    logits = np.log(np.array([[0.5, 0.3, 0.15, 0.05]]))
    np.testing.assert_array_equal(~coca.top_p_drop(logits, 0.9)[0],
                                  [True, True, True, False])
    np.testing.assert_array_equal(~coca.top_p_drop(logits, 0.1)[0],
                                  [True, False, False, False])


def test_caption_loss_masks_padding(rng):
    logits = rng.standard_normal((2, 5, 10), dtype=np.float32)
    labels = np.array([[1, 2, 3, 0, 0], [4, 5, 6, 7, 8]])
    want = float(jcoca.caption_loss(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(coca.caption_loss(torch.from_numpy(logits),
                                  torch.from_numpy(labels)))
    assert got == pytest.approx(want, rel=1e-6)


def test_coca_loss_and_grads_match_jax(models, rng):
    """The composite objective and its gradients (every parameter) against
    ``jax.grad`` of the JAX ``coca_loss`` over ``coca.forward``."""
    params, m = models
    px, ids = _inputs(rng, b=4)

    def jloss(p):
        return jcoca.coca_loss(jcoca.forward(p, jnp.asarray(px),
                                             jnp.asarray(ids), JCFG),
                               pad_id=JCFG.pad_id)

    jval, jgrads = jax.jit(jax.value_and_grad(jloss))(params)
    m.zero_grad()
    out = m(torch.from_numpy(px), torch.from_numpy(ids))
    loss = coca.coca_loss(out, pad_id=JCFG.pad_id)
    loss.backward()
    assert loss.item() == pytest.approx(float(jval), rel=1e-5)
    l0 = coca.coca_loss(out, caption_weight=0.0)
    cap = coca.caption_loss(out["logits"], out["labels"])
    assert coca.coca_loss(out, caption_weight=2.0).item() == pytest.approx(
        l0.item() + 2.0 * cap.item(), rel=1e-5)
    want = from_jax_coca_params(jax.tree.map(np.asarray, jgrads), m.cfg)
    for name, p in m.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name], atol=2e-5,
                                   rtol=1e-3, err_msg=name)


def test_no_pool_decoder_context_is_raw_tokens(rng):
    """Without the pooler the context is the trunk's raw patch tokens and
    ``ln_post`` takes the CLS alone (twin), against JAX."""
    jc = dataclasses.replace(JCFG, use_attn_pool=False)
    params, m = pair(jc, seed=3)
    px = rng.standard_normal((2, 16, 16, 3), dtype=np.float32)
    jl, jt = jcoca.encode_image(params, jnp.asarray(px), jc)
    with torch.no_grad():
        pl, pt = m.encode_image_tokens(torch.from_numpy(px))
        raw = m.visual(torch.from_numpy(px))
    np.testing.assert_allclose(_np(pl), _np(jl), **TOL)
    np.testing.assert_allclose(_np(pt), _np(jt), **TOL)
    assert torch.equal(pt, raw[:, 1:])


def _shrunk(name):
    """``name``'s resolution at 2 blocks a stack, narrow widths."""
    r = jpresets.resolve(name)
    c = r.text_cfg
    v = dataclasses.replace(c.vision, img_size=32, patch_size=16,
                            embed_dim=32, depth=2, num_heads=2)
    kw = dict(vision=v, embed_dim=32, vocab_size=64, text_width=32,
              text_heads=2, text_layers=2, decoder_layers=2,
              decoder_heads=2, n_queries=5, attn_pooler_heads=2,
              context_length=12, sot_id=62, eos_id=63)
    if c.hf_text is not None:
        h = c.hf_text
        kw.update(hf_text=dataclasses.replace(
            h, output_dim=32, trunk=dataclasses.replace(
                h.trunk, vocab_size=64, hidden_size=32, num_hidden_layers=2,
                num_attention_heads=2, intermediate_size=64,
                max_position_embeddings=40)),
            sot_id=0, eos_id=2)
    return dataclasses.replace(c, **kw)


def test_roberta_tower_matches_jax(rng):
    """``coca_roberta-ViT-B-32``'s route, shrunk: the RoBERTa token tower
    (mean-pooled latent, raw hidden states to the decoder; #1's plain
    version under ``use_flash``) and no pooler; forward at 1e-5, greedy
    captions through the per-length stepper token for token."""
    jc = _shrunk("coca_roberta-ViT-B-32")
    params, m = pair(jc, seed=5)
    px = rng.standard_normal((2, 32, 32, 3), dtype=np.float32)
    ids = rng.integers(3, 60, size=(2, 10))
    ids[1, -4:] = 1  # RoBERTa's pad
    j = jax.jit(lambda p, x, i: jcoca.forward(p, x, i, jc))(
        params, jnp.asarray(px), jnp.asarray(ids))
    for flash in (False, True):
        with torch.no_grad():
            out = m(torch.from_numpy(px), torch.from_numpy(ids),
                    use_flash=flash)
        for k in ("image_features", "text_features", "logits"):
            np.testing.assert_allclose(_np(out[k]), _np(j[k]), **TOL,
                                       err_msg=k)
    want = jcoca.generate(params, jnp.asarray(px), jc, seq_len=6)
    np.testing.assert_array_equal(
        coca.generate(m, torch.from_numpy(px), seq_len=6), want)


@pytest.mark.parametrize("name", [n for n in jpresets.PRESETS
                                  if n.startswith("coca")])
def test_presets_resolve_as_jax(name):
    """Each of the four CoCa presets resolves field for field as the JAX
    ``resolve`` (the pooler's heads from the vision config, coca_base
    without a pooler, coca_roberta's tower and ids), with the same
    tokenizer kind (or refusal) and eval transform."""
    r, jr = presets.resolve(name), jpresets.resolve(name)
    assert (r.family, r.embed_dim, r.vision_kind, r.text_kind) == (
        jr.family, jr.embed_dim, jr.vision_kind, jr.text_kind)
    assert r.text_cfg == to_port(jr.text_cfg)
    assert r.vision_cfg == r.text_cfg.vision
    try:
        want = jpresets.tokenizer_kind(name)
    except NotImplementedError as e:  # coca_roberta's HF tokenizer
        with pytest.raises(NotImplementedError) as got:
            presets.tokenizer_kind(name)
        assert str(got.value) == str(e)
    else:
        assert presets.tokenizer_kind(name) == want
    assert presets.preprocess_config(name) == configs.PreprocessConfig(
        **dataclasses.asdict(jpresets.preprocess_config(name)))


def test_shrunk_preset_builds_and_encodes_latents():
    """The uniform preset surface (twin of
    ``test_preset_coca_encode_returns_latent_array``): ``build_preset`` of
    a CoCa resolution gives a ``CoCa`` whose ``encode_image`` /
    ``encode_text`` return [B, E] unit rows; the factory's ``coca`` entry
    builds with overrides."""
    r = presets.resolve("coca_ViT-B-32")
    r = dataclasses.replace(r, text_cfg=to_port(_shrunk("coca_ViT-B-32")))
    m = presets.build_preset(r, device="cpu")
    assert isinstance(m, coca.CoCa) and m.family == "coca"
    with torch.no_grad():
        img = m.encode_image(torch.zeros(1, 32, 32, 3), normalize=True)
        txt = m.encode_text(torch.ones(2, 12, dtype=torch.long),
                            normalize=True)
    assert img.shape == (1, 32) and txt.shape == (2, 32)
    np.testing.assert_allclose(txt.norm(dim=-1).numpy(), 1.0, atol=1e-5)
    f = factory.create_model("coca", device="cpu", text_layers=1,
                             decoder_layers=1, vision=to_port(JCFG).vision)
    assert isinstance(f, coca.CoCa) and len(f.text.blocks) == 1
