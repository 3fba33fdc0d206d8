"""The port's PMC-CLIP (``keep_tpu_torch.models.pmc_clip``) against the
JAX package's on the CPU: twins of ``tests/test_coca.py``'s
``test_pmc_clip_forward`` and ``test_pmc_clip_cls_position`` on the same
configs, with the JAX ``pmc_clip.init`` weights (norms, biases and the
BatchNorm statistics moved) carried by ``from_jax_pmc_params``: both
features, the MLM log-probs and ``mlm_loss`` at 1e-5 in fp32 (the JAX
tests' tolerance), the BERT tower through #1's plain version under
``use_flash`` (a zero key bias: the text is encoded unmasked), its
gradients against ``jax.grad``, and the ``pmc-clip`` factory entry."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keep_tpu.configs import BertConfig as JBertConfig
from keep_tpu.models import pmc_clip as jpmc
from keep_tpu.models.resnet import ModifiedResNetConfig as JRNConfig
from keep_tpu_torch import configs, factory
from keep_tpu_torch.compat.torch_loader import from_jax_pmc_params
from keep_tpu_torch.models import pmc_clip
from keep_tpu_torch.models.resnet import ModifiedResNetConfig
from torch_zoo import moved

TOL = dict(atol=1e-5, rtol=1e-5)
# tests/test_coca.py's configs
FORWARD = jpmc.PMCCLIPConfig(
    embed_dim=32,
    vision=JRNConfig(layers=(1, 1, 1, 1), width=8, image_size=64, heads=4,
                     output_dim=32),
    text=JBertConfig(vocab_size=64, hidden_size=32, num_hidden_layers=2,
                     num_attention_heads=4, intermediate_size=64,
                     max_position_embeddings=80),
    fusion_layers=2, fusion_heads=4, context_length=16, cls_id=2)
CLS = jpmc.PMCCLIPConfig(
    embed_dim=16,
    vision=JRNConfig(layers=(1, 1, 1, 1), width=8, image_size=64, heads=4,
                     output_dim=16),
    text=JBertConfig(vocab_size=32, hidden_size=16, num_hidden_layers=1,
                     num_attention_heads=2, intermediate_size=32,
                     max_position_embeddings=32),
    fusion_layers=1, fusion_heads=2, cls_id=2, mlm=False)


def to_port(jc):
    kw = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc)}
    kw["vision"] = ModifiedResNetConfig(**dataclasses.asdict(jc.vision))
    kw["text"] = configs.BertConfig(**dataclasses.asdict(jc.text))
    return pmc_clip.PMCCLIPConfig(**kw)


def pair(jc, seed=0):
    params = moved(jpmc.init(jax.random.PRNGKey(seed), jc))
    cfg = to_port(jc)
    m = pmc_clip.PMCCLIP(cfg)
    m.load_state_dict(from_jax_pmc_params(params, cfg), strict=True)
    return jax.tree.map(jnp.asarray, params), m.eval()


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _inputs(rng):
    px = rng.standard_normal((2, 64, 64, 3), dtype=np.float32)
    ids = rng.integers(3, 64, size=(2, 16))
    ids[:, 0] = 2  # [CLS]
    ids[1, -5:] = 0  # pads, which attend
    return px, ids


@pytest.mark.parametrize("use_flash", [False, True])
def test_pmc_clip_forward_matches_jax(rng, use_flash):
    params, m = pair(FORWARD)
    px, ids = _inputs(rng)
    mask = (ids != 0).astype(np.int32)
    j = jax.jit(lambda p, x, i, k: jpmc.forward(p, x, i, k, FORWARD))(
        params, jnp.asarray(px), jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        out = m(torch.from_numpy(px), torch.from_numpy(ids),
                torch.from_numpy(mask), use_flash=use_flash)
    assert out["bert_prediction"].shape == (2, 16, 64)
    for k in ("image_features", "text_features", "bert_prediction",
              "logit_scale"):
        np.testing.assert_allclose(_np(out[k]), _np(j[k]), **TOL, err_msg=k)
    np.testing.assert_allclose(out["bert_prediction"].exp().sum(-1).numpy(),
                               1.0, atol=1e-4)
    labels = np.zeros((2, 16), np.int64)
    labels[:, 3] = 7
    labels[1, 9] = 11
    want = float(jpmc.mlm_loss(j["bert_prediction"], jnp.asarray(labels)))
    got = pmc_clip.mlm_loss(out["bert_prediction"], torch.from_numpy(labels))
    assert got.item() == pytest.approx(want, rel=1e-5) and want > 0


def test_pmc_clip_cls_position_matches_jax(rng):
    """Text features follow the first [CLS], wherever it is (twin)."""
    params, m = pair(CLS, seed=1)
    img = rng.standard_normal((1, 16), dtype=np.float32)
    ids = rng.integers(3, 32, size=(1, 8))
    ids[0, 5] = 2
    mask = np.ones((1, 8), np.int32)
    j = jpmc.encode_text(params, jnp.asarray(ids), jnp.asarray(mask),
                         jnp.asarray(img), CLS)
    with torch.no_grad():
        out = m.encode_text(torch.from_numpy(ids), torch.from_numpy(mask),
                            torch.from_numpy(img))
        hid = m.text(torch.from_numpy(ids))["last_hidden_state"]
    assert out["bert_prediction"] is None and j["bert_prediction"] is None
    np.testing.assert_allclose(_np(out["text_features"]),
                               _np(j["text_features"]), **TOL)
    np.testing.assert_allclose(
        _np(out["text_features"])[0],
        _np(hid)[0, 5] @ _np(m.text_projection), **TOL)


def test_mlm_loss_grads_match_jax(rng):
    """The MLM objective's gradients through the fusion module and both
    towers against ``jax.grad``."""
    params, m = pair(FORWARD, seed=2)
    px, ids = _inputs(rng)
    labels = np.zeros((2, 16), np.int64)
    labels[:, 4] = 9

    def jloss(p):
        out = jpmc.forward(p, jnp.asarray(px), jnp.asarray(ids), None,
                           FORWARD)
        return jpmc.mlm_loss(out["bert_prediction"], jnp.asarray(labels))

    jgrads = jax.jit(jax.grad(jloss))(params)
    m.train()
    out = m(torch.from_numpy(px), torch.from_numpy(ids))
    pmc_clip.mlm_loss(out["bert_prediction"],
                      torch.from_numpy(labels)).backward()
    want = from_jax_pmc_params(jax.tree.map(np.asarray, jgrads), m.cfg)
    for name, p in m.named_parameters():
        if p.grad is None:  # off the MLM path: the pooler, projections, scale
            assert not want[name].abs().any(), name
            continue
        np.testing.assert_allclose(p.grad.numpy(), want[name], atol=2e-5,
                                   rtol=1e-3, err_msg=name)


def test_factory_builds_pmc_clip():
    """``create_model("pmc-clip")`` builds (overrides shrink it) and
    refuses an embed width unlike the text tower's, as the JAX init."""
    m = factory.create_model("pmc-clip", device="cpu",
                             **dataclasses.asdict(to_port(FORWARD)) | {
                                 "vision": to_port(FORWARD).vision,
                                 "text": to_port(FORWARD).text})
    assert isinstance(m, pmc_clip.PMCCLIP) and m.family == "pmc_clip"
    with torch.no_grad():
        out = m(torch.zeros(1, 64, 64, 3), torch.full((1, 16), 2))
    assert out["image_features"].shape == (1, 32)
    with pytest.raises(ValueError, match="embed_dim"):
        pmc_clip.PMCCLIP(dataclasses.replace(to_port(FORWARD), embed_dim=16))
