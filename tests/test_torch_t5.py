"""The port's T5 / mT5 encoder (``keep_tpu_torch.models.t5``) against the
JAX package's on the CPU: the relative-position buckets equal JAX's (the
exact and the log-bucketed range); the encoder with padded rows at the JAX
test's 5e-5 in fp32 and at cosine ≥ 0.999 in bf16; the mT5 text tower
through ``models.hf_text``; ``convert_hf_t5_encoder`` against the JAX
converter on one synthetic HF state dict (gated and ReLU feed-forwards).
Weights: the JAX ``init``'s (RMSNorm gains moved), carried by
``compat.torch_loader.from_jax_tree``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keep_tpu.models import hf_text as jhf
from keep_tpu.models import t5 as jt5
from keep_tpu_torch.compat.torch_loader import from_jax_tree
from keep_tpu_torch.models import hf_text, t5
from torch_zoo import cos_min, moved

TOL = dict(atol=5e-5, rtol=5e-5)
SHAPE = dict(vocab_size=100, d_model=32, d_kv=8, num_heads=4, d_ff=64,
             num_layers=2)


def _pair(seed=0, **kw):
    jcfg, cfg = jt5.T5EncoderConfig(**SHAPE, **kw), \
        t5.T5EncoderConfig(**SHAPE, **kw)
    params = moved(jt5.init(jax.random.PRNGKey(seed), jcfg))
    m = t5.T5Encoder(cfg)
    m.load_state_dict(from_jax_tree(params, lambda p: 2), strict=True)
    return params, m.eval(), jcfg


def _ids(rng):
    ids = rng.integers(3, 99, size=(2, 11))
    ids[1, 6:] = 0  # padded row
    return ids


def test_relative_position_buckets_match_jax():
    for n in (9, 200):
        np.testing.assert_array_equal(
            t5.relative_position_buckets(n, n, 32, 128),
            jt5.relative_position_buckets(n, n, 32, 128))


@pytest.mark.parametrize("gated", [True, False])
def test_t5_encoder_matches_jax(rng, gated):
    params, m, jcfg = _pair(gated_ff=gated)
    ids = _ids(rng)
    with torch.no_grad():
        got = m(torch.from_numpy(ids))["last_hidden_state"]
    ref = jt5.forward(params, jnp.asarray(ids), cfg=jcfg)["last_hidden_state"]
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), **TOL)
    np.testing.assert_allclose(got[1, :6].numpy(), np.asarray(ref[1, :6]),
                               **TOL)


def test_t5_bf16_matches_jax(rng):
    params, m, jcfg = _pair(1)
    ids = _ids(rng)
    with torch.no_grad():
        got = m(torch.from_numpy(ids), dtype=torch.bfloat16)[
            "last_hidden_state"]
    ref = jt5.forward(params, jnp.asarray(ids), cfg=jcfg,
                      dtype=jnp.bfloat16)["last_hidden_state"]
    assert got.dtype == torch.bfloat16
    assert cos_min(got[0], np.asarray(ref[0].astype(jnp.float32))) >= 0.999


def test_mt5_tower_through_hf_text_matches_jax(rng):
    jcfg = jhf.HFTextConfig(arch="mt5", trunk=jt5.T5EncoderConfig(**SHAPE),
                            output_dim=16, pooler="mean", proj="mlp")
    cfg = hf_text.HFTextConfig(arch="mt5", trunk=t5.T5EncoderConfig(**SHAPE),
                               output_dim=16, pooler="mean", proj="mlp")
    params = moved(jhf.init(jax.random.PRNGKey(0), jcfg))
    m = hf_text.HFText(cfg)
    m.load_state_dict(from_jax_tree(params, lambda p: 2), strict=True)
    ids = _ids(rng)
    with torch.no_grad():
        got = m.eval()(torch.from_numpy(ids), normalize=True)
    ref = jhf.forward(params, jnp.asarray(ids), jcfg, normalize=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("gated", [True, False])
def test_convert_hf_t5_encoder_matches_jax(rng, gated):
    jcfg = jt5.T5EncoderConfig(**SHAPE, gated_ff=gated)
    cfg = t5.T5EncoderConfig(**SHAPE, gated_ff=gated)
    d, di, f = cfg.d_model, cfg.inner_dim, cfg.d_ff
    r = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32) * 0.1)
    sd = {"shared.weight": r(cfg.vocab_size, d),
          "encoder.final_layer_norm.weight": r(d),
          "encoder.block.0.layer.0.SelfAttention.relative_attention_bias"
          ".weight": r(cfg.rel_buckets, cfg.num_heads)}
    for i in range(cfg.num_layers):
        p = f"encoder.block.{i}.layer."
        sd[p + "0.layer_norm.weight"], sd[p + "1.layer_norm.weight"] = \
            r(d), r(d)
        for n in ("q", "k", "v"):
            sd[p + f"0.SelfAttention.{n}.weight"] = r(di, d)
        sd[p + "0.SelfAttention.o.weight"] = r(d, di)
        for n in (("wi_0", "wi_1") if gated else ("wi",)):
            sd[p + f"1.DenseReluDense.{n}.weight"] = r(f, d)
        sd[p + "1.DenseReluDense.wo.weight"] = r(d, f)
    got = t5.convert_hf_t5_encoder(sd, cfg)
    ref = from_jax_tree(jt5.convert_hf_t5_encoder(sd, jcfg), lambda p: 2)
    assert got.keys() == ref.keys()
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    t5.T5Encoder(cfg).load_state_dict(got, strict=True)
    # the encoder-only checkpoints' embedding key
    sd["encoder.embed_tokens.weight"] = sd.pop("shared.weight")
    assert torch.equal(t5.convert_hf_t5_encoder(sd, cfg)["embed"],
                       got["embed"])


def test_init_statistics():
    cfg = t5.T5EncoderConfig(**dict(SHAPE, vocab_size=4000))
    m = t5.T5Encoder(cfg).init_weights(torch.Generator().manual_seed(0))
    assert abs(m.embed.detach().std().item() - 1.0) < 0.02
    q = m.blocks[0].attn.q.detach()
    assert abs(q.std().item() - (32 * 8) ** -0.5) < 0.2 * (32 * 8) ** -0.5
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jt5.T5EncoderConfig(**dict(SHAPE, vocab_size=4000)))
