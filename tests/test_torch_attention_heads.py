"""The port's attention over split q, k, v (``attention_qkv_heads``,
``flash_attention``, ``mha_attention(use_flash=True)``; plain path on CPU
tensors) against the JAX package's Pallas kernel (interpret mode on the
CPU), at the shapes and tolerances of ``tests/test_flash_attention.py``:
fp32 at 2e-5, bf16 at max |Δ| < 0.05."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keep_tpu.kernels.flash_attention import attention_qkv_heads as j_heads
from keep_tpu.kernels.flash_attention import flash_attention as j_flash
from keep_tpu.ops import nn as jnn
from keep_tpu_torch.kernels import flash_attention as fa
from keep_tpu_torch.ops import nn


def _qkv(rng, *shape):
    return [rng.standard_normal(shape, dtype=np.float32) for _ in range(3)]


def _mask_bias(b, s, cuts):
    mask = np.ones((b, s), np.float32)
    for row, cut in cuts.items():
        mask[row, cut:] = 0
    return mask.astype(bool), ((1.0 - mask)[:, None, None, :] * -1e9
                               ).astype(np.float32)


@pytest.mark.parametrize("s", [197, 256, 64])
def test_flash_attention_matches_jax(rng, s):
    b, h, dh = 2, 4, 32
    q, k, v = _qkv(rng, b, h, s, dh)
    ref = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             group=4))
    got = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), group=4)
    assert got.shape == (b, h, s, dh) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=2e-5)


def test_flash_attention_key_bias_matches_jax(rng):
    b, h, s, dh = 3, 2, 40, 16
    q, k, v = _qkv(rng, b, h, s, dh)
    valid, bias = _mask_bias(b, s, {1: 25, 2: 7})
    ref = np.asarray(j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             bias=jnp.asarray(bias), group=2))
    got = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), bias=torch.from_numpy(bias),
                             group=2).numpy()
    # padded query rows never reach a feature; compare the valid ones
    np.testing.assert_allclose(got.transpose(0, 2, 1, 3)[valid],
                               ref.transpose(0, 2, 1, 3)[valid],
                               atol=2e-5, rtol=2e-5)


def test_flash_attention_bf16_matches_jax(rng):
    b, h, s, dh = 2, 4, 197, 64
    q, k, v = _qkv(rng, b, h, s, dh)
    ref = np.asarray(j_flash(
        *(jnp.asarray(t).astype(jnp.bfloat16) for t in (q, k, v)))
    ).astype(np.float32)
    got = fa.flash_attention(*(torch.from_numpy(t).bfloat16()
                               for t in (q, k, v)))
    assert got.dtype == torch.bfloat16
    assert np.max(np.abs(got.float().numpy() - ref)) < 0.05


def test_attention_qkv_heads_matches_jax(rng):
    """The [B, S, H·Dh] lane layout with a [B, S] key bias, H = 12 with the
    default group of 8 halving to 4 in both packages."""
    b, s, h, dh = 2, 33, 12, 16
    q, k, v = _qkv(rng, b, s, h * dh)
    valid, bias = _mask_bias(b, s, {1: 20})
    kb = bias[:, 0, 0, :]
    ref = np.asarray(j_heads(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kb),
        num_heads=h))
    got = fa.attention_qkv_heads(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), torch.from_numpy(kb),
                                 num_heads=h).numpy()
    np.testing.assert_allclose(got[valid], ref[valid], atol=2e-5, rtol=2e-5)


def test_group_fallback_and_group_invariance(rng):
    """B·H = 6 is not divisible by the default group of 8: the group halves
    until it divides H, as on the TPU, and every group gives the same
    bits."""
    b, h, s, dh = 3, 2, 30, 16
    q = rng.standard_normal((b, h, s, dh), dtype=np.float32)
    ref = np.asarray(j_flash(*(jnp.asarray(q),) * 3))
    tq = torch.from_numpy(q)
    got = fa.flash_attention(tq, tq, tq)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=2e-5)
    for group in (1, 2, 3, 16):
        torch.testing.assert_close(fa.flash_attention(tq, tq, tq, group=group),
                                   got, rtol=0, atol=0)


def test_heads_equals_slab_on_the_same_values(rng):
    """Split q, k, v give the slab attention's result bit for bit on the same
    values (one kernel body on the card; one plain path here)."""
    b, s, h, dh = 2, 50, 3, 64
    qkv = torch.from_numpy(rng.standard_normal((b, s, 3 * h * dh),
                                               dtype=np.float32))
    kb = torch.zeros(b, s)
    kb[1, 30:] = -1e9
    q, k, v = (t.contiguous() for t in qkv.split(h * dh, dim=-1))
    for dtype in (torch.float32, torch.bfloat16):
        slab = fa.attention_qkv_slab(qkv.to(dtype), kb, num_heads=h)
        heads = fa.attention_qkv_heads(q.to(dtype), k.to(dtype), v.to(dtype),
                                       kb, num_heads=h)
        torch.testing.assert_close(heads, slab, rtol=0, atol=0)


def test_bad_head_count_raises(rng):
    """A lane dim not divisible by the head count raises in both packages
    with the JAX kernel's message."""
    x = rng.standard_normal((2, 8, 96)).astype(np.float32)
    with pytest.raises(ValueError, match="not divisible"):
        j_heads(*(jnp.asarray(x),) * 3, num_heads=5)
    with pytest.raises(ValueError, match="lane dim 96 is not divisible"):
        fa.attention_qkv_heads(*(torch.from_numpy(x),) * 3, num_heads=5)


def test_score_level_bias_raises(rng):
    """Only [B, 1, 1, S] key masks: a full score-level bias raises in both
    packages, naming the plain path."""
    b, h, s, dh = 2, 2, 8, 16
    q = rng.standard_normal((b, h, s, dh), dtype=np.float32)
    full = np.zeros((b, h, s, s), np.float32)
    with pytest.raises(ValueError, match=r"\[B, 1, 1, S\]"):
        j_flash(*(jnp.asarray(q),) * 3, bias=jnp.asarray(full))
    with pytest.raises(ValueError, match=r"use_flash=False"):
        fa.flash_attention(*(torch.from_numpy(q),) * 3,
                           bias=torch.from_numpy(full))
    with pytest.raises(ValueError, match=r"\[B, 1, 1, S\]"):
        nn.mha_attention(*(torch.from_numpy(q),) * 3,
                         bias=torch.from_numpy(full[:, :1]), use_flash=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mha_attention_use_flash_matches_plain_and_jax(rng, dtype):
    """``mha_attention(use_flash=True)`` routes to ``flash_attention``: it
    equals the plain path with the same key mask (fp32 bit for bit here,
    where both are the plain math; bf16 within one rounding of the output)
    and the JAX package's ``mha_attention(use_flash=True)``."""
    b, h, s, dh = 2, 4, 37, 64
    q, k, v = _qkv(rng, b, h, s, dh)
    valid, bias = _mask_bias(b, s, {0: 30})
    tq, tk, tv = (torch.from_numpy(t).to(dtype) for t in (q, k, v))
    tb = torch.from_numpy(bias)
    flash = nn.mha_attention(tq, tk, tv, bias=tb, use_flash=True)
    plain = nn.mha_attention(tq, tk, tv, bias=tb)
    assert flash.dtype == dtype and flash.shape == (b, h, s, dh)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = np.asarray(jnn.mha_attention(
        *(jnp.asarray(t).astype(jdt) for t in (q, k, v)),
        bias=jnp.asarray(bias), use_flash=True)).astype(np.float32)
    got = flash.float().numpy().transpose(0, 2, 1, 3)[valid]
    ref = ref.transpose(0, 2, 1, 3)[valid]
    if dtype == torch.float32:
        torch.testing.assert_close(flash, plain, rtol=0, atol=0)
        np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)
    else:
        torch.testing.assert_close(flash.float(), plain.float(), rtol=0,
                                   atol=0)
        assert np.max(np.abs(got - ref)) < 0.05
    with pytest.raises(ValueError, match="out_dtype"):
        nn.mha_attention(tq, tk, tv, use_flash=True, out_dtype=torch.float16)


def test_inference_only_and_no_fallback():
    """The JAX kernel has no VJP: under autograd the wrappers raise; under
    no_grad they run. A device with no kernel raises; the CPU path counts no
    launch."""
    q = torch.zeros(1, 4, 64)
    with pytest.raises(NotImplementedError, match="inference-only"):
        fa.attention_qkv_heads(q.clone().requires_grad_(), q, q, num_heads=1)
    with pytest.raises(NotImplementedError, match="inference-only"):
        fa.flash_attention(*(torch.zeros(1, 1, 4, 64, requires_grad=True),)
                           * 3)
    with torch.no_grad():
        out = fa.attention_qkv_heads(q.clone().requires_grad_(), q, q,
                                     num_heads=1)
    assert out.shape == (1, 4, 64)
    with pytest.raises(ValueError, match="no kernel"):
        fa.attention_qkv_heads(*(q.to("meta"),) * 3, num_heads=1)
    with pytest.raises(ValueError, match="no kernel"):
        fa.flash_attention(*(torch.zeros(1, 1, 4, 64, device="meta"),) * 3)
    with pytest.raises(ValueError, match="key_bias"):
        fa.attention_qkv_heads(q, q, q, torch.zeros(1, 3), num_heads=1)
    with pytest.raises(ValueError, match="one \\[B, S, H·Dh\\] shape"):
        fa.attention_qkv_heads(q, q, torch.zeros(1, 5, 64), num_heads=1)
    before = fa.HEADS_LAUNCHES
    fa.attention_qkv_heads(q, q, q, num_heads=1)
    assert fa.HEADS_LAUNCHES == before
