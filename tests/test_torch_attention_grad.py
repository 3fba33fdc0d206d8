"""The gradient of the port's attention_qkv_slab (autograd through
``SlabAttention``, whose backward on CPU tensors is
``attention_qkv_slab_bwd_reference``) against ``jax.grad`` through the JAX
package's ``attention_qkv_slab`` (the Pallas forward in interpret mode under
its custom VJP, ``_slab_attn_bwd``), on the same numpy inputs. fp32 at
atol 2e-4, rtol 1e-4, the tolerance of tests/test_flash_attention.py for
this VJP."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keep_tpu.kernels.flash_attention import _slab_attn_bwd
from keep_tpu.kernels.flash_attention import attention_qkv_slab as jax_slab
from keep_tpu_torch.kernels import flash_attention as fa

ATOL, RTOL = 2e-4, 1e-4


def _inputs(rng, b, s, h, dh, with_bias):
    qkv = rng.standard_normal((b, s, 3 * h * dh)).astype(np.float32)
    dout = rng.standard_normal((b, s, h * dh)).astype(np.float32)
    kb = None
    if with_bias:
        valid = np.ones((b, s), bool)
        for i in range(1, b):
            valid[i, int(rng.integers(1, s + 1)):] = False
        kb = ((1.0 - valid) * -1e9).astype(np.float32)
    return qkv, dout, kb


def _jax_grad(qkv, dout, kb, h):
    def f(x):
        out = jax_slab(
            x, None if kb is None else jnp.asarray(kb), num_heads=h)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(dout))

    return np.asarray(jax.grad(f)(jnp.asarray(qkv)))


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("b,s,h,dh", [(2, 17, 2, 16), (3, 50, 2, 64)])
def test_grad_matches_jax_fp32(rng, b, s, h, dh, with_bias):
    qkv, dout, kb = _inputs(rng, b, s, h, dh, with_bias)
    want = _jax_grad(qkv, dout, kb, h)
    x = torch.tensor(qkv, requires_grad=True)
    bias = None if kb is None else torch.tensor(kb, requires_grad=True)
    n0, nb0 = fa.LAUNCHES, fa.BWD_LAUNCHES
    out = fa.attention_qkv_slab(x, bias, num_heads=h)
    out.backward(torch.from_numpy(dout))
    np.testing.assert_allclose(x.grad.numpy(), want, atol=ATOL, rtol=RTOL)
    # no gradient flows to the key bias; CPU tensors launch no kernel
    assert bias is None or bias.grad is None
    assert (fa.LAUNCHES, fa.BWD_LAUNCHES) == (n0, nb0)


@pytest.mark.parametrize("with_bias", [False, True])
def test_bwd_reference_matches_jax_vjp(rng, with_bias):
    """The plain backward alone against the JAX package's closed form
    ``_slab_attn_bwd`` on the same residuals (bias zeros when absent, as
    ``attention_qkv_slab`` passes it)."""
    b, s, h, dh = 2, 33, 3, 64
    qkv, dout, kb = _inputs(rng, b, s, h, dh, with_bias)
    kb = np.zeros((b, s), np.float32) if kb is None else kb
    want, dbias = _slab_attn_bwd(h, (jnp.asarray(qkv), jnp.asarray(kb)),
                                     jnp.asarray(dout))
    got = fa.attention_qkv_slab_bwd(torch.from_numpy(qkv), torch.from_numpy(kb),
                                    torch.from_numpy(dout), h)
    assert got.shape == qkv.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    assert not np.asarray(dbias).any()


def test_bwd_reference_bf16_matches_jax_vjp(rng):
    """bf16 slab and dout: both sides sum in fp32 and round once to bf16,
    so they differ by at most a bf16 rounding of fp32 sums taken in another
    order (1e-2 of the largest gradient)."""
    b, s, h, dh = 2, 33, 2, 64
    qkv, dout, kb = _inputs(rng, b, s, h, dh, True)
    q16 = jnp.asarray(qkv).astype(jnp.bfloat16)
    d16 = jnp.asarray(dout).astype(jnp.bfloat16)
    want, _ = _slab_attn_bwd(h, (q16, jnp.asarray(kb)), d16)
    want = np.asarray(want.astype(jnp.float32))
    got = fa.attention_qkv_slab_bwd(
        torch.from_numpy(qkv).bfloat16(), torch.from_numpy(kb),
        torch.from_numpy(dout).bfloat16(), h)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 1e-2 * np.abs(want).max()


def _bwd_bf16_rounding_model(qkv, kb, dout, h):
    """The bf16 backward kernel's rounding in plain PyTorch: the scores, the
    fp32 softmax, dp = do·vᵀ and rowsum(dp∘p) as in ``_slab_attn_bwd``, but
    p and ds rounded to bf16 as the operands of their products (dv = pᵀ·do,
    dq = ds·k, dk = dsᵀ·q), the sums in fp32, cast once to bf16."""
    b, s, three_hd = qkv.shape
    dh = three_hd // (3 * h)
    q, k, v = qkv.float().reshape(b, s, 3, h, dh).permute(2, 0, 3, 1, 4)
    do = dout.float().reshape(b, s, h, dh).transpose(1, 2)
    sc = q @ k.transpose(-1, -2) * dh ** -0.5 + kb.float()[:, None, None, :]
    p = torch.softmax(sc, dim=-1)
    dp = do @ v.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    p16, ds16 = p.bfloat16().float(), ds.bfloat16().float()
    dv = p16.transpose(-1, -2) @ do
    dq = ds16 @ k * dh ** -0.5
    dk = ds16.transpose(-1, -2) @ q * dh ** -0.5
    dqkv = torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4)
    return dqkv.reshape(b, s, three_hd).bfloat16()


@pytest.mark.parametrize("with_bias", [False, True])
def test_bf16_rounding_of_the_kernel_fits_the_gate(rng, with_bias):
    """The card's bf16 backward rounds p and ds to bf16 before their
    products, where the JAX package multiplies them in fp32. That model of
    its rounding, against ``jax.vjp`` of the JAX ``attention_qkv_slab`` on a
    bf16 slab (Pallas forward in interpret mode, ``_slab_attn_bwd``), at
    the towers' head width and ViT-L's length, with a BERT-like padded bias:
    within the bf16 gate, max |Δ| ≤ 1e-2 · max |JAX gradient|."""
    b, s, h, dh = 2, 197, 2, 64
    qkv, dout, kb = _inputs(rng, b, s, h, dh, with_bias)
    kb = np.zeros((b, s), np.float32) if kb is None else kb
    q16 = jnp.asarray(qkv).astype(jnp.bfloat16)
    d16 = jnp.asarray(dout).astype(jnp.bfloat16)
    _, vjp = jax.vjp(lambda x: jax_slab(x, jnp.asarray(kb), num_heads=h), q16)
    want = np.asarray(vjp(d16)[0].astype(jnp.float32))
    got = _bwd_bf16_rounding_model(torch.from_numpy(qkv).bfloat16(),
                                   torch.from_numpy(kb),
                                   torch.from_numpy(dout).bfloat16(), h)
    err = np.abs(got.float().numpy() - want).max()
    assert 0 < err <= 1e-2 * np.abs(want).max()


def test_bwd_reference_equals_autograd_of_plain_forward(rng):
    """In fp32 the closed form is the exact gradient of the plain forward."""
    qkv, dout, kb = _inputs(rng, 2, 21, 2, 32, True)
    x = torch.tensor(qkv, requires_grad=True)
    fa.attention_qkv_slab_reference(x, torch.from_numpy(kb),
                                    num_heads=2).backward(
        torch.from_numpy(dout))
    got = fa.attention_qkv_slab_bwd_reference(
        torch.from_numpy(qkv), torch.from_numpy(kb), torch.from_numpy(dout), 2)
    torch.testing.assert_close(got, x.grad, atol=1e-5, rtol=1e-5)


def test_grad_through_remat_and_bf16(rng):
    """Under torch.utils.checkpoint (per-block remat) and in bf16 the
    Function still gives the plain gradient."""
    from torch.utils.checkpoint import checkpoint

    qkv, dout, _ = _inputs(rng, 2, 9, 2, 16, False)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.tensor(qkv).to(dtype).requires_grad_()
        out = checkpoint(lambda t: fa.attention_qkv_slab(t, num_heads=2), x,
                         use_reentrant=False)
        out.backward(torch.from_numpy(dout).to(dtype))
        want = fa.attention_qkv_slab_bwd_reference(
            x.detach(), torch.zeros(2, 9), torch.from_numpy(dout).to(dtype), 2)
        assert x.grad.dtype == dtype
        torch.testing.assert_close(x.grad, want, atol=0, rtol=0)


def test_bwd_wrapper_refusals():
    x = torch.zeros(2, 8, 3 * 64)
    kb = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="key_bias"):
        fa.attention_qkv_slab_bwd(x, torch.zeros(2, 7), torch.zeros(2, 8, 64),
                                  1)
    with pytest.raises(ValueError, match="dout"):
        fa.attention_qkv_slab_bwd(x, kb, torch.zeros(2, 8, 32), 1)
    with pytest.raises(ValueError, match="not divisible"):
        fa.attention_qkv_slab_bwd(torch.zeros(2, 8, 96), kb,
                                  torch.zeros(2, 8, 32), 5)
    # no kernel, and no fallback, for a device that is neither CPU nor CUDA
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        fa.attention_qkv_slab_bwd(torch.zeros(2, 8, 192, **meta),
                                  torch.zeros(2, 8, **meta),
                                  torch.zeros(2, 8, 64, **meta), 1)
    # the fp32-output form of the forward stays inference-only
    with pytest.raises(NotImplementedError, match="inference-only"):
        fa.attention_qkv_slab(x.bfloat16().requires_grad_(), num_heads=1,
                              out_dtype=torch.float32)
    with torch.no_grad():
        out = fa.attention_qkv_slab(x.bfloat16().requires_grad_(),
                                    num_heads=1, out_dtype=torch.float32)
    assert out.dtype == torch.float32
