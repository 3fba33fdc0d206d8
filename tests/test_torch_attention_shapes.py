"""The port's fused attention at the OpenCLIP zoo's shapes: the plain slab
and split-heads versions (what the kernels are held to on the card) against
the JAX package's Pallas kernels in interpret mode, at every head width of
the presets past 64 (ViT-H 80, ViT-g / EVA01-g 88, ViT-bigG 104, ViT-e
112) and lengths past the old 512 limit (513; 577 for ViT-L-14-336 and
KEEP at 384²). fp32 at 2e-5; bf16 at max |Δ| < 0.05 on valid rows, as
``tests/test_torch_attention.py``. B and H ≤ 2."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keep_tpu.kernels.flash_attention import attention_qkv_heads as j_heads
from keep_tpu.kernels.flash_attention import attention_qkv_slab as j_slab
from keep_tpu_torch.kernels import flash_attention as fa

SHAPES = [(80, 513), (88, 577), (104, 513), (112, 577)]


def _inputs(rng, b, s, h, dh, padded):
    qkv = rng.standard_normal((b, s, 3 * h * dh)).astype(np.float32)
    valid = np.ones((b, s), bool)
    kb = None
    if padded:
        valid[1, int(rng.integers(1, s)):] = False
        kb = ((1.0 - valid) * -1e9).astype(np.float32)
    return qkv, kb, valid


def _close(got, ref, valid, dtype):
    got, ref = got[valid], ref[valid]
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)
    else:
        assert np.max(np.abs(got - ref)) < 0.05


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh,s", SHAPES)
def test_slab_plain_matches_pallas(rng, dh, s, dtype):
    b, h = 2, 2
    padded = dh in (88, 112)
    qkv, kb, valid = _inputs(rng, b, s, h, dh, padded)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = np.asarray(j_slab(jnp.asarray(qkv).astype(jdt),
                            None if kb is None else jnp.asarray(kb),
                            num_heads=h)).astype(np.float32)
    x = torch.from_numpy(qkv).to(getattr(torch, dtype))
    got = fa.attention_qkv_slab(x, None if kb is None else torch.from_numpy(kb),
                                num_heads=h)
    assert got.shape == (b, s, h * dh) and got.dtype == x.dtype
    _close(got.float().numpy(), ref, valid, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh,s", [(80, 577), (112, 513)])
def test_heads_plain_matches_pallas(rng, dh, s, dtype):
    """attention_qkv_heads and flash_attention ([B, H, S, Dh]) at the zoo's
    shapes, with a padded key mask."""
    b, h = 2, 2
    qkv, kb, valid = _inputs(rng, b, s, h, dh, True)
    q, k, v = np.split(qkv, 3, axis=-1)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = np.asarray(j_heads(*(jnp.asarray(t).astype(jdt) for t in (q, k, v)),
                             jnp.asarray(kb), num_heads=h)).astype(np.float32)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(np.ascontiguousarray(t)).to(tdt)
                  for t in (q, k, v))
    got = fa.attention_qkv_heads(tq, tk, tv, torch.from_numpy(kb),
                                 num_heads=h)
    _close(got.float().numpy(), ref, valid, dtype)
    heads = [t.view(b, s, h, dh).transpose(1, 2) for t in (tq, tk, tv)]
    flash = fa.flash_attention(*heads, torch.from_numpy(kb)[:, None, None])
    torch.testing.assert_close(flash.transpose(1, 2).reshape(b, s, h * dh),
                               got, rtol=0, atol=0)


def test_per_body_limits_on_the_cpu():
    """The head widths the forward bodies take, and the narrow bodies'
    shape, as the wrappers state them (the checks that run before a
    launch)."""
    assert fa.HEAD_DIMS == (64, 72, 80, 88, 96, 104, 112, 120, 128)
    for dh in (80, 88, 104, 112):
        assert dh in fa.HEAD_DIMS
    fa._check_shape(80, 785)
    with pytest.raises(ValueError, match="multiple of 8 from 64 to 128"):
        fa._check_shape(36, 16)
    for dh, s in ((80, 197), (64, 577)):
        with pytest.raises(ValueError, match="head_dim 64 and S ≤ 512"):
            fa._check_shape(dh, s, "the backward kernel")
    fa._check_shape(64, 512, "the bf16 → fp32 kernel")
