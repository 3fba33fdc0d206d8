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


def test_per_body_limits_on_the_cpu(monkeypatch):
    """The head widths every body takes, as the wrappers state them (the
    checks that run before a launch): the forward in each dtype pair, the
    bf16 → fp32 form of the int8 blocks and the backward all take every
    width of ``HEAD_DIMS`` at any S, 577 and 785 among them (an int8 or a
    trained KEEP at 384² and 448²), and hand the C entry points the shape
    as it is; other widths raise."""
    import types

    from keep_tpu_torch.kernels import _build

    assert fa.HEAD_DIMS == (64, 72, 80, 88, 96, 104, 112, 120, 128)
    for dh in (80, 88, 104, 112):
        assert dh in fa.HEAD_DIMS
    assert not hasattr(fa, "NARROW_MAX_SEQ")
    for dh in (36, 60, 130, 136):
        with pytest.raises(ValueError, match="multiple of 8 from 64 to 128"):
            fa._check_shape(dh)
    # the wrappers' checks on host tensors, with the library and the stream
    # stood in for: what reaches the C entry points
    calls = []

    def entry(name):
        def call(*args):
            calls.append((name, args))
            return 0
        return call

    lib = types.SimpleNamespace(
        keep_attention=entry("fwd"),
        keep_attention_qkv_slab_bwd=entry("bwd"))
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(fa, "_check_kernel_slab", lambda qkv: None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    for s in (577, 785):
        for dh in fa.HEAD_DIMS:
            qkv = torch.zeros(1, s, 3 * dh, dtype=torch.bfloat16)
            out = fa._slab_cuda(qkv, None, 1, torch.float32)
            assert out.shape == (1, s, dh) and out.dtype == torch.float32
            dqkv = fa._bwd_cuda(qkv, torch.zeros(1, s),
                                torch.zeros(1, s, dh, dtype=torch.bfloat16),
                                1)
            assert dqkv.shape == qkv.shape
            (fname, fargs), (bname, bargs) = calls[-2:]
            # (B, S, H, Dh, dtype code) as the entry points take them
            assert fname == "fwd" and fargs[8:13] == (1, s, 1, dh, 2)
            assert bname == "bwd" and bargs[5:10] == (1, s, 1, dh, 1)
    with pytest.raises(ValueError, match="multiple of 8 from 64 to 128"):
        fa._bwd_cuda(torch.zeros(1, 577, 3 * 56), torch.zeros(1, 577),
                     torch.zeros(1, 577, 56), 1)