"""The port's ``ln_matmul`` (plain path on CPU tensors) and the ViT under
``fuse_ln=True`` against the JAX package (its Pallas kernel in interpret
mode on the CPU), on the same inputs and weights. Tolerances are the JAX
package's own: ``tests/test_flash_attention.py:149`` (2e-5) for the kernel,
``tests/test_vit_parity.py:94`` (2e-5) for the fused forward, fp32; the
serving gate, cosine ≥ 0.999 per row, in bf16."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keep_tpu import configs as jcfgs
from keep_tpu import quant as jquant
from keep_tpu.kernels.ln_matmul import ln_matmul as j_ln_matmul
from keep_tpu.models import keep as jkeep
from keep_tpu.models import vit as jvit
from keep_tpu_torch import configs
from keep_tpu_torch.compat.torch_loader import from_jax_params
from keep_tpu_torch.kernels import _kops
from keep_tpu_torch.kernels import ln_matmul as lm
from keep_tpu_torch.models import vit
from keep_tpu_torch.models.keep import KEEPModel

VISION = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4)
TEXT = dict(vocab_size=128, hidden_size=48, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=96,
            max_position_embeddings=64)
JCFG = jcfgs.KEEPConfig(vision=jcfgs.ViTConfig(**VISION),
                        text=jcfgs.BertConfig(**TEXT), projection_dim=48)
CFG = configs.KEEPConfig(vision=configs.ViTConfig(**VISION),
                         text=configs.BertConfig(**TEXT), projection_dim=48)


def _cos(a, b):
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))


def _operands(rng, m=70, k=64, n=48):
    """x [M, K], LN g, b [K], the JAX kernel w [K, N] and bias [N]."""
    return (rng.standard_normal((m, k), dtype=np.float32),
            rng.random(k).astype(np.float32) + 0.5,
            rng.standard_normal(k).astype(np.float32) * 0.1,
            rng.standard_normal((k, n)).astype(np.float32) * 0.05,
            rng.standard_normal(n).astype(np.float32) * 0.01)


def _port_args(x, g, b, w, wb, dtype=torch.float32):
    """The same operands for the port: the weight in the torch layout
    [N, K]."""
    t = torch.from_numpy
    return (t(x).to(dtype), t(g), t(b), t(w.T.copy()).to(dtype), t(wb))


@pytest.mark.parametrize("m", [70, 1, 256])
def test_ln_matmul_matches_jax(rng, m):
    x, g, b, w, wb = _operands(rng, m=m)
    ref = np.asarray(j_ln_matmul(*map(jnp.asarray, (x, g, b, w, wb)),
                                 eps=1e-6, out_dtype=jnp.float32))
    got = lm.ln_matmul(*_port_args(x, g, b, w, wb), eps=1e-6,
                       out_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == (m, 48)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=2e-5)


def test_ln_matmul_bf16_matches_jax(rng):
    """bf16 x and weight, bf16 out (the ViT's serving types): the normalised
    rows are rounded to bf16 before the product on both sides, and the
    outputs agree to within one bf16 rounding of each (2⁻⁷ relative; an
    absolute 1e-2 for outputs near zero, where a one-ulp flip of a
    normalised value moves the sum by |w| ≤ 0.2·2⁻⁷)."""
    x, g, b, w, wb = _operands(rng)
    jx = [jnp.asarray(a) for a in (x, g, b, w, wb)]
    jx[0], jx[3] = jx[0].astype(jnp.bfloat16), jx[3].astype(jnp.bfloat16)
    ref = np.asarray(j_ln_matmul(*jx, eps=1e-6)).astype(np.float32)
    got = lm.ln_matmul(*_port_args(x, g, b, w, wb, torch.bfloat16), eps=1e-6)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, atol=1e-2,
                               rtol=2 ** -7)


@pytest.mark.parametrize("n", [3072, 4096])
def test_ln_matmul_bf16_matches_jax_at_vit_l_width(rng, n):
    """The bf16 case above at the width the card kernel is held at: ViT-L's
    qkv (N = 3072) and fc1 (N = 4096) after a LayerNorm of width K = 1024,
    on the 394 token rows of two 224² images, at the same tolerance (one
    bf16 rounding of each output: rtol 2⁻⁷, atol 1e-2)."""
    x, g, b, w, wb = _operands(rng, m=394, k=1024, n=n)
    w = w * (1024 ** -0.5 / 0.05)  # outputs of order one
    jx = [jnp.asarray(a) for a in (x, g, b, w, wb)]
    jx[0], jx[3] = jx[0].astype(jnp.bfloat16), jx[3].astype(jnp.bfloat16)
    ref = np.asarray(j_ln_matmul(*jx, eps=1e-6)).astype(np.float32)
    got = lm.ln_matmul(*_port_args(x, g, b, w, wb, torch.bfloat16), eps=1e-6)
    assert got.dtype == torch.bfloat16 and got.shape == (394, n)
    np.testing.assert_allclose(got.float().numpy(), ref, atol=1e-2,
                               rtol=2 ** -7)


def test_ln_matmul_reference_is_ln_rows_then_product(rng):
    """The plain version is ``_kops.ln_rows_reference`` rounded to the
    weight's dtype, then the fp32 product and bias: with an identity weight
    and a zero bias it returns the normalised rows bit for bit."""
    x, g, b, _, _ = _operands(rng, k=32)
    tx, tg, tb = (torch.from_numpy(a) for a in (x, g, b))
    for dtype in (torch.float32, torch.bfloat16):
        got = lm.ln_matmul_reference(tx, tg, tb, torch.eye(32, dtype=dtype),
                                     torch.zeros(32), 1e-6,
                                     out_dtype=torch.float32)
        want = _kops.ln_rows_reference(tx, tg, tb, 1e-6,
                                       out_dtype=dtype).float()
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_ln_matmul_checks_and_no_fallback(rng):
    x, g, b, w, wb = _port_args(*_operands(rng))
    with pytest.raises(ValueError, match=r"x \[M, K\] and weight \[N, K\]"):
        lm.ln_matmul(x, g, b, w.t(), wb)
    with pytest.raises(ValueError, match="w_bias must be"):
        lm.ln_matmul(x, g, b, w, wb[:5])
    with pytest.raises(ValueError, match="ln_scale must be"):
        lm.ln_matmul(x, g[:5], b, w, wb)
    # inference-only: the JAX kernel has no VJP
    with pytest.raises(NotImplementedError, match="inference-only"):
        lm.ln_matmul(x, g, b, w.clone().requires_grad_(), wb)
    with torch.no_grad():
        lm.ln_matmul(x, g, b, w.clone().requires_grad_(), wb)
    # a device with no kernel raises; the CPU path counts no launch
    with pytest.raises(ValueError, match="no kernel"):
        lm.ln_matmul(x.to("meta"), g, b, w, wb)
    before = lm.LAUNCHES
    lm.ln_matmul(x, g, b, w, wb)
    assert lm.LAUNCHES == before


# ---- the ViT under fuse_ln ------------------------------------------------------


@pytest.fixture(scope="module")
def jparams():
    params = jkeep.init(jax.random.PRNGKey(0), JCFG)
    # non-trivial LayerScale and LayerNorms, so that every block moves the
    # stream and the fused LN's affine terms matter
    blocks = dict(params["visual"]["blocks"])
    blocks["ls1"] = blocks["ls1"] + 0.3
    blocks["ls2"] = blocks["ls2"] + 0.2
    key = jax.random.PRNGKey(1)
    for name in ("norm1", "norm2"):
        k1, k2, key = jax.random.split(key, 3)
        n = blocks[name]
        blocks[name] = {
            "scale": n["scale"] + 0.1 * jax.random.normal(k1, n["scale"].shape),
            "bias": n["bias"] + 0.05 * jax.random.normal(k2, n["bias"].shape)}
    params["visual"] = dict(params["visual"], blocks=blocks)
    return params


def _port(jparams, **kw) -> KEEPModel:
    m = KEEPModel(CFG, **kw)
    m.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jparams), CFG))
    return m.eval()


def _pixels():
    return np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(
        np.float32)


def test_vit_fuse_ln_matches_jax(jparams):
    """The port's ViT under ``use_flash=True, fuse_ln=True`` against the JAX
    ``vit.forward(..., use_flash=True, fuse_ln=True)`` on the same weights,
    fp32, at test_vit_parity.py:94's 2e-5."""
    px = _pixels()
    ref = np.asarray(jvit.forward(jparams["visual"], jnp.asarray(px),
                                  JCFG.vision, use_flash=True, fuse_ln=True))
    port = _port(jparams)
    with torch.no_grad():
        got = port.visual(torch.from_numpy(px), use_flash=True,
                          fuse_ln=True).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)


def test_vit_fuse_ln_runs_ln_matmul_per_block(jparams, monkeypatch):
    """Each block runs ``ln_matmul`` twice (norm1 → qkv, norm2 → fc1) and no
    LayerNorm module for them; ``fuse_ln`` without ``use_flash`` runs none,
    as in the JAX branch conditions."""
    calls = []
    real = vit.ln_matmul
    monkeypatch.setattr(vit, "ln_matmul",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    port = _port(jparams)
    px = torch.from_numpy(_pixels())
    with torch.no_grad():
        port.visual(px, use_flash=True, fuse_ln=True)
        assert len(calls) == 2 * VISION["depth"]
        port.visual(px, use_flash=False, fuse_ln=True)
    assert len(calls) == 2 * VISION["depth"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vit_fuse_ln_matches_unfused(jparams, dtype):
    """The fused forward against the port's unfused one on the same weights:
    fp32 at 2e-5; bf16 (tanh GELU, the serving setting) at cosine ≥ 0.999
    per row."""
    port = _port(jparams, dtype=dtype)
    px = torch.from_numpy(_pixels())
    approx = dtype == torch.bfloat16
    with torch.no_grad():
        fused = port.visual(px, dtype=dtype, use_flash=True,
                            gelu_approx=approx, fuse_ln=True).float().numpy()
        base = port.visual(px, dtype=dtype, use_flash=True,
                           gelu_approx=approx).float().numpy()
    assert np.isfinite(fused).all()
    if dtype == torch.float32:
        np.testing.assert_allclose(fused, base, atol=2e-5, rtol=2e-5)
    else:
        assert _cos(fused, base).min() >= 0.999


def test_quantized_block_with_fuse_ln_takes_the_int8_path(jparams,
                                                          monkeypatch):
    """An int8 model under ``fuse_ln=True`` runs the int8 megakernels, as
    the JAX block's first branch does: no ``ln_matmul``, the same bits as
    without ``fuse_ln``, and the JAX int8 forward with ``fuse_ln=True``
    within the int8 tower tolerance (test_quant.py:297)."""
    monkeypatch.setattr(vit, "ln_matmul", lambda *a, **k: pytest.fail(
        "a quantized block ran ln_matmul"))
    port = _port(jparams, weight_dtype=torch.float32).quantize()
    px = torch.from_numpy(_pixels())
    with torch.no_grad():
        fused = port.visual(px, use_flash=True, gelu_approx=True,
                            fuse_ln=True)
        base = port.visual(px, use_flash=True, gelu_approx=True)
    torch.testing.assert_close(fused, base, rtol=0, atol=0)
    jq = jquant.quantize_linear_weights(jvit.fold_layerscale(
        jparams["visual"]))
    ref = np.asarray(jvit.forward(jq, jnp.asarray(_pixels()), JCFG.vision,
                                  use_flash=True, gelu_approx=True,
                                  fuse_ln=True))
    assert _cos(fused.numpy(), ref).min() > 0.9999
    np.testing.assert_allclose(fused.numpy(), ref, atol=2e-2, rtol=2e-2)


def test_vit_fuse_ln_under_autograd_raises(jparams):
    """``fuse_ln`` is inference-only, as the JAX kernel (no VJP)."""
    port = _port(jparams)
    with pytest.raises(NotImplementedError, match="inference-only"):
        port.visual(torch.from_numpy(_pixels()), use_flash=True, fuse_ln=True)
