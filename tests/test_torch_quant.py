"""The port's int8 W8A8 path against the JAX package on the same weights and
inputs (CPU, tiny widths; the attention sub-blocks and the int8 BERT-base
tower also at full width). The JAX side runs its Pallas kernels in interpret
mode, as ``tests/test_quant.py`` does; the port's wrappers take their plain
versions on CPU tensors, which compute the kernels' math in plain PyTorch
(an exact int32 dot, the kernels' rounding points).

Tolerances are those of the JAX package's own tests for the same component
(``tests/test_quant.py``): qmatmul 1e-4 (:123), the GELU epilogue 1e-4 abs /
1e-3 rel (:130), qmlp 2e-4 abs / 1e-4 rel (:172), qblock 5e-3 abs / 1e-3 rel
(:258), post-LN 2e-3 (:378), the whole int8 tower cos > 0.9999 and 2e-2
(:297). The attention sub-blocks at the towers' widths are held at the
JAX package's tolerance between two routes through the same int8 weights
(2e-2 and cosine ≥ 0.9999 per row, :297-300, 324-327), which the card's
tensor-core attention is held to. The int8 codes and scales of the weight
quantizer are compared exactly."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keep_tpu import configs as jcfgs
from keep_tpu import quant as jquant
from keep_tpu.kernels import _kops as jkops
from keep_tpu.kernels import qblock as jqblock
from keep_tpu.kernels import qmatmul as jqmatmul
from keep_tpu.kernels import qmlp as jqmlp
from keep_tpu.models import bert as jbert
from keep_tpu.models import keep as jkeep
from keep_tpu.models import vit as jvit
from keep_tpu_torch import configs, quant
from keep_tpu_torch.compat.torch_loader import (from_jax_params,
                                                random_keep_state_dict)
from keep_tpu_torch.kernels import _kops, qblock, qmatmul, qmlp
from keep_tpu_torch.models import bert, vit
from keep_tpu_torch.models.keep import KEEPModel
from keep_tpu_torch.ops.nn import LayerNorm, Linear, QLinear

VISION = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4)
TEXT = dict(vocab_size=128, hidden_size=48, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=96,
            max_position_embeddings=64)
JCFG = jcfgs.KEEPConfig(vision=jcfgs.ViTConfig(**VISION),
                        text=jcfgs.BertConfig(**TEXT), projection_dim=48)
CFG = configs.KEEPConfig(vision=configs.ViTConfig(**VISION),
                         text=configs.BertConfig(**TEXT), projection_dim=48)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t, np.float32)


def _cos(a, b):
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))


def _jlin(rng, k, n, w_std=0.05, b_std=0.01):
    """A JAX-quantized linear {kernel_q [K, N], scale, bias} and its port
    twin (``QLinear``, weight_q [N, K])."""
    q = jquant.quantize_kernel(jnp.asarray(
        (rng.standard_normal((k, n)) * w_std).astype(np.float32)))
    p = {**q, "bias": jnp.asarray(
        (rng.standard_normal(n) * b_std).astype(np.float32))}
    return p, _qlin(p)


def _qlin(p):
    return QLinear.from_quantized(
        _t(p["kernel_q"]).T.contiguous(), _t(p["scale"]), _t(p["bias"]),
        None if "pre_scale" not in p else _t(p["pre_scale"]))


def _ln(rng, d):
    g = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    b = (0.05 * rng.standard_normal(d)).astype(np.float32)
    norm = LayerNorm(d, 1e-6).requires_grad_(False)
    norm.weight.copy_(_t(g))
    norm.bias.copy_(_t(b))
    return {"scale": jnp.asarray(g), "bias": jnp.asarray(b)}, norm


@pytest.fixture(scope="module")
def jparams():
    params = jkeep.init(jax.random.PRNGKey(0), JCFG)
    # non-trivial LayerScale, so that folding it matters
    blocks = dict(params["visual"]["blocks"])
    blocks["ls1"] = blocks["ls1"] + 0.3
    blocks["ls2"] = blocks["ls2"] + 0.2
    params["visual"] = dict(params["visual"], blocks=blocks)
    return params


def _port_model(jparams, **kw) -> KEEPModel:
    """The port's KEEP holding the JAX params with fp32 weights."""
    m = KEEPModel(CFG, weight_dtype=torch.float32, **kw)
    m.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jparams), CFG))
    return m.eval()


def _inputs():
    rng = np.random.default_rng(0)
    px = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(1, TEXT["vocab_size"], (3, 24))
    mask = np.ones((3, 24), np.int64)
    mask[1, 10:] = 0
    mask[2, 4:] = 0
    return px, ids * mask, mask


# ---- quantizer ---------------------------------------------------------------


@pytest.mark.parametrize("shape", [(128, 96), (64, 192), (3, 5)])
def test_quantize_kernel_codes_match_jax(rng, shape):
    """Same fp32 weights → the same int8 codes and scales, bit for bit."""
    k, n = shape
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    w[:, 0] = 0.0  # an all-zero column takes the 1e-8 floor
    ref = jquant.quantize_kernel(jnp.asarray(w))
    q, s = quant.quantize_kernel(_t(w.T.copy()))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(ref["kernel_q"]).T)
    np.testing.assert_array_equal(s.numpy(), np.asarray(ref["scale"]))


def test_quantize_rounds_half_to_even():
    """Ties round to even in both quantizers and in the activation
    quantizer, never half away from zero. A row whose abs-max is 127 has a
    scale of exactly 1, so its values reach the rounding unchanged."""
    row = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5],
                   np.float32)
    want = np.array([127, 0, 2, 2, 0, -2, -2, 126], np.int8)
    q, s = _kops.quant_rows(_t(row[None]))
    assert s.item() == 1.0
    np.testing.assert_array_equal(q.numpy()[0], want)
    jq, _ = jkops.quant_rows(jnp.asarray(row[None]))
    np.testing.assert_array_equal(np.asarray(jq)[0], want)
    wq, ws = quant.quantize_kernel(_t(row[None]))
    np.testing.assert_array_equal(wq.numpy()[0], want)
    jw = jquant.quantize_kernel(jnp.asarray(row[:, None]))
    np.testing.assert_array_equal(np.asarray(jw["kernel_q"])[:, 0], want)


def test_quantize_linear_weights_matches_jax(jparams):
    """KEEPModel.quantize() on fp32 weights gives the JAX package's
    quantize_linear_weights(fold_layerscale(·)) codes and scales, on the
    same path-aware targets: both towers' block linears, the patch embed
    and the visual head, not the text pooler."""
    port = _port_model(jparams, dtype=torch.bfloat16).quantize()
    _assert_jax_codes(port, jparams)
    with pytest.raises(ValueError, match="already quantized"):
        port.quantize()


def test_quantize_bf16_weights_matches_jax(jparams):
    """A model that stores its weights in bf16 (``KEEPModel(dtype=bf16)``,
    the default) still quantizes the fp32 values it was loaded from, as the
    JAX package's ``KEEPModel(dtype=bfloat16).quantize()`` does: the same
    codes and scales, bit for bit."""
    m = KEEPModel(CFG, dtype=torch.bfloat16)
    m.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jparams), CFG))
    assert m.visual.blocks[0].mlp.fc1.weight.dtype == torch.bfloat16
    _assert_jax_codes(m.quantize(), jparams)


def test_quantize_returns_a_new_model(jparams):
    """``quantize()`` leaves the float model as it was, as in the JAX
    package: ``q`` is another model, ``m`` holds no QLinear and keeps its
    LayerScale, and ``m``'s features are the same bits as before."""
    px, ids, mask = _inputs()
    m = KEEPModel(CFG, dtype=torch.bfloat16, use_flash=True)
    m.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jparams), CFG))
    m.eval()
    with torch.no_grad():
        before = (m.encode_image(_t(px)), m.encode_text(_t(ids), _t(mask)))
    q = m.quantize()
    assert q is not m and quant.is_quantized(q)
    assert not quant.is_quantized(m)
    assert m.visual.blocks[0].ls1 is not None
    assert m.visual.blocks[0].attn.qkv.weight.dtype == torch.bfloat16
    with torch.no_grad():
        after = (m.encode_image(_t(px)), m.encode_text(_t(ids), _t(mask)))
    for b, a in zip(before, after):
        assert torch.equal(a, b)
    # a weight changed since it was loaded is quantized as it is stored
    with torch.no_grad():
        m.visual.blocks[0].mlp.fc1.weight.mul_(2)
    q2 = m.quantize()
    want, _ = quant.quantize_kernel(m.visual.blocks[0].mlp.fc1.weight)
    assert torch.equal(q2.visual.blocks[0].mlp.fc1.weight_q, want)


def _layer(tree, i: int):
    """Layer ``i`` of the JAX towers' stacked blocks (``visual.blocks``,
    ``text.layers``), every other leaf as it is."""
    def pick(node, stacked):
        if isinstance(node, dict):
            return {k: pick(v, stacked or k in ("blocks", "layers"))
                    for k, v in node.items()}
        return np.asarray(node)[i] if stacked else node
    return pick(tree, False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantization_error_matches_jax(jparams, dtype):
    """``quant.quantization_error`` of a quantized copy against its float
    model gives, for every quantized linear, the JAX package's
    ``quantization_error`` of the same weights (tests/test_quant.py:50's
    use), each layer against the JAX value of that layer's slice of the
    stacked tree, all below 1%. In bf16 both sides hold the weights rounded
    to bf16."""
    import copy

    tree = jax.tree.map(np.asarray, jparams)
    if dtype == "bfloat16":
        tree = jax.tree.map(lambda x: np.asarray(jnp.asarray(x).astype(
            jnp.bfloat16).astype(jnp.float32)), tree)
    m = KEEPModel(CFG, dtype=getattr(torch, dtype))
    m.load_state_dict(from_jax_params(tree, CFG))
    q = quant.quantize_linear_weights(copy.deepcopy(m))
    got = quant.quantization_error(m, q)
    jq = jquant.quantize_linear_weights(tree)
    want = {}
    for i in range(2):
        for path, v in jquant.quantization_error(_layer(tree, i),
                                                 _layer(jq, i)).items():
            parts = path.strip("/").split("/")
            if "blocks" in parts:
                parts.insert(parts.index("blocks") + 1, str(i))
            want[".".join(parts)] = v
    assert got.keys() == want.keys()
    assert len(got) == 19 and set(got) == {
        n for n, mod in q.named_modules() if isinstance(mod, QLinear)}
    for k, v in want.items():
        assert got[k] == pytest.approx(v, rel=1e-6), k
    assert 0 < max(got.values()) < 0.01


def _assert_jax_codes(port: KEEPModel, jparams) -> None:
    """``port``'s int8 codes and scales equal the JAX package's
    quantize_linear_weights(fold_layerscale(·)) of ``jparams``."""
    jq = jquant.quantize_linear_weights(
        dict(jparams, visual=jvit.fold_layerscale(jparams["visual"])))
    want = from_jax_params(jax.tree.map(np.asarray, jq), CFG)
    got = port.state_dict()
    assert got.keys() == want.keys()
    n_int8 = 0
    for k, v in want.items():
        if k.endswith(("weight_q", "weight_scale")):
            n_int8 += k.endswith("weight_q")
            torch.testing.assert_close(got[k], v, rtol=0, atol=0)
    # 2 ViT blocks × 4 + 2 BERT blocks × 4 + patch embed + 2 head linears
    assert n_int8 == 19
    assert isinstance(port.text.pooler, Linear)
    assert port.text.pooler.weight.dtype == torch.bfloat16
    assert port.visual.blocks[0].ls1 is None
    assert quant.is_quantized(port)


def test_quantize_is_path_aware():
    """``proj`` is the attention output projection only; a head named
    ``proj`` and anything under ``rel_pos`` stay float."""
    tree = torch.nn.Module()
    tree.attn = torch.nn.Module()
    tree.attn.proj = Linear(8, 8)
    tree.proj = Linear(8, 4)
    tree.rel_pos = torch.nn.Module()
    tree.rel_pos.fc1 = Linear(2, 8)
    for lin in (tree.attn.proj, tree.proj, tree.rel_pos.fc1):
        torch.nn.init.normal_(lin.weight)
        torch.nn.init.zeros_(lin.bias)
    quant.quantize_linear_weights(tree)
    assert isinstance(tree.attn.proj, QLinear)
    assert isinstance(tree.proj, Linear)
    assert isinstance(tree.rel_pos.fc1, Linear)


def test_from_jax_params_maps_quantized_nodes(rng):
    """A quantized node's ``scale`` is its dequant scale: it maps to
    ``weight_scale``, never to ``weight`` (the LayerNorm rename), and
    ``kernel_q`` is transposed to the torch layout."""
    p, _ = _jlin(rng, 16, 8)
    tree = {"visual_head": {
        "fc1": {**p, "pre_scale": jnp.full((16,), 2.0)},
        "norm": {"scale": jnp.ones(8), "bias": jnp.zeros(8)}}}
    sd = from_jax_params(jax.tree.map(np.asarray, tree), CFG)
    assert set(sd) == {"visual_head.fc1.weight_q",
                       "visual_head.fc1.weight_scale", "visual_head.fc1.bias",
                       "visual_head.fc1.pre_scale", "visual_head.norm.weight",
                       "visual_head.norm.bias"}
    np.testing.assert_array_equal(sd["visual_head.fc1.weight_q"].numpy(),
                                  np.asarray(p["kernel_q"]).T)
    np.testing.assert_array_equal(sd["visual_head.fc1.weight_scale"].numpy(),
                                  np.asarray(p["scale"]))
    # the optional pre_scale buffer appears when a state dict brings one
    lin = QLinear(16, 8)
    assert lin.pre_scale is None
    lin.load_state_dict({k.split(".")[-1]: v for k, v in sd.items()
                         if ".fc1." in k})
    assert lin.pre_scale is not None and lin.pre_scale[0].item() == 2.0
    # the JAX ``w_only`` marker (W8A16) on an expert stack maps to the
    # QExpertLinear's extra state; the JAX package marks experts only, and a
    # dense marked linear still raises
    e = {"kernel_q": np.stack([np.asarray(p["kernel_q"])] * 3),
         "scale": np.stack([np.asarray(p["scale"])] * 3),
         "bias": np.zeros((3, 8), np.float32)}
    for marked in (False, True):
        node = {**e, "w_only": ()} if marked else e
        sd = from_jax_params({"moe": {"wi": node}}, CFG)
        assert sd["moe.wi._extra_state"] == {"w_only": marked}
        assert sd["moe.wi.weight_q"].shape == (3, 8, 16)
    with pytest.raises(ValueError, match="w_only"):
        from_jax_params({"fc1": {**jax.tree.map(np.asarray, p),
                                 "w_only": ()}}, CFG)


# ---- kernels: qmatmul (#8, #9) -------------------------------------------------


@pytest.mark.parametrize("with_ps", [False, True])
def test_qmatmul_matches_jax_kernel(rng, with_ps):
    """The port's quantized_matmul == the JAX Pallas kernel, with and
    without the fused GELU epilogue and the in-kernel pre_scale."""
    x = rng.standard_normal((70, 128)).astype(np.float32)
    p, lin = _jlin(rng, 128, 64)
    ps = np.exp(rng.standard_normal(128)).astype(np.float32) if with_ps \
        else None
    jps = None if ps is None else jnp.asarray(ps)
    tps = None if ps is None else _t(ps)
    for act, atol, rtol in ((None, 1e-4, 1e-4), ("gelu_tanh", 1e-4, 1e-3)):
        ref = np.asarray(jqmatmul.quantized_matmul(
            jnp.asarray(x), p["kernel_q"], p["scale"], p["bias"],
            activation=act, out_dtype=jnp.float32, pre_scale=jps))
        got = qmatmul.quantized_matmul(
            _t(x), lin.weight_q, lin.weight_scale, lin.bias, activation=act,
            out_dtype=torch.float32, pre_scale=tps)
        assert got.dtype == torch.float32 and got.shape == (70, 64)
        np.testing.assert_allclose(got.numpy(), ref, atol=atol, rtol=rtol)
    # bf16 is the default output, as in the JAX kernel
    assert qmatmul.quantized_matmul(_t(x), lin.weight_q, lin.weight_scale,
                                    lin.bias).dtype == torch.bfloat16


def test_bsd_matches_flat_and_jax(rng):
    """The [B, S, K] form == the flat form (bit for bit here: a contiguous
    [B, S, K] tensor is [B·S, K]) and the JAX bsd kernel."""
    b, s, d, f = 3, 37, 64, 128
    x = (rng.standard_normal((b, s, d)) * 0.5).astype(np.float32)
    p, lin = _jlin(rng, d, f)
    flat = qmatmul.quantized_matmul(
        _t(x).reshape(-1, d), lin.weight_q, lin.weight_scale, lin.bias,
        activation="gelu_tanh", out_dtype=torch.float32).reshape(b, s, f)
    bsd = qmatmul.quantized_matmul_bsd(
        _t(x), lin.weight_q, lin.weight_scale, lin.bias,
        activation="gelu_tanh", out_dtype=torch.float32)
    torch.testing.assert_close(bsd, flat, rtol=0, atol=0)
    ref = np.asarray(jqmatmul.quantized_matmul_bsd(
        jnp.asarray(x), p["kernel_q"], p["scale"], p["bias"],
        activation="gelu_tanh", out_dtype=jnp.float32))
    np.testing.assert_allclose(bsd.numpy(), ref, atol=2e-4, rtol=1e-4)
    # qlinear_fused picks the form by rank and keeps x's dtype
    xb = _t(x).bfloat16()
    out = qmatmul.qlinear_fused(lin, xb)
    assert out.dtype == torch.bfloat16 and out.shape == (b, s, f)
    assert qmatmul.qlinear_fused(lin, xb[0]).shape == (s, f)


# ---- kernels: qmlp (#6) ----------------------------------------------------------


@pytest.mark.parametrize("variant", ["plain", "ln_residual", "post_ln",
                                     "pre_scale"])
def test_qmlp_matches_jax_kernel(rng, variant):
    """quantized_mlp_bsd == the JAX Pallas kernel for each fusion the towers
    use: ViT's pre-LN + residual, BERT's post-LN tail with a pre_scale."""
    b, s, d, f = 2, 16, 64, 128
    x = (rng.standard_normal((b, s, d)) * 0.5).astype(np.float32)
    p1, l1 = _jlin(rng, d, f)
    p2, l2 = _jlin(rng, f, d)
    jn, tn = _ln(rng, d)
    ps = np.exp(0.5 * rng.standard_normal(d)).astype(np.float32)
    jkw, tkw, atol, rtol = {}, {}, 2e-4, 1e-4
    if variant == "ln_residual":
        jkw = dict(ln_scale=jn["scale"], ln_bias=jn["bias"], residual=True)
        tkw = dict(ln_scale=tn.weight, ln_bias=tn.bias, residual=True)
    elif variant == "post_ln":
        jkw = dict(ln_scale=jn["scale"], ln_bias=jn["bias"], post_ln=True,
                   pre_scale1=jnp.asarray(ps))
        tkw = dict(ln_scale=tn.weight, ln_bias=tn.bias, post_ln=True,
                   pre_scale1=_t(ps))
        atol = rtol = 2e-3  # the post-LN tolerance (test_quant.py:378)
    elif variant == "pre_scale":
        jkw = dict(pre_scale1=jnp.asarray(ps))
        tkw = dict(pre_scale1=_t(ps))
    ref = np.asarray(jqmlp.quantized_mlp_bsd(
        jnp.asarray(x), p1["kernel_q"], p1["scale"], p1["bias"],
        p2["kernel_q"], p2["scale"], p2["bias"], out_dtype=jnp.float32,
        eps=1e-6, **jkw))
    got = qmlp.quantized_mlp_bsd(
        _t(x), l1.weight_q, l1.weight_scale, l1.bias, l2.weight_q,
        l2.weight_scale, l2.bias, out_dtype=torch.float32, eps=1e-6, **tkw)
    np.testing.assert_allclose(got.numpy(), ref, atol=atol, rtol=rtol)


def test_qmlp_rows_bit_identical():
    """``rows`` is accepted as on the TPU and every divisor of B gives the
    same bits; a non-divisor raises (twin of test_quant.py:628), and a 2-D input takes the flat pair."""
    rng = np.random.default_rng(11)
    B, S, D, F = 8, 5, 16, 32
    x = _t(rng.standard_normal((B, S, D)).astype(np.float32))
    w1q = _t(rng.integers(-127, 127, (F, D)).astype(np.int8))
    w2q = _t(rng.integers(-127, 127, (D, F)).astype(np.int8))
    s1, s2 = torch.full((F,), 0.01), torch.full((D,), 0.01)
    b1 = _t(rng.standard_normal(F).astype(np.float32))
    b2 = _t(rng.standard_normal(D).astype(np.float32))
    ln_s, ln_b = torch.ones(D), torch.zeros(D)
    variants = [dict(), dict(ln_scale=ln_s, ln_bias=ln_b, residual=True),
                dict(ln_scale=ln_s, ln_bias=ln_b, post_ln=True)]
    for kw in variants:
        a = qmlp.quantized_mlp_bsd(x, w1q, s1, b1, w2q, s2, b2, rows=1, **kw)
        for k in (2, 4, 8):
            b = qmlp.quantized_mlp_bsd(x, w1q, s1, b1, w2q, s2, b2, rows=k,
                                       **kw)
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="rows"):
        qmlp.quantized_mlp_bsd(x, w1q, s1, b1, w2q, s2, b2, rows=3)
    with pytest.raises(ValueError, match="post_ln"):
        qmlp.quantized_mlp_bsd(x, w1q, s1, b1, w2q, s2, b2, post_ln=True)
    # a 2-D input takes the flat pair, which gives the bsd bits on the same
    # rows
    flat = qmlp.qmlp_fused(QLinear.from_quantized(w1q, s1, b1),
                           QLinear.from_quantized(w2q, s2, b2), x[0])
    torch.testing.assert_close(
        flat, qmlp.quantized_mlp_bsd(x[:1], w1q, s1, b1, w2q, s2, b2,
                                     out_dtype=torch.float32)[0],
        rtol=0, atol=0)


# ---- kernels: flat qmlp (#7) -----------------------------------------------------


@pytest.mark.parametrize("with_ps", [False, True])
def test_flat_qmlp_matches_jax_kernel(rng, with_ps):
    """The port's flat ``quantized_mlp`` == the JAX Pallas kernel (interpret
    mode) at test_quant.py:133's shape and tolerance (2e-4 / 1e-4), with and
    without the in-kernel SmoothQuant ``pre_scale1``."""
    d, f = 128, 256
    x = (rng.standard_normal((70, d)) * 0.5).astype(np.float32)
    p1, l1 = _jlin(rng, d, f)
    p2, l2 = _jlin(rng, f, d)
    ps = np.exp(0.5 * rng.standard_normal(d)).astype(np.float32)
    ref = np.asarray(jqmlp.quantized_mlp(
        jnp.asarray(x), p1["kernel_q"], p1["scale"], p1["bias"],
        p2["kernel_q"], p2["scale"], p2["bias"], out_dtype=jnp.float32,
        pre_scale1=jnp.asarray(ps) if with_ps else None))
    got = qmlp.quantized_mlp(
        _t(x), l1.weight_q, l1.weight_scale, l1.bias, l2.weight_q,
        l2.weight_scale, l2.bias, out_dtype=torch.float32,
        pre_scale1=_t(ps) if with_ps else None)
    assert got.dtype == torch.float32 and got.shape == (70, d)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4, rtol=1e-4)
    # bf16 is the default output, as in the JAX kernel
    assert qmlp.quantized_mlp(_t(x), l1.weight_q, l1.weight_scale, l1.bias,
                              l2.weight_q, l2.weight_scale,
                              l2.bias).dtype == torch.bfloat16


@pytest.mark.parametrize("with_ps", [False, True])
def test_flat_qmlp_equals_bsd_bit_for_bit(rng, with_ps):
    """Every step of the pair is per token: the flat form over [B·S, D]
    equals ``quantized_mlp_bsd`` over [B, S, D] bit for bit, fp32 and bf16
    out."""
    b, s, d, f = 3, 37, 64, 128
    x = _t((rng.standard_normal((b, s, d)) * 0.5).astype(np.float32))
    _, l1 = _jlin(rng, d, f)
    _, l2 = _jlin(rng, f, d)
    ps = _t(np.exp(0.5 * rng.standard_normal(d)).astype(np.float32)) \
        if with_ps else None
    args = (l1.weight_q, l1.weight_scale, l1.bias, l2.weight_q,
            l2.weight_scale, l2.bias)
    for out_dtype in (torch.float32, torch.bfloat16):
        flat = qmlp.quantized_mlp(x.reshape(-1, d), *args,
                                  out_dtype=out_dtype, pre_scale1=ps)
        bsd = qmlp.quantized_mlp_bsd(x, *args, out_dtype=out_dtype,
                                     pre_scale1=ps)
        torch.testing.assert_close(flat.view(b, s, d), bsd, rtol=0, atol=0)
    with pytest.raises(ValueError, match=r"\[M, D\]"):
        qmlp.quantized_mlp(x, *args)


@pytest.mark.parametrize("shape", [(70,), (2, 3, 5)])
def test_int8_mlp_on_flat_input_matches_jax(rng, monkeypatch, shape):
    """``Mlp.forward`` on an int8 fc1/fc2 pair with a 2-D or 4-D input
    takes ``qmlp_fused`` → the flat ``quantized_mlp`` and keeps the input's
    shape and dtype. Against the JAX ``qmlp_fused`` (the flat Pallas kernel
    in interpret mode, what ``ops.nn.mlp`` runs on the TPU) at 2e-4 / 1e-4;
    against the JAX ``ops.nn.mlp`` on the same quantized tree, which on the
    CPU takes the unfused per-linear path (a dividing quantizer, bias and
    GELU outside the GEMM: a rare code flip), at the int8 linear tolerance
    of test_torch_models.py (1e-2)."""
    from keep_tpu.ops import nn as jnn
    from keep_tpu_torch.ops.nn import Mlp

    d, f = 64, 128
    x = (rng.standard_normal(shape + (d,)) * 0.5).astype(np.float32)
    p1, l1 = _jlin(rng, d, f)
    p2, l2 = _jlin(rng, f, d)
    mlp = Mlp(d, f)
    mlp.fc1, mlp.fc2 = l1, l2
    calls = []
    real = qmlp.quantized_mlp
    monkeypatch.setattr(qmlp, "quantized_mlp",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = mlp(_t(x), gelu_approx=True)
    assert calls == [1]
    assert got.shape == x.shape and got.dtype == torch.float32
    fused = np.asarray(jqmlp.qmlp_fused(p1, p2, jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), fused, atol=2e-4, rtol=1e-4)
    ref = np.asarray(jnn.mlp({"fc1": p1, "fc2": p2}, jnp.asarray(x),
                             gelu_approx=True))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-2, rtol=1e-2)


# ---- kernels: qblock (#4, #5) ------------------------------------------------------


def test_qblock_matches_jax_kernel(rng):
    """The ViT attention sub-block == the JAX Pallas megakernel (twin of
    test_quant.py:217), fp32 and bf16 streams."""
    b, s, d, heads, eps = 2, 37, 64, 4, 1e-6
    x = (rng.standard_normal((b, s, d)) * 0.3).astype(np.float32)
    jn, tn = _ln(rng, d)
    pq, lq = _jlin(rng, d, 3 * d, w_std=0.08)
    pp, lp = _jlin(rng, d, d, w_std=0.08)
    ref = np.asarray(jqblock.quantized_attention_block(
        jnp.asarray(x), jn, pq, pp, num_heads=heads, eps=eps))
    got = qblock.quantized_attention_block(_t(x), tn, lq, lp,
                                           num_heads=heads, eps=eps)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-3, rtol=1e-3)
    # the bf16 stream: rounded once at the exit in both
    ref16 = np.asarray(jqblock.quantized_attention_block(
        jnp.asarray(x).astype(jnp.bfloat16), jn, pq, pp, num_heads=heads,
        eps=eps)).astype(np.float32)
    got16 = qblock.quantized_attention_block(_t(x).bfloat16(), tn, lq, lp,
                                             num_heads=heads, eps=eps)
    assert got16.dtype == torch.bfloat16
    assert _cos(_np(got16).reshape(-1, d), ref16.reshape(-1, d)).min() > 0.999


def test_qblock_postln_matches_jax_kernel(rng):
    """The BERT post-LN sub-block == the JAX Pallas megakernel: padded key
    bias, a non-trivial pre_scale on the quantize input only."""
    b, s, d, heads, eps = 3, 16, 48, 4, 1e-12
    x = (rng.standard_normal((b, s, d)) * 0.5).astype(np.float32)
    valid = np.arange(s)[None, :] < np.array([16, 9, 4])[:, None]
    kb = ((1.0 - valid) * -1e9).astype(np.float32)
    jn, tn = _ln(rng, d)
    pq, _ = _jlin(rng, d, 3 * d, w_std=0.1)
    pq["pre_scale"] = jnp.asarray(np.exp(0.5 * rng.standard_normal(d))
                                  .astype(np.float32))
    lq = _qlin(pq)
    po, lo = _jlin(rng, d, d, w_std=0.1)
    ref = np.asarray(jqblock.quantized_attention_block_postln(
        jnp.asarray(x), jnp.asarray(kb), jn, pq, po, num_heads=heads,
        eps=eps))
    got = qblock.quantized_attention_block_postln(
        _t(x), _t(kb), tn, lq, lo, num_heads=heads, eps=eps)
    np.testing.assert_allclose(got.numpy()[valid], ref[valid], atol=2e-3,
                               rtol=2e-3)


# the towers' widths at B=32 (name: B, S, D, H, LN eps, BERT's padded key
# bias and pre_scale), drawn as chip_smoke.py draws them
TOWER_BLOCKS = {"vit_l16": (32, 197, 1024, 16, 1e-6, False),
                "bert_base": (32, 256, 768, 12, 1e-12, True)}


@functools.lru_cache(maxsize=None)
def _tower_block(name):
    """One int8 attention sub-block at a tower's width from a numpy seed:
    the JAX Pallas megakernel's output (interpret mode) and the port's
    arguments (x, key bias or None, norm, qkv, proj)."""
    b, s, d, h, eps, post_ln = TOWER_BLOCKS[name]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    jn, tn = _ln(rng, d)
    pq, _ = _jlin(rng, d, 3 * d, w_std=d ** -0.5, b_std=0.02)
    pp, lp = _jlin(rng, d, d, w_std=d ** -0.5, b_std=0.02)
    if not post_ln:
        ref = jqblock.quantized_attention_block(jnp.asarray(x), jn, pq, pp,
                                                num_heads=h, eps=eps)
        return np.asarray(ref), (_t(x), None, tn, _qlin(pq), lp)
    lens = rng.integers(8, s + 1, b)
    kb = ((np.arange(s)[None, :] >= lens[:, None]) * -1e9).astype(np.float32)
    pq["pre_scale"] = jnp.asarray(np.exp(0.5 * rng.standard_normal(d))
                                  .astype(np.float32))
    ref = jqblock.quantized_attention_block_postln(
        jnp.asarray(x), jnp.asarray(kb), jn, pq, pp, num_heads=h, eps=eps)
    return np.asarray(ref), (_t(x), _t(kb), tn, _qlin(pq), lp)


def _wgmma_order_attention(qkv, key_bias=None, *, num_heads, out_dtype=None):
    """A plain model of the card's bf16 → fp32 attention body
    (``csrc/attention_qkv_slab_f32.cu``) in the order it takes its sums:
    q·kᵀ as four 16-wide partial products added in fp32 (its wgmma k16
    steps), scaled, then biased; the exact row max, e = exp(s − m), p =
    e / l by division, rounded to bf16; p·v as partial products over 16
    keys at a time added in fp32. Within a 16-wide step the sum is
    PyTorch's, where the tensor cores take their own."""
    b, s, _ = qkv.shape
    q, k, v = (t.float() for t in qkv.reshape(b, s, 3, num_heads, 64)
               .permute(2, 0, 3, 1, 4))
    sc = q[..., :16] @ k[..., :16].transpose(-1, -2)
    for c in range(16, 64, 16):
        sc = sc + q[..., c:c + 16] @ k[..., c:c + 16].transpose(-1, -2)
    sc = sc * 64 ** -0.5
    if key_bias is not None:
        sc = sc + key_bias.float()[:, None, None, :]
    e = torch.exp(sc - sc.amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True)).bfloat16().float()
    o = p[..., :16] @ v[..., :16, :]
    for c in range(16, s, 16):
        o = o + p[..., c:c + 16] @ v[..., c:c + 16, :]
    return o.transpose(1, 2).reshape(b, s, num_heads * 64).to(out_dtype)


@pytest.mark.parametrize("route", ["plain", "wgmma_order"])
@pytest.mark.parametrize("tower", list(TOWER_BLOCKS))
def test_qblock_at_tower_width_within_route_tolerance(tower, route):
    """#4 (ViT-L) and #5 (BERT-base, padded key bias, pre_scale) at the
    towers' widths, B=32, against the JAX Pallas megakernel at the JAX
    package's tolerance between two routes through the same int8 weights
    (atol 2e-2, rtol 2e-2, cosine ≥ 0.9999 per row: tests/test_quant.py:
    297-300, 324-327): the port's plain block, and the plain block with its
    attention taken in the card's tensor-core order. The JAX kernel itself
    is 0.009 from the plain block at BERT-base (beyond the 5e-3 taken at
    d = 64), so the gate that holds the card's attention is this one, and
    it covers a change of summation order."""
    b, s, d, h, eps, post_ln = TOWER_BLOCKS[tower]
    ref, (x, kb, norm, qkv, proj) = _tower_block(tower)
    ops = _kops.PLAIN if route == "plain" else _kops.PLAIN._replace(
        attention=_wgmma_order_attention)
    got = qblock._block(ops, x, norm, qkv, proj, kb, num_heads=h, eps=eps,
                        post_ln=post_ln).numpy()
    assert got.shape == ref.shape == (b, s, d)
    cos = _cos(got.reshape(-1, d), ref.reshape(-1, d))
    print(tower, route, "max |Δ| vs JAX", np.abs(got - ref).max(),
          "min row cosine", cos.min())
    np.testing.assert_allclose(got, ref, atol=2e-2, rtol=2e-2)
    assert cos.min() >= 0.9999


def test_softmax_quotient_is_ieee_division():
    """The card's fp32-out attention takes p = e / l as q = RN(e·y) with y =
    RN(1/l), corrected once by an FMA: RN(q + RN(e − l·q)·y)
    (``div_rn`` in ``csrc/attention_qkv_slab_f32.cu``), in place of div.rn.
    For the softmax's e in (0, 1] and l in [1, 512] that is the IEEE
    quotient, checked here in exact rational arithmetic."""
    from fractions import Fraction

    def rn(x: Fraction) -> np.float32:
        """x rounded to the nearest float32, ties to even."""
        c = np.float32(float(x))
        near = [np.nextafter(c, np.float32(-np.inf)), c,
                np.nextafter(c, np.float32(np.inf))]
        return min(near, key=lambda f: (abs(Fraction(float(f)) - x),
                                        int(f.view(np.uint32)) & 1))

    rng = np.random.default_rng(0)
    ls = np.concatenate([rng.uniform(1, 512, 150),
                         [1, 2, 3, 255.99998, 511.99997, 1.9999999]])
    es = np.concatenate([rng.uniform(0, 1, 40),
                         np.exp(rng.uniform(-69, 0, 30)), [1.0]])
    for l in ls.astype(np.float32):
        lf = Fraction(float(l))
        y = Fraction(float(rn(1 / lf)))
        for e in es.astype(np.float32):
            ef = Fraction(float(e))
            q = Fraction(float(rn(ef * y)))
            r = Fraction(float(rn(ef - lf * q)))  # the FMA: exact here
            assert rn(q + r * y) == rn(ef / lf), (e, l)


def test_wgmma_order_attention_is_another_order():
    """The model of the card's order differs from the plain attention on
    the same slab (so the test above holds a real change of order), by far
    less than the bf16 attention gate (0.05)."""
    rng = np.random.default_rng(3)
    qkv = _t(rng.standard_normal((2, 197, 3 * 4 * 64)).astype(np.float32)
             ).bfloat16()
    kb = _t(((np.arange(197)[None] >= np.array([[197], [90]])) * -1e9)
            .astype(np.float32))
    for bias in (None, kb):
        got = _wgmma_order_attention(qkv, bias, num_heads=4,
                                     out_dtype=torch.float32)
        want = _kops.PLAIN.attention(qkv, bias, num_heads=4,
                                     out_dtype=torch.float32)
        diff = (got - want).abs().max().item()
        assert 0 < diff < 0.05


# ---- towers -----------------------------------------------------------------------


def _vit_pair(seed, targets=jquant.DEFAULT_TARGETS):
    jcfg = jcfgs.ViTConfig(**VISION)
    jp = jvit.fold_layerscale(jvit.init(jax.random.PRNGKey(seed), jcfg))
    jq = jquant.quantize_linear_weights(jp, targets=targets)
    tower = vit.VisionTransformer(configs.ViTConfig(**VISION))
    vit.fold_layerscale(tower)
    quant.quantize_linear_weights(tower, targets=targets)
    sd = from_jax_params({"visual": jax.tree.map(np.asarray, jq)}, CFG)
    tower.load_state_dict({k[len("visual."):]: v for k, v in sd.items()})
    return jcfg, jq, tower.eval()


def test_vit_megakernel_path_matches_unfused_and_jax(rng):
    """The quantized, folded ViT: the megakernel path (use_flash) == the
    unfused int8 path, and == the JAX megakernel path (twin of
    test_quant.py:285)."""
    jcfg, jq, tower = _vit_pair(3)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    n0 = sum(_kops.LAUNCHES.values())
    with torch.no_grad():
        mega = tower(_t(x), use_flash=True, gelu_approx=True).numpy()
        unfused = tower(_t(x), use_flash=False, gelu_approx=True).numpy()
    assert sum(_kops.LAUNCHES.values()) == n0  # CPU tensors launch nothing
    assert all(blk.int8_megakernel() for blk in tower.blocks)
    np.testing.assert_allclose(mega, unfused, atol=2e-2, rtol=2e-2)
    assert _cos(mega, unfused).mean() > 0.9999
    ref = np.asarray(jvit.forward(jq, jnp.asarray(x), jcfg, use_flash=True,
                                  gelu_approx=True))
    np.testing.assert_allclose(mega, ref, atol=2e-2, rtol=2e-2)
    assert _cos(mega, ref).mean() > 0.9999


def _bert_pair(seed, targets=jquant.DEFAULT_TARGETS, smooth_ids=None,
               boost=False):
    jcfg = jcfgs.BertConfig(**TEXT)
    jp = jbert.init(jax.random.PRNGKey(seed), jcfg)
    if boost:
        # BERT's init (std 0.02) leaves the sub-blocks tiny next to the
        # residual; scale the linears so that int8 error shows
        blocks = jp["blocks"]
        for lin in (blocks["attn"]["qkv"], blocks["attn"]["out"],
                    blocks["mlp"]["fc1"], blocks["mlp"]["fc2"]):
            lin["kernel"] = lin["kernel"] * 10
    if smooth_ids is not None:
        jq = jquant.smooth_quantize_bert(jp, jnp.asarray(smooth_ids), None,
                                         jcfg)
    else:
        jq = jquant.quantize_linear_weights(jp, targets=targets)
    tower = bert.BertModel(configs.BertConfig(**TEXT))
    quant.quantize_linear_weights(tower, targets=targets)
    sd = from_jax_params({"text": jax.tree.map(np.asarray, jq)}, CFG)
    tower.load_state_dict({k[len("text."):]: v for k, v in sd.items()})
    return jcfg, jq, tower.eval()


def test_bert_megakernel_path_matches_unfused_and_jax():
    """The quantized BERT: the post-LN megakernel path == the unfused int8
    path and the JAX megakernel path, padding mask respected (twin of
    test_quant.py:303)."""
    jcfg, jq, tower = _bert_pair(5)
    _, ids, mask = _inputs()
    valid = mask.astype(bool)
    with torch.no_grad():
        mega = tower(_t(ids), _t(mask), use_flash=True, gelu_approx=True)
        unfused = tower(_t(ids), _t(mask), use_flash=False, gelu_approx=True)
    ref = jbert.forward(jq, jnp.asarray(ids), jnp.asarray(mask), cfg=jcfg,
                        use_flash=True, gelu_approx=True)
    for other in (unfused, {k: _t(np.asarray(v)) for k, v in ref.items()}):
        a = mega["pooler_output"].numpy()
        b = other["pooler_output"].numpy()
        np.testing.assert_allclose(a, b, atol=2e-2, rtol=2e-2)
        assert _cos(a, b).min() > 0.9999
        a = mega["last_hidden_state"].numpy()[valid]
        b = other["last_hidden_state"].numpy()[valid]
        np.testing.assert_allclose(a, b, atol=2e-2, rtol=2e-2)
        assert _cos(a, b).mean() > 0.9999


def test_int8_bert_base_routes_at_full_width():
    """The int8 BERT-base tower at full width and depth, the JAX package's
    megakernel path (interpret mode) against the port's plain one on the
    same quantized weights, ten prompts of 10–14 tokens padded to 256: at
    the repo's int8 gate per row (cosine ≥ 0.999, bench.py ``_int8_gate``).
    Two int8 routes that differ only in the order of their fp32 sums drift
    apart with width and depth here: per-row cosines 0.99977–0.99993 and
    0.99985 taken whole (printed with ``-s``), short of the 0.9999 that
    test_quant.py:327 holds at hidden 64 and 2 layers, which is why the
    card's int8 server is held to its blocks' plain versions only in that
    test's own form (chip_smoke.py ``check_int8_server``)."""
    jcfg = jcfgs.BertConfig()
    jq = jquant.quantize_linear_weights(jbert.init(jax.random.PRNGKey(0),
                                                   jcfg))
    rng = np.random.default_rng(0)
    lens = np.array([12, 12, 13, 10, 12, 12, 14, 11, 11, 14])
    mask = (np.arange(256)[None] < lens[:, None]).astype(np.int64)
    ids = rng.integers(5, 1000, (10, 256)) * mask
    ref = np.asarray(jbert.forward(jq, jnp.asarray(ids), jnp.asarray(mask),
                                   cfg=jcfg, use_flash=True,
                                   gelu_approx=True)["pooler_output"])
    cfg = configs.KEEPConfig()
    tower = bert.BertModel(cfg.text)
    quant.quantize_linear_weights(tower)
    sd = from_jax_params({"text": jax.tree.map(np.asarray, jq)}, cfg)
    tower.load_state_dict({k[len("text."):]: v for k, v in sd.items()})
    with torch.no_grad():
        got = tower.eval()(_t(ids), _t(mask), use_flash=True,
                           gelu_approx=True)["pooler_output"].numpy()
    rows = _cos(got, ref)
    whole = got.ravel() @ ref.ravel() / (np.linalg.norm(got)
                                         * np.linalg.norm(ref))
    print("per-row cosine", rows, "whole", whole)
    assert rows.min() >= 0.999


def test_bert_megakernel_mask_changes_padded_rows(rng):
    """The fused path honours the padding mask: masking keys changes the
    other positions (twin of test_quant.py:330)."""
    _, _, tower = _bert_pair(6)
    ids = _t(rng.integers(1, TEXT["vocab_size"], (1, 12)))
    part_mask = torch.ones(1, 12, dtype=torch.long)
    part_mask[0, 6:] = 0
    with torch.no_grad():
        full = tower(ids, torch.ones_like(ids), use_flash=True,
                     gelu_approx=True)["last_hidden_state"]
        part = tower(ids, part_mask, use_flash=True,
                     gelu_approx=True)["last_hidden_state"]
    assert (full[0, :6] - part[0, :6]).abs().max() > 1e-4


def test_partial_quantization_skips_megakernels(rng):
    """Quantizing a subset of the linears takes the generic int8 dispatch,
    not the megakernels, and agrees with the JAX package (twin of
    test_quant.py:382)."""
    jcfg, jq, tower = _vit_pair(7, targets=("qkv", "proj", "fc1"))
    assert not any(blk.int8_megakernel() for blk in tower.blocks)
    assert isinstance(tower.blocks[0].mlp.fc2, Linear)
    x = rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        out = tower(_t(x), use_flash=True, gelu_approx=True).numpy()
    ref = np.asarray(jvit.forward(jq, jnp.asarray(x), jcfg, use_flash=True,
                                  gelu_approx=True))
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, atol=2e-2, rtol=2e-2)

    jbcfg, jbq, btower = _bert_pair(8, targets=("qkv", "fc1", "fc2"))
    assert not any(blk.int8_megakernel() for blk in btower.blocks)
    ids = rng.integers(1, TEXT["vocab_size"], (1, 8))
    with torch.no_grad():
        bout = btower(_t(ids), torch.ones(1, 8, dtype=torch.long),
                      use_flash=True, gelu_approx=True)["pooler_output"]
    bref = jbert.forward(jbq, jnp.asarray(ids), jnp.ones((1, 8), jnp.int32),
                         cfg=jbcfg, use_flash=True, gelu_approx=True)
    assert np.isfinite(bout.numpy()).all()
    np.testing.assert_allclose(bout.numpy(), np.asarray(
        bref["pooler_output"]), atol=2e-2, rtol=2e-2)


def test_bert_megakernel_honors_pre_scale(rng):
    """A JAX smooth_bert tree (pre_scale on qkv and fc1), loaded with
    from_jax_params: the megakernel path == the unfused int8 path and the
    JAX megakernel path (twin of test_quant.py:588)."""
    calib = rng.integers(1, TEXT["vocab_size"], (4, 16))
    jcfg, jq, tower = _bert_pair(9, smooth_ids=calib, boost=True)
    assert tower.blocks[0].attn.qkv.pre_scale is not None
    assert tower.blocks[0].mlp.fc1.pre_scale is not None
    ids = rng.integers(1, TEXT["vocab_size"], (4, 16))
    mask = (np.arange(16)[None, :]
            < np.array([16, 10, 16, 7])[:, None]).astype(np.int64)
    with torch.no_grad():
        mega = tower(_t(ids), _t(mask), use_flash=True,
                     gelu_approx=True)["pooler_output"].numpy()
        unfused = tower(_t(ids), _t(mask), use_flash=False,
                        gelu_approx=True)["pooler_output"].numpy()
    ref = np.asarray(jbert.forward(jq, jnp.asarray(ids), jnp.asarray(mask),
                                   cfg=jcfg, use_flash=True,
                                   gelu_approx=True)["pooler_output"])
    for other in (unfused, ref):
        assert _cos(mega, other).mean() > 0.9999
        np.testing.assert_allclose(mega, other, atol=5e-3, rtol=1e-2)


# ---- the whole KEEP model -------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_keep_matches_jax(jparams, dtype):
    """The port's KEEPModel.quantize() against the JAX package's on the
    same weights, both on the megakernel path. The JAX patch embed and head
    take its dividing XLA fallback on the CPU (ops/nn.py:67-69) where the
    port multiplies by the reciprocal, as the kernels do, hence the rare
    int8 code flip inside the tolerance."""
    px, ids, mask = _inputs()
    jm = jkeep.KEEPModel(params=jparams, cfg=JCFG, dtype=getattr(jnp, dtype),
                         use_flash=True, gelu_approx=True).quantize()
    port = _port_model(jparams, dtype=getattr(torch, dtype), use_flash=True,
                       gelu_approx=True).quantize()
    assert port.use_flash and port.gelu_approx
    with torch.no_grad():
        got_i = port.encode_image(_t(px)).numpy()
        got_t = port.encode_text(_t(ids), _t(mask)).numpy()
    ref_i = np.asarray(jm.encode_image(jnp.asarray(px)))
    ref_t = np.asarray(jm.encode_text(jnp.asarray(ids), jnp.asarray(mask)))
    for got, ref in ((got_i, ref_i), (got_t, ref_t)):
        assert _cos(got, ref).min() >= 0.9999
        np.testing.assert_allclose(got, ref, atol=2e-2)


def test_from_pretrained_quantize(tmp_path):
    """from_pretrained(quantize=True) quantizes from the checkpoint's fp32
    values: the same codes as quantizing an fp32 model, with bf16 compute;
    a dir carrying the JAX package's quantized artifact raises."""
    sd = random_keep_state_dict(CFG, torch.Generator().manual_seed(4))
    torch.save(sd, tmp_path / "pytorch_model.bin")
    (tmp_path / "config.json").write_text(json.dumps({
        "vision_config": VISION, "text_config": TEXT,
        "projection_dim": 48}))
    q = KEEPModel.from_pretrained(str(tmp_path), dtype=torch.bfloat16,
                                  use_flash=True, quantize=True, device="cpu")
    f32 = KEEPModel.from_pretrained(str(tmp_path), device="cpu").quantize()
    assert q.dtype == torch.bfloat16 and q.gelu_approx
    for k, v in f32.state_dict().items():
        if k.endswith(("weight_q", "weight_scale")):
            torch.testing.assert_close(q.state_dict()[k], v, rtol=0, atol=0)
    (tmp_path / "quantized").mkdir()
    with pytest.raises(NotImplementedError, match="quantized artifact"):
        KEEPModel.from_pretrained(str(tmp_path), quantize=True, device="cpu")
