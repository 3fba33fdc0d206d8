"""The port's ops, towers and KEEP API against the JAX package on the same
weights and inputs (CPU, tiny widths). The JAX side runs with
``use_flash=True`` where the slice does, so its Pallas kernel runs in
interpret mode. fp32 comparisons hold 2e-5; bf16 ones cosine ≥ 0.999."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keep_tpu import configs as jcfgs
from keep_tpu.compat.torch_loader import convert_keep_state_dict
from keep_tpu.models import bert as jbert
from keep_tpu.models import keep as jkeep
from keep_tpu.models import vit as jvit
from keep_tpu.ops import nn as jnn
from keep_tpu.utils.golden import load_bundle
from keep_tpu_torch import configs
from keep_tpu_torch.compat.torch_loader import (from_jax_params,
                                                load_keep_state_dict,
                                                random_keep_state_dict)
from keep_tpu_torch.models import bert, vit
from keep_tpu_torch.models.keep import KEEPModel
from keep_tpu_torch.ops import nn
from tests.test_keep_api import build_torch_keep

VISION = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4)
TEXT = dict(vocab_size=128, hidden_size=48, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=96,
            max_position_embeddings=64)
JCFG = jcfgs.KEEPConfig(vision=jcfgs.ViTConfig(**VISION),
                        text=jcfgs.BertConfig(**TEXT), projection_dim=48)
CFG = configs.KEEPConfig(vision=configs.ViTConfig(**VISION),
                         text=configs.BertConfig(**TEXT), projection_dim=48)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(scope="module")
def jparams():
    params = jkeep.init(jax.random.PRNGKey(0), JCFG)
    # non-trivial LayerScale so that every block moves the stream
    blocks = dict(params["visual"]["blocks"])
    blocks["ls1"] = blocks["ls1"] + 0.3
    blocks["ls2"] = blocks["ls2"] + 0.2
    params["visual"] = dict(params["visual"], blocks=blocks)
    return params


@pytest.fixture(scope="module")
def port(jparams):
    m = KEEPModel(CFG)
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


def _cos(a, b):
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))


# ---- ops ------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_matches_jax(rng, dtype):
    x = rng.standard_normal((5, 7, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 48)) * 0.1).astype(np.float32)
    b = rng.standard_normal(48).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = np.asarray(jnn.linear({"kernel": jnp.asarray(w),
                                 "bias": jnp.asarray(b)},
                                jnp.asarray(x).astype(jdt))).astype(np.float32)
    got = nn.linear(torch.from_numpy(x).to(tdt), torch.from_numpy(w.T.copy()),
                    torch.from_numpy(b))
    assert got.dtype == tdt
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)
    else:  # one rounding of the fp32 product + bias, as in the JAX package
        _assert_bf16_rounded_once(got, ref)


def _bf16_ulp(a: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values (8 significant bits) at |a|."""
    e = np.floor(np.log2(np.maximum(np.abs(a), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _assert_bf16_rounded_once(got: np.ndarray, ref: np.ndarray) -> None:
    """bf16 results of the same fp32 sums taken in another order: at most
    one bf16 ulp apart, and equal but for a share under 1e-3 (a product
    rounded to bf16 before the bias add differs in a quarter of them). The
    ulp is taken at no less than 2⁻⁶: below that a sum that cancels is
    decided by the fp32 summation's own error (~1e-5 at K = 1024)."""
    diff = np.abs(got - ref)
    ulp = _bf16_ulp(np.maximum(np.abs(ref), 2.0 ** -6))
    assert (diff <= ulp).all(), diff.max()
    assert np.count_nonzero(diff) / diff.size < 1e-3


def test_linear_rounds_once_like_jax():
    """At the ViT-L shape, x [8, 197, 1024] bf16 × W [1024, 1024] + an fp32
    bias: the JAX package's single rounding."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((8, 197, 1024)).astype(np.float32)
    w = (rng.standard_normal((1024, 1024)) * 1024 ** -0.5).astype(np.float32)
    b = (rng.standard_normal(1024) * 0.1).astype(np.float32)
    ref = np.asarray(jnn.linear({"kernel": jnp.asarray(w),
                                 "bias": jnp.asarray(b)},
                                jnp.asarray(x).astype(jnp.bfloat16)))
    got = nn.linear(torch.from_numpy(x).bfloat16(),
                    torch.from_numpy(w.T.copy()).bfloat16(),
                    torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    _assert_bf16_rounded_once(got.float().numpy(), ref.astype(np.float32))


@pytest.mark.parametrize("weight_dtype", [torch.float32, torch.bfloat16])
def test_linear_round_once_gradients_match_autograd(rng, weight_dtype):
    """The bf16 linear's backward gives the gradients that autograd gives
    through a bf16 ``F.linear`` and an fp32 bias add: dx and dw from the
    bf16 products (dw cast to the weight's dtype), db summed in fp32."""
    x = torch.from_numpy(rng.standard_normal((3, 5, 32)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((24, 32)) * 0.2)
                         .astype(np.float32)).to(weight_dtype)
    b = torch.from_numpy(rng.standard_normal(24).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((3, 5, 24)).astype(np.float32))

    def grads(fn):
        xx = x.bfloat16().requires_grad_()
        ww = w.clone().requires_grad_()
        bb = b.clone().requires_grad_()
        fn(xx, ww, bb).backward(dy.bfloat16())
        return xx.grad, ww.grad, bb.grad

    def autograd_linear(xx, ww, bb):
        out = torch.nn.functional.linear(xx, ww.to(xx.dtype))
        return (out.float() + bb.float()).to(xx.dtype)

    for got, want in zip(grads(nn.linear), grads(autograd_linear)):
        assert got.dtype == want.dtype
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_layer_norm_matches_jax(rng):
    x = rng.standard_normal((4, 9, 64)).astype(np.float32) * 3 + 1
    g = rng.random(64).astype(np.float32) + 0.5
    b = rng.standard_normal(64).astype(np.float32)
    ref = np.asarray(jnn.layer_norm({"scale": jnp.asarray(g),
                                     "bias": jnp.asarray(b)},
                                    jnp.asarray(x), 1e-6))
    got = nn.layer_norm(torch.from_numpy(x), torch.from_numpy(g),
                        torch.from_numpy(b), 1e-6).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)
    # bf16 input: the statistics are still fp32, the result bf16
    xb = torch.from_numpy(x).bfloat16()
    assert nn.layer_norm(xb, torch.from_numpy(g), torch.from_numpy(b),
                         1e-6).dtype == torch.bfloat16


@pytest.mark.parametrize("approximate", [False, True])
def test_gelu_matches_jax(rng, approximate):
    x = rng.standard_normal((1000,)).astype(np.float32) * 4
    ref = np.asarray(jnn.gelu(jnp.asarray(x), approximate=approximate))
    got = nn.gelu(torch.from_numpy(x), approximate=approximate).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)


def test_l2_normalize_matches_jax(rng):
    x = rng.standard_normal((6, 48)).astype(np.float32)
    x[0] = 0.0  # F.normalize's eps floor: zero rows stay zero
    ref = np.asarray(jnn.l2_normalize(jnp.asarray(x)))
    got = nn.l2_normalize(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)


def test_mha_attention_matches_jax(rng):
    q, k, v = (rng.standard_normal((2, 3, 17, 16)).astype(np.float32)
               for _ in range(3))
    bias = np.zeros((2, 1, 1, 17), np.float32)
    bias[1, ..., 9:] = -1e9
    ref = np.asarray(jnn.mha_attention(*map(jnp.asarray, (q, k, v)),
                                       bias=jnp.asarray(bias)))
    got = nn.mha_attention(*map(torch.from_numpy, (q, k, v)),
                           bias=torch.from_numpy(bias)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)


def test_quantized_linear_dispatches_to_qmatmul(rng, monkeypatch):
    """A QLinear runs the int8 matmul of kernels.qmatmul (the flat form for
    2-D inputs, the bsd form for 3-D), and matches the JAX package's int8
    linear on the same quantized weights."""
    from keep_tpu.quant import quantize_kernel
    from keep_tpu_torch.kernels import qmatmul

    w = (rng.standard_normal((64, 48)) * 0.1).astype(np.float32)
    b = rng.standard_normal(48).astype(np.float32)
    q = quantize_kernel(jnp.asarray(w))
    lin = nn.QLinear.from_quantized(
        torch.from_numpy(np.array(q["kernel_q"]).T.copy()),
        torch.from_numpy(np.array(q["scale"])), torch.from_numpy(b))
    calls = []
    for name in ("quantized_matmul", "quantized_matmul_bsd"):
        orig = getattr(qmatmul, name)
        monkeypatch.setattr(qmatmul, name, lambda *a, _n=name, _f=orig, **k:
                            calls.append(_n) or _f(*a, **k))
    x = rng.standard_normal((5, 7, 64)).astype(np.float32)
    got = lin(torch.from_numpy(x))
    lin(torch.from_numpy(x[0]))
    assert calls == ["quantized_matmul_bsd", "quantized_matmul"]
    ref = np.asarray(jnn.linear({**q, "bias": jnp.asarray(b)},
                                jnp.asarray(x)))
    # the JAX CPU fallback divides by the row scale where the kernels
    # multiply by its reciprocal: a rare code flip, inside the int8 tolerance
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-2, rtol=1e-2)


# ---- towers ---------------------------------------------------------------


@pytest.mark.parametrize("use_flash", [False, True])
def test_vit_matches_jax(jparams, port, use_flash):
    px, _, _ = _inputs()
    ref = np.asarray(jvit.forward(jparams["visual"], jnp.asarray(px),
                                  JCFG.vision, use_flash=use_flash))
    with torch.no_grad():
        got = port.visual(torch.from_numpy(px), use_flash=use_flash).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("use_flash", [False, True])
def test_bert_matches_jax(jparams, port, use_flash):
    _, ids, mask = _inputs()
    ref = jbert.forward(jparams["text"], jnp.asarray(ids), jnp.asarray(mask),
                        cfg=JCFG.text, use_flash=use_flash)
    with torch.no_grad():
        got = port.text(torch.from_numpy(ids), torch.from_numpy(mask),
                        use_flash=use_flash)
    np.testing.assert_allclose(got["pooler_output"].numpy(),
                               np.asarray(ref["pooler_output"]),
                               atol=2e-5, rtol=2e-5)
    valid = mask.astype(bool)
    np.testing.assert_allclose(got["last_hidden_state"].numpy()[valid],
                               np.asarray(ref["last_hidden_state"])[valid],
                               atol=2e-5, rtol=2e-5)


def test_encode_image_and_text_match_jax(jparams, port):
    px, ids, mask = _inputs()
    ref_i = np.asarray(jkeep.encode_image(jparams, jnp.asarray(px), JCFG,
                                          use_flash=True))
    ref_t = np.asarray(jkeep.encode_text(jparams, jnp.asarray(ids),
                                         jnp.asarray(mask), cfg=JCFG,
                                         use_flash=True))
    flash = KEEPModel(CFG, use_flash=True)
    flash.load_state_dict(port.state_dict())
    with torch.no_grad():
        got_i = flash.encode_image(torch.from_numpy(px)).numpy()
        got_t = flash.encode_text(torch.from_numpy(ids),
                                  torch.from_numpy(mask)).numpy()
    assert got_i.shape == (2, 48) and got_t.shape == (3, 48)
    np.testing.assert_allclose(got_i, ref_i, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got_t, ref_t, atol=2e-5, rtol=2e-5)


def test_bf16_towers_match_jax(jparams):
    """bf16 with the fused attention and tanh GELU on both sides (the
    serving setting): features agree to cosine ≥ 0.999."""
    px, ids, mask = _inputs()
    kw = dict(dtype=jnp.bfloat16, use_flash=True, gelu_approx=True)
    ref_i = np.asarray(jkeep.encode_image(jparams, jnp.asarray(px), JCFG, **kw))
    ref_t = np.asarray(jkeep.encode_text(jparams, jnp.asarray(ids),
                                         jnp.asarray(mask), cfg=JCFG, **kw))
    m = KEEPModel(CFG, dtype=torch.bfloat16, use_flash=True)
    assert m.gelu_approx is True  # None = tanh under bf16
    m.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jparams), CFG))
    assert m.visual.blocks[0].attn.qkv.weight.dtype == torch.bfloat16
    assert m.visual.blocks[0].norm1.weight.dtype == torch.float32
    with torch.no_grad():
        got_i = m.encode_image(torch.from_numpy(px)).numpy()
        got_t = m.encode_text(torch.from_numpy(ids),
                              torch.from_numpy(mask)).numpy()
    assert _cos(got_i, ref_i).min() >= 0.999
    assert _cos(got_t, ref_t).min() >= 0.999


def test_fold_layerscale_matches_jax(jparams, port):
    px, _, _ = _inputs()
    ref = np.asarray(jvit.forward(jvit.fold_layerscale(jparams["visual"]),
                                  jnp.asarray(px), JCFG.vision))
    folded = KEEPModel(CFG)
    folded.load_state_dict(port.state_dict())
    vit.fold_layerscale(folded.visual)
    assert folded.visual.blocks[0].ls1 is None
    assert not any(".ls1" in k for k in folded.visual.state_dict())
    with torch.no_grad():
        got = folded.visual(torch.from_numpy(px)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)


def test_non_native_image_size_raises(port):
    with pytest.raises(ValueError, match="native"):
        port.encode_image(torch.zeros(1, 48, 48, 3))


def test_patchify_matches_jax(rng):
    x = rng.standard_normal((2, 32, 16, 3)).astype(np.float32)
    d = 24
    w = rng.standard_normal((8 * 8 * 3, d)).astype(np.float32)
    ref = np.asarray(jvit.patchify({"kernel": jnp.asarray(w),
                                    "bias": jnp.zeros(d)}, jnp.asarray(x), 8))
    got = vit.patchify(torch.from_numpy(x), 8) @ torch.from_numpy(w)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=2e-5)


# ---- checkpoint layouts ---------------------------------------------------


def test_released_layout_matches_jax_converter():
    """A released-layout state dict (timm ViT + HF BERT) loaded by the port
    and by the JAX converter gives the same features."""
    *_, sd = build_torch_keep(JCFG)
    jp = convert_keep_state_dict(sd, JCFG)
    m = KEEPModel(CFG, use_flash=True)
    m.load_state_dict(load_keep_state_dict(sd, CFG))
    px, ids, mask = _inputs()
    ref_i = np.asarray(jkeep.encode_image(jp, jnp.asarray(px), JCFG,
                                          use_flash=True))
    ref_t = np.asarray(jkeep.encode_text(jp, jnp.asarray(ids),
                                         jnp.asarray(mask), cfg=JCFG,
                                         use_flash=True))
    with torch.no_grad():
        np.testing.assert_allclose(m.encode_image(torch.from_numpy(px)),
                                   ref_i, atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(
            m.encode_text(torch.from_numpy(ids), torch.from_numpy(mask)),
            ref_t, atol=2e-5, rtol=2e-5)


def test_released_key_quirks():
    """DDP prefixes, position_ids buffers and the training wrapper load to
    the identical state dict, as in the JAX converter."""
    *_, sd = build_torch_keep(JCFG)
    clean = load_keep_state_dict(sd, CFG)
    quirky = {f"module.{k}": v for k, v in sd.items()}
    quirky["module.text.embeddings.position_ids"] = torch.arange(64)[None]
    got = load_keep_state_dict({"state_dict": quirky, "epoch": 3}, CFG)
    assert got.keys() == clean.keys()
    for k in clean:
        torch.testing.assert_close(got[k], clean[k], rtol=0, atol=0)


def test_random_released_state_dict_loads_in_both():
    sd = random_keep_state_dict(CFG, torch.Generator().manual_seed(3))
    jp = convert_keep_state_dict(sd, JCFG)
    m = KEEPModel(CFG)
    m.load_state_dict(load_keep_state_dict(sd, CFG))
    px, ids, mask = _inputs()
    ref = np.asarray(jkeep.encode_image(jp, jnp.asarray(px), JCFG))
    with torch.no_grad():
        got = m.encode_image(torch.from_numpy(px)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)


def test_random_state_dict_keep_init_statistics():
    """keep_init=True draws with the JAX package's keep.init statistics: the
    LayerScale gammas at layerscale_init, unit LayerNorms, zero biases,
    BERT weights std .02, ViT weights std fan_in^-0.5; the default draw is
    unchanged by the option."""
    gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    sd = random_keep_state_dict(CFG, gen(), keep_init=True)
    assert sd.keys() == random_keep_state_dict(CFG, gen()).keys()
    assert (sd["visual.blocks.0.ls1.gamma"] == 1e-5).all()
    assert (sd["visual.blocks.1.norm2.weight"] == 1).all()
    assert (sd["text.encoder.layer.0.output.LayerNorm.bias"] == 0).all()
    assert (sd["visual.blocks.0.attn.qkv.bias"] == 0).all()
    bert_w = sd["text.encoder.layer.1.intermediate.dense.weight"]
    assert abs(bert_w.std().item() - 0.02) < 2e-3
    vit_w = sd["visual.blocks.0.mlp.fc2.weight"]  # fan_in 256
    assert abs(vit_w.std().item() - 256 ** -0.5) < 5e-3
    default = random_keep_state_dict(CFG, gen())
    torch.testing.assert_close(
        default["visual.blocks.0.ls1.gamma"],
        random_keep_state_dict(CFG, gen())["visual.blocks.0.ls1.gamma"])
    assert default["visual.blocks.0.ls1.gamma"].min() >= 0.1


def test_from_pretrained_matches_jax(tmp_path):
    sd = random_keep_state_dict(CFG, torch.Generator().manual_seed(4))
    torch.save(sd, tmp_path / "pytorch_model.bin")
    (tmp_path / "config.json").write_text(json.dumps({
        "vision_config": VISION,
        "text_config": {k: v for k, v in TEXT.items()},
        "projection_dim": 48}))
    ours = KEEPModel.from_pretrained(str(tmp_path), use_flash=True,
                                     device="cpu")
    theirs = jkeep.KEEPModel.from_pretrained(str(tmp_path), use_flash=True)
    assert ours.cfg.vision.depth == 2 and ours.cfg.text.hidden_size == 48
    px, ids, mask = _inputs()
    with torch.no_grad():
        np.testing.assert_allclose(
            ours.encode_image(torch.from_numpy(px)),
            np.asarray(theirs.encode_image(jnp.asarray(px))),
            atol=2e-5, rtol=2e-5)
        np.testing.assert_allclose(
            ours.encode_text(torch.from_numpy(ids), torch.from_numpy(mask)),
            np.asarray(theirs.encode_text(jnp.asarray(ids),
                                          jnp.asarray(mask))),
            atol=2e-5, rtol=2e-5)
    with pytest.raises(FileNotFoundError):
        KEEPModel.from_pretrained(str(tmp_path / "missing"), cfg=CFG)


def test_from_pretrained_defaults_to_the_card(tmp_path, monkeypatch):
    """Without a card ``from_pretrained`` raises and names device="cpu"; it
    never loads onto the CPU by itself. With device="cpu" it loads there."""
    sd = random_keep_state_dict(CFG, torch.Generator().manual_seed(4))
    torch.save(sd, tmp_path / "pytorch_model.bin")
    (tmp_path / "config.json").write_text(json.dumps({
        "vision_config": VISION, "text_config": TEXT, "projection_dim": 48}))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            KEEPModel.from_pretrained(str(tmp_path), device=device)
    model = KEEPModel.from_pretrained(str(tmp_path), device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}


def test_golden_bert_small_replays_on_port():
    """The frozen transformers.BertModel outputs replay against the port."""
    b = load_bundle(os.path.join(GOLDEN, "bert_small.npz"))
    tcfg = configs.BertConfig(**{k: int(v) for k, v in b["cfg"].items()})
    kcfg = configs.KEEPConfig(text=tcfg)
    sd = from_jax_params({"text": b["params"]}, kcfg)
    model = bert.BertModel(tcfg)
    model.load_state_dict({k[len("text."):]: v for k, v in sd.items()})
    ids = torch.from_numpy(b["inputs"]["ids"].astype(np.int64))
    mask = torch.from_numpy(b["inputs"]["mask"].astype(np.int64))
    with torch.no_grad():
        out = model(ids, mask)
        out_tt = model(ids, mask, torch.from_numpy(
            b["inputs"]["token_type_ids"].astype(np.int64)))
    np.testing.assert_allclose(out["pooler_output"].numpy(),
                               b["expected"]["pooler_output"],
                               atol=2e-5, rtol=2e-5)
    keep = b["inputs"]["mask"].astype(bool)
    np.testing.assert_allclose(out["last_hidden_state"].numpy()[keep],
                               b["expected"]["last_hidden_state"][keep],
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(out_tt["pooler_output"].numpy(),
                               b["expected"]["pooler_output_tt"],
                               atol=2e-5, rtol=2e-5)
