"""SmoothQuant calibration in the port (``keep_tpu_torch.quant``, the towers'
``ln_stats`` forwards, ``KEEPModel.quantize(calib_pixels, calib_text)``)
against the JAX package on the same weights and calibration inputs (CPU,
tiny widths). Twins of ``tests/test_quant.py``'s calibration cases, plus:

- the LayerNorm statistics of both towers against JAX's at 2e-5 (fp32);
- given JAX's statistics, the smoothing scale ``s`` equal to JAX's at rtol
  1e-6, and after quantization the weight scales at rtol 1e-6 and the int8
  codes within 1 of JAX's in at most 1e-4 of the entries (``s`` comes from
  ``pow``, ``log``, ``exp`` and a mean in fp32, where torch and XLA's CPU
  may differ by an ulp and move a code at a rounding tie; the count is
  printed);
- the calibrated int8 features against the JAX package's calibrated model
  (its Pallas kernels in interpret mode) at the gate between two int8
  routes, cosine > 0.9999 (``tests/test_quant.py:285,303``'s forms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keep_tpu import configs as jcfgs
from keep_tpu import quant as jquant
from keep_tpu.models import bert as jbert
from keep_tpu.models import keep as jkeep
from keep_tpu.models import vit as jvit
from keep_tpu_torch import configs, quant
from keep_tpu_torch.compat.torch_loader import from_jax_params
from keep_tpu_torch.models import bert, vit
from keep_tpu_torch.models.keep import KEEPModel
from keep_tpu_torch.ops.nn import Linear, QLinear
from tests.test_quant import _cos, _outlier_bert, _outlier_params

VISION = dict(img_size=32, patch_size=8, embed_dim=64, depth=3, num_heads=4,
              layerscale_init=None)
TEXT = dict(vocab_size=128, hidden_size=48, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=96,
            max_position_embeddings=64)
KEEP_VISION = dict(img_size=32, patch_size=8, embed_dim=64, depth=2,
                   num_heads=4)
JCFG = jcfgs.KEEPConfig(vision=jcfgs.ViTConfig(**KEEP_VISION),
                        text=jcfgs.BertConfig(**TEXT), projection_dim=48)
CFG = configs.KEEPConfig(vision=configs.ViTConfig(**KEEP_VISION),
                         text=configs.BertConfig(**TEXT), projection_dim=48)
# the depth of the outlier ViT (test_quant.py's)
VCFG = configs.KEEPConfig(vision=configs.ViTConfig(**VISION),
                          text=configs.BertConfig(**TEXT), projection_dim=48)
# the share of int8 codes that may move by one against the JAX package's
CODE_SHARE = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _cos_rows(a, b):
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))


def _cos_mean(a, b):
    """test_quant.py's ``_cos``: the mean of the per-row cosines."""
    return float(_cos_rows(a, b).mean())


def _cos_whole(a, b):
    a, b = a.ravel(), b.ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _vit(jparams, cfg=VISION):
    """The port's ViT holding a JAX ViT tree (fp32)."""
    tower = vit.VisionTransformer(configs.ViTConfig(**cfg))
    if "kernel_q" in jparams["blocks"]["attn"]["qkv"]:
        vit.fold_layerscale(tower)
        quant.quantize_linear_weights(tower)
    sd = from_jax_params({"visual": jax.tree.map(np.asarray, jparams)},
                         VCFG)
    tower.load_state_dict({k[len("visual."):]: v for k, v in sd.items()})
    return tower.eval()


def _bert(jparams):
    tower = bert.BertModel(configs.BertConfig(**TEXT))
    sd = from_jax_params({"text": jax.tree.map(np.asarray, jparams)}, CFG)
    tower.load_state_dict({k[len("text."):]: v for k, v in sd.items()})
    return tower.eval()


def _jvit_outliers():
    cfg = jcfgs.ViTConfig(**VISION)
    return cfg, _outlier_params(cfg)


def _jbert_outliers():
    cfg = jcfgs.BertConfig(**TEXT)
    return cfg, _outlier_bert(cfg)


def _ids_mask(rng, n=4, s=16, lens=(16, 12, 9, 16)):
    ids = rng.integers(1, TEXT["vocab_size"], (n, s))
    mask = (np.arange(s)[None, :] < np.array(lens)[:, None]).astype(np.int64)
    return ids, mask


# ---- the statistics forwards --------------------------------------------------


def test_vit_ln_stats_match_jax(rng):
    """``vit(..., ln_stats=True)``: the features and the [L, D] abs-max of
    norm1's and norm2's outputs equal the JAX package's at 2e-5."""
    jcfg, jp = _jvit_outliers()
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    ref, jstats = jvit.forward(jp, jnp.asarray(x), jcfg, ln_stats=True)
    tower = _vit(jp)
    with torch.no_grad():
        got, stats = tower(_t(x), ln_stats=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=2e-5)
    for k in ("qkv", "fc1"):
        assert stats[k].shape == (jcfg.depth, jcfg.embed_dim)
        np.testing.assert_allclose(stats[k].numpy(), np.asarray(jstats[k]),
                                   atol=2e-5, rtol=2e-5)
    assert quant.vit_ln_stats(tower, x)["qkv"].equal(stats["qkv"])


def test_bert_ln_stats_match_jax(rng):
    """``bert(..., ln_stats=True)``: the qkv and fc1 inputs' abs-max with
    the pad positions masked out, equal to the JAX package's at 2e-5; the
    padding changes them (the mask is read)."""
    jcfg, jp = _jbert_outliers()
    ids, mask = _ids_mask(rng)
    _, jstats = jbert.forward(jp, jnp.asarray(ids), jnp.asarray(mask),
                              cfg=jcfg, ln_stats=True)
    tower = _bert(jp)
    stats = quant.bert_ln_stats(tower, ids, mask)
    for k in ("qkv", "fc1"):
        assert stats[k].shape == (jcfg.num_hidden_layers, jcfg.hidden_size)
        np.testing.assert_allclose(stats[k].numpy(), np.asarray(jstats[k]),
                                   atol=2e-5, rtol=2e-5)
    unmasked = quant.bert_ln_stats(tower, ids)
    assert not torch.equal(unmasked["qkv"], stats["qkv"])


def test_ln_stats_need_the_unfused_fp_path(rng):
    """As ``vit.py:112`` / ``bert.py`` refuse: no statistics under
    ``fuse_ln`` or from quantized linears."""
    jcfg, jp = _jvit_outliers()
    tower = _vit(jp)
    x = _t(rng.standard_normal((1, 32, 32, 3)).astype(np.float32))
    with pytest.raises(ValueError, match="unfused fp path"):
        tower(x, use_flash=True, fuse_ln=True, ln_stats=True)
    quant.quantize_linear_weights(vit.fold_layerscale(tower))
    with pytest.raises(ValueError, match="unfused fp path"):
        tower(x, ln_stats=True)
    btower = quant.quantize_linear_weights(_bert(_jbert_outliers()[1]))
    with pytest.raises(ValueError, match="unquantized"):
        quant.bert_ln_stats(btower, np.ones((1, 4), np.int64))


# ---- the smoothing scale, the folds, the codes --------------------------------


@pytest.mark.parametrize("alpha", [0.5, 0.8])
@pytest.mark.parametrize("tower", ["vit_qkv", "vit_fc1", "bert_qkv",
                                   "bert_fc1"])
def test_smooth_scales_match_jax(rng, tower, alpha):
    """Given the JAX package's statistics and weights, ``s`` equals JAX's
    ``smooth_scales`` at rtol 1e-6 on every layer."""
    name, edge = tower.split("_")
    if name == "vit":
        jcfg, jp = _jvit_outliers()
        x = jnp.asarray(rng.standard_normal((4, 32, 32, 3), np.float32))
        _, stats = jvit.forward(jp, x, jcfg, ln_stats=True)
        mod = "attn" if edge == "qkv" else "mlp"
    else:
        jcfg, jp = _jbert_outliers()
        ids, mask = _ids_mask(rng)
        _, stats = jbert.forward(jp, jnp.asarray(ids), jnp.asarray(mask),
                                 cfg=jcfg, ln_stats=True)
        mod = "attn" if edge == "qkv" else "mlp"
    kernel = jp["blocks"][mod][edge]["kernel"]                   # [L, K, N]
    want = np.asarray(jquant.smooth_scales(stats[edge], kernel, alpha))
    for i in range(kernel.shape[0]):
        got = quant.smooth_scales(_t(stats[edge][i]),
                                  _t(kernel[i]).T.contiguous(), alpha)
        np.testing.assert_allclose(got.numpy(), want[i], rtol=1e-6, atol=0)


def _codes_against_jax(port: torch.nn.Module, jq: dict, prefix: str,
                       cfg=CFG) -> tuple[int, int]:
    """(codes differing, codes) of ``port``'s quantized linears against the
    JAX tree ``jq``; every code within 1 and the weight scales and
    ``pre_scale``s at rtol 1e-6."""
    want = from_jax_params({prefix: jax.tree.map(np.asarray, jq)}, cfg)
    got = port.state_dict()
    moved = total = 0
    for k, v in want.items():
        key = k[len(prefix) + 1:]
        if k.endswith("weight_q"):
            diff = (got[key].int() - v.int()).abs()
            assert diff.max() <= 1, k
            moved += int((diff > 0).sum())
            total += diff.numel()
        elif k.endswith(("weight_scale", "pre_scale")):
            torch.testing.assert_close(got[key], v, rtol=1e-6, atol=0)
    return moved, total


def test_smooth_quantize_vit_codes_match_jax(rng):
    """``smooth_quantize_vit`` on the same weights and calibration batch as
    JAX's: int8 codes within 1 in ≤ 1e-4 of the entries, scales at 1e-6."""
    jcfg, jp = _jvit_outliers()
    calib = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    jq = jquant.smooth_quantize_vit(jp, jnp.asarray(calib), jcfg)
    port = quant.smooth_quantize_vit(_vit(jp), calib)
    moved, total = _codes_against_jax(port, jq, "visual", VCFG)
    print(f"ViT: {moved} of {total} int8 codes differ from JAX's by one")
    assert moved <= CODE_SHARE * total


def test_smooth_quantize_bert_codes_match_jax(rng):
    jcfg, jp = _jbert_outliers()
    ids, mask = _ids_mask(rng)
    jq = jquant.smooth_quantize_bert(jp, jnp.asarray(ids), jnp.asarray(mask),
                                     jcfg)
    port = quant.smooth_quantize_bert(_bert(jp), ids, mask)
    assert port.blocks[0].attn.qkv.pre_scale is not None
    moved, total = _codes_against_jax(port, jq, "text")
    print(f"BERT: {moved} of {total} int8 codes differ from JAX's by one")
    assert moved <= CODE_SHARE * total


def test_smooth_vit_fold_is_exact(rng):
    """Smoothing alone (no quantization) does not change the model (twin of
    test_quant.py's), and its folded weights and LayerNorms equal the JAX
    package's ``smooth_vit`` on the same statistics."""
    jcfg, jp = _jvit_outliers()
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    tower = _vit(jp)
    with torch.no_grad():
        ref, stats = tower(_t(x), ln_stats=True)
    quant.smooth_vit(tower, stats)
    with torch.no_grad():
        got = tower(_t(x))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-4,
                               rtol=1e-4)
    jsm = jquant.smooth_vit(jp, jax.tree.map(jnp.asarray,
                                             {k: v.numpy() for k, v
                                              in stats.items()}))
    want = _vit(jsm).state_dict()
    for k, v in tower.state_dict().items():
        torch.testing.assert_close(v, want[k], rtol=1e-6, atol=1e-7)


def test_smooth_quantize_recovers_outlier_accuracy(rng):
    """With outlier channels plain W8A8 degrades and smoothing recovers the
    cosine (twin of test_quant.py's: naive < 0.99, smoothed > 0.999)."""
    _, jp = _jvit_outliers()
    calib = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    x = _t(rng.standard_normal((8, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        ref = _vit(jp)(x).numpy()
        naive = quant.quantize_linear_weights(_vit(jp))(x).numpy()
        smoothq = quant.smooth_quantize_vit(_vit(jp), calib)(x).numpy()
    assert _cos(naive, ref) < 0.99
    assert _cos(smoothq, ref) > 0.999


def test_smooth_bert_is_exact(rng):
    """``pre_scale`` smoothing alone does not change BERT (twin of
    test_quant.py's): weight columns ×s, the input ×1/s inside
    ``ops.nn.Linear``."""
    jcfg, jp = _jbert_outliers()
    ids, mask = _ids_mask(rng)
    tower = _bert(jp)
    with torch.no_grad():
        ref, stats = tower(_t(ids), _t(mask), ln_stats=True)
    quant.smooth_bert(tower, stats)
    assert tower.blocks[0].attn.qkv.pre_scale.shape == (jcfg.hidden_size,)
    with torch.no_grad():
        got = tower(_t(ids), _t(mask))
    np.testing.assert_allclose(got["pooler_output"].numpy(),
                               ref["pooler_output"].numpy(), atol=2e-4,
                               rtol=1e-4)


def test_smooth_quantize_bert_recovers_outliers(rng):
    """Twin of test_quant.py's: naive W8A8 < 0.999, the pre_scale form
    > 0.9999, against the fp forward of the same outlier model."""
    _, jp = _jbert_outliers()
    calib = rng.integers(1, TEXT["vocab_size"], (4, 16))
    ids = _t(rng.integers(1, TEXT["vocab_size"], (8, 16)))
    with torch.no_grad():
        ref = _bert(jp)(ids)["last_hidden_state"].numpy()
        naive = quant.quantize_linear_weights(_bert(jp))(ids)[
            "last_hidden_state"].numpy()
        sq = quant.smooth_quantize_bert(_bert(jp), calib)(ids)[
            "last_hidden_state"].numpy()
    # test_quant.py's ``_cos`` form (over axis 1, the tokens, here)
    assert _cos(naive, ref) < 0.999
    assert _cos(sq, ref) > 0.9999


def test_smoothed_bert_tree_loads_and_runs_as_jax(rng):
    """A JAX ``smooth_bert`` tree that was not quantized (``pre_scale``
    beside an fp kernel) loads through ``from_jax_params`` and runs as the
    JAX package runs it, at 2e-5; the smoothed model also round-trips
    through ``to_jax_params``."""
    from keep_tpu_torch.compat.torch_loader import to_jax_params

    jcfg, jp = _jbert_outliers()
    ids, mask = _ids_mask(rng)
    _, stats = jbert.forward(jp, jnp.asarray(ids), jnp.asarray(mask),
                             cfg=jcfg, ln_stats=True)
    jsm = jquant.smooth_bert(jp, stats)
    ref = jbert.forward(jsm, jnp.asarray(ids), jnp.asarray(mask), cfg=jcfg)
    tower = _bert(jsm)
    assert isinstance(tower.blocks[1].mlp.fc1, Linear)
    assert tower.blocks[1].mlp.fc1.pre_scale is not None
    with torch.no_grad():
        got = tower(_t(ids), _t(mask))
    for k in ("last_hidden_state", "pooler_output"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=2e-5, rtol=2e-5)
    back = to_jax_params({"text." + k: v for k, v
                          in tower.state_dict().items()}, CFG)["text"]
    np.testing.assert_array_equal(
        back["blocks"]["attn"]["qkv"]["pre_scale"],
        np.asarray(jsm["blocks"]["attn"]["qkv"]["pre_scale"]))


# ---- KEEPModel.quantize with calibration --------------------------------------


@pytest.fixture(scope="module")
def jparams():
    return jkeep.init(jax.random.PRNGKey(0), JCFG)


def _port(jparams, **kw) -> KEEPModel:
    m = KEEPModel(CFG, **kw)
    m.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jparams), CFG))
    return m.eval()


def _calib():
    rng = np.random.default_rng(11)
    px = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    ids, mask = _ids_mask(rng)
    return px, ids, mask


def test_keep_model_quantize_with_calibration(jparams, rng):
    """Twin of test_quant.py's: ``quantize(calib_pixels=...)`` keeps the
    image features within 0.995 of the float model, and the float model is
    unchanged."""
    m = _port(jparams)
    calib = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    x = _t(rng.standard_normal((3, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        before = m.encode_image(x)
    qm = m.quantize(calib_pixels=calib)
    with torch.no_grad():
        got = qm.encode_image(x).numpy()
        after = m.encode_image(x)
    assert torch.equal(before, after) and not quant.is_quantized(m)
    assert _cos_mean(got, before.numpy()) > 0.995


def test_keep_model_quantize_with_text_calibration(jparams, rng):
    """Twin of test_quant.py's: ``quantize(calib_text=...)`` carries the
    ``pre_scale`` into the quantized qkv (and fc1) of every text block."""
    qm = _port(jparams).quantize(
        calib_text=rng.integers(1, TEXT["vocab_size"], (2, 12)))
    for blk in qm.text.blocks:
        for lin in (blk.attn.qkv, blk.mlp.fc1):
            assert isinstance(lin, QLinear) and lin.pre_scale is not None
        assert blk.attn.out.pre_scale is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_calibrated_quantize_codes_match_jax(jparams, dtype):
    """``quantize(calib_pixels, calib_text=(ids, mask))`` on both towers:
    codes within 1 of the JAX package's in ≤ 1e-4 of the entries, scales
    and pre_scales at rtol 1e-6; a model that stores its weights in bf16
    calibrates and quantizes from the fp32 values it was loaded from, so it
    gives the fp32 model's codes bit for bit."""
    px, ids, mask = _calib()
    jm = jkeep.KEEPModel(params=jparams, cfg=JCFG).quantize(
        calib_pixels=jnp.asarray(px), calib_text=(jnp.asarray(ids),
                                                  jnp.asarray(mask)))
    port = _port(jparams, dtype=getattr(torch, dtype)).quantize(
        calib_pixels=px, calib_text=(ids, mask))
    moved = total = 0
    for prefix in ("visual", "text"):
        tower = getattr(port, prefix)
        mv, tot = _codes_against_jax(tower, jm.params[prefix], prefix)
        moved, total = moved + mv, total + tot
    print(f"{dtype}: {moved} of {total} int8 codes differ from JAX's by one")
    assert moved <= CODE_SHARE * total
    if dtype == "bfloat16":
        f32 = _port(jparams).quantize(calib_pixels=px,
                                      calib_text=(ids, mask)).state_dict()
        for k, v in port.state_dict().items():
            if k.endswith(("weight_q", "weight_scale", "pre_scale")):
                assert torch.equal(v, f32[k]), k


def test_calibrated_int8_features_match_jax(jparams):
    """The calibrated int8 KEEP, both on the megakernel path (JAX's Pallas
    kernels in interpret mode), against the JAX package's calibrated model
    at the gate between two int8 routes: image rows' mean cosine and the
    text features' cosine taken whole > 0.9999."""
    px, ids, mask = _calib()
    rng = np.random.default_rng(12)
    x = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    tids, tmask = _ids_mask(rng, lens=(16, 10, 16, 7))
    jm = jkeep.KEEPModel(params=jparams, cfg=JCFG, use_flash=True,
                         gelu_approx=True).quantize(
        calib_pixels=jnp.asarray(px),
        calib_text=(jnp.asarray(ids), jnp.asarray(mask)))
    port = _port(jparams, use_flash=True, gelu_approx=True).quantize(
        calib_pixels=px, calib_text=(ids, mask))
    assert all(b.int8_megakernel() for b in port.visual.blocks)
    with torch.no_grad():
        got_i = port.encode_image(_t(x)).numpy()
        got_t = port.encode_text(_t(tids), _t(tmask)).numpy()
    ref_i = np.asarray(jm.encode_image(jnp.asarray(x)))
    ref_t = np.asarray(jm.encode_text(jnp.asarray(tids), jnp.asarray(tmask)))
    assert _cos_mean(got_i, ref_i) > 0.9999
    assert _cos_whole(got_t, ref_t) > 0.9999


def test_quantize_refuses_moe_w8a16(jparams):
    """``moe_w8a16`` on a dense trunk changes nothing, as in the JAX package
    (its weight-only marker applies to the MoE experts alone): the same
    int8 model as ``quantize()``, and the float model untouched."""
    m = _port(jparams)
    a, b = m.quantize(moe_w8a16=True), m.quantize()
    assert not quant.is_quantized(m)
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)




# ---- the Switch-MoE trunk (tests/test_quant.py:697-880) ---------------------

MOE_VISION = dict(img_size=32, patch_size=8, embed_dim=64, depth=2,
                  num_heads=4, moe_experts=4, moe_capacity_factor=2.0,
                  moe_dispatch="gather")
MOE_CFG = configs.KEEPConfig(vision=configs.ViTConfig(**MOE_VISION),
                             text=configs.BertConfig(**TEXT),
                             projection_dim=48)


def _moe(jparams):
    """The port's MoE-ViT holding a JAX ``moe.init_vit`` tree (fp32)."""
    from keep_tpu_torch.models.moe import MoEVisionTransformer

    tower = MoEVisionTransformer(MOE_CFG.vision)
    sd = from_jax_params({"visual": jax.tree.map(np.asarray, jparams)},
                         MOE_CFG)
    tower.load_state_dict({k[len("visual."):]: v for k, v in sd.items()})
    return tower.eval()


def _jmoe_outliers():
    from tests.test_quant import _outlier_moe_params

    cfg = jcfgs.ViTConfig(**MOE_VISION)
    return cfg, _outlier_moe_params(cfg)


def test_smooth_moe_fold_is_exact(rng):
    """The statistics equal JAX's; smoothing alone changes neither the
    features (the JAX test's 2e-4 / 1e-4) nor the aux loss nor a single
    route (the router is compensated)."""
    from keep_tpu.models import moe as jmoe

    jcfg, jp = _jmoe_outliers()
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    _, _, jstats = jmoe.vit_forward(jp, jnp.asarray(x), jcfg, ln_stats=True)
    tower = _moe(jp)
    stats = quant.moe_ln_stats(tower, x)
    for k in ("qkv", "wi"):
        np.testing.assert_allclose(stats[k].numpy(), np.asarray(jstats[k]),
                                   rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        ref, aux_ref, routes = tower(_t(x), return_routes=True)
        quant.smooth_moe(tower, stats)
        got, aux, routes_sm = tower(_t(x), return_routes=True)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-4,
                               rtol=1e-4)
    assert aux.item() == pytest.approx(aux_ref.item(), rel=1e-5)
    assert torch.equal(routes, routes_sm)


def test_smooth_quantize_moe_codes_match_jax(rng):
    """``smooth_quantize_moe_vit`` on the same weights and calibration batch
    as JAX's: the stacked expert codes (per (expert, column) scales) and
    the trunk's as ``test_smooth_quantize_vit_codes_match_jax`` holds
    them."""
    jcfg, jp = _jmoe_outliers()
    calib = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    jq = jquant.smooth_quantize_moe_vit(jp, jnp.asarray(calib), jcfg)
    port = quant.smooth_quantize_moe_vit(_moe(jp), calib)
    assert port.blocks[0].moe.wi.weight_q.shape == (4, 256, 64)
    moved, total = _codes_against_jax(port, jq, "visual", MOE_CFG)
    print(f"MoE: {moved} of {total} int8 codes differ from JAX's by one")
    assert moved <= CODE_SHARE * total


def test_smooth_quantize_moe_recovers_outliers(rng):
    """The JAX test's claim on the port: plain W8A8 over outlier channels
    degrades below the clean model's quantization floor, the
    router-compensated fold recovers it (same thresholds)."""
    from keep_tpu.models import moe as jmoe
    from tests.test_quant import _cos

    jcfg, jp = _jmoe_outliers()
    calib = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    x = _t(rng.standard_normal((8, 32, 32, 3)).astype(np.float32))

    def feats(tower):
        with torch.no_grad():
            return tower(x)[0].numpy()

    clean = _moe(jax.tree.map(np.asarray, jmoe.init_vit(
        jax.random.PRNGKey(1), jcfg)))
    ref_c = feats(clean)
    floor = _cos(feats(quant.quantize_linear_weights(clean,
                                                     quant.MOE_TARGETS)),
                 ref_c)
    ref = feats(_moe(jp))
    naive = _cos(feats(quant.quantize_linear_weights(_moe(jp),
                                                     quant.MOE_TARGETS)), ref)
    smooth = _cos(feats(quant.smooth_quantize_moe_vit(_moe(jp), calib)), ref)
    assert naive < floor - 0.01, (naive, floor)
    assert smooth > floor - 0.005, (smooth, floor)


def test_keep_moe_quantize_with_calibration(rng):
    """``KEEPModel.quantize(calib_pixels=...)`` on an MoE config smooths
    through ``smooth_moe``: the experts int8, the features at the JAX
    test's cosine > 0.98 of the float model and at > 0.9999 of the JAX
    package's calibrated int8 model on the same weights."""
    jcfg = jcfgs.KEEPConfig(vision=jcfgs.ViTConfig(**MOE_VISION),
                            text=jcfgs.BertConfig(**TEXT), projection_dim=48)
    jp = jkeep.init(jax.random.PRNGKey(0), jcfg)
    jm = jkeep.KEEPModel(params=jp, cfg=jcfg)
    calib = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    x = rng.standard_normal((3, 32, 32, 3)).astype(np.float32)
    m = KEEPModel(MOE_CFG)
    m.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jp), MOE_CFG),
                      strict=True)
    qm = m.quantize(calib_pixels=calib)
    from keep_tpu_torch.models.moe import QExpertLinear

    assert isinstance(qm.visual.blocks[0].moe.wi, QExpertLinear)
    with torch.no_grad():
        ref, got = m.encode_image(_t(x)).numpy(), qm.encode_image(
            _t(x)).numpy()
    assert _cos_mean(got, ref) > 0.98
    want = np.asarray(jm.quantize(calib_pixels=jnp.asarray(calib))
                      .encode_image(jnp.asarray(x)))
    assert _cos_mean(got, want) > 0.9999


def test_moe_w8a16_marker_and_oracle(rng):
    """``weight_only`` makes the experts' ``wi`` / ``wo`` W8A16 (and only
    they are: qkv stays W8A8), ``KEEPModel.quantize(moe_w8a16=True)``
    gives them; the W8A16 expert linear is exactly a product against the
    dequantized weight in bf16, as the JAX branch oracle holds, and equals
    the JAX ``_expert_linear`` on the same codes."""
    from keep_tpu.models.moe import _expert_linear
    from keep_tpu_torch.models.moe import QExpertLinear

    jcfg = jcfgs.KEEPConfig(vision=jcfgs.ViTConfig(**MOE_VISION),
                            text=jcfgs.BertConfig(**TEXT), projection_dim=48)
    m = KEEPModel(MOE_CFG)
    m.load_state_dict(from_jax_params(jax.tree.map(
        np.asarray, jkeep.init(jax.random.PRNGKey(1), jcfg)), MOE_CFG))
    qm = m.quantize(moe_w8a16=True)
    blk = qm.visual.blocks[0]
    assert blk.moe.wi.w_only and blk.moe.wo.w_only
    assert isinstance(blk.attn.qkv, QLinear)
    assert not m.quantize().visual.blocks[0].moe.wi.w_only

    e, d, f = 4, 64, 96
    k = rng.standard_normal((e, d, f)).astype(np.float32) * 0.05
    b = rng.standard_normal((e, f)).astype(np.float32) * 0.01
    jp = {**jquant.quantize_kernel(jnp.asarray(k)), "bias": jnp.asarray(b),
          "w_only": ()}
    lin = QExpertLinear.from_quantized(
        _t(np.asarray(jp["kernel_q"]).transpose(0, 2, 1)),
        _t(np.asarray(jp["scale"])), _t(b), w_only=True)
    x = rng.standard_normal((e, 8, d)).astype(np.float32)
    with torch.no_grad():
        got = lin(_t(x).bfloat16())
    w = (lin.weight_q.bfloat16() * lin.weight_scale[:, :, None].bfloat16())
    want = torch.matmul(_t(x).bfloat16(), w.transpose(-1, -2)) \
        + _t(b)[:, None, :].bfloat16()
    assert torch.equal(got, want)
    jgot = _expert_linear(jp, jnp.asarray(x).astype(jnp.bfloat16),
                          "ecd,edf->ecf")
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jgot, np.float32), rtol=1e-2,
                               atol=1e-2)
