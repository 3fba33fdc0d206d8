"""The port's ConvNeXt (``keep_tpu_torch.models.convnext``) against the JAX
package's on the CPU: the JAX ``init``'s weights (norms, biases and
LayerScale moved), carried by ``compat.torch_loader.from_jax_tree`` with
each stage's own depth, agree at the JAX test's atol 1e-4 / rtol 1e-3 in
fp32, pooled and as the feature map, and at cosine ≥ 0.999 in bf16; the
HF and timm converters give the JAX converters' trees on one synthetic
state dict in each layout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keep_tpu.models import convnext as jconvnext
from keep_tpu_torch.compat.torch_loader import from_jax_tree
from keep_tpu_torch.models import convnext
from torch_zoo import as_np, cos_min, moved

TOL = dict(atol=1e-4, rtol=1e-3)
DIMS, DEPTHS = (16, 32, 48, 64), (1, 2, 1, 2)
JCFG = jconvnext.ConvNeXtConfig(img_size=64, depths=DEPTHS, dims=DIMS)
CFG = convnext.ConvNeXtConfig(img_size=64, depths=DEPTHS, dims=DIMS)


def _count(path):
    """Each stage's stacked blocks hold its own depth."""
    return len(DEPTHS) if path[-1] == "stages" else DEPTHS[int(path[-2])]


def _pair(seed=0):
    params = moved(jconvnext.init(jax.random.PRNGKey(seed), JCFG))
    m = convnext.ConvNeXt(CFG)
    m.load_state_dict(from_jax_tree(params, _count), strict=True)
    return params, m.eval()


@pytest.mark.parametrize("pool", [True, False])
def test_convnext_matches_jax(rng, pool):
    params, m = _pair()
    x = rng.standard_normal((2, 64, 64, 3), dtype=np.float32)
    with torch.no_grad():
        got = m(torch.from_numpy(x), pool=pool)
    ref = jconvnext.forward(params, jnp.asarray(x), JCFG, pool=pool)
    assert got.shape == ref.shape == ((2, 64) if pool else (2, 2, 2, 64))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_convnext_bf16_matches_jax(rng):
    params, m = _pair(1)
    x = rng.standard_normal((2, 64, 64, 3), dtype=np.float32)
    with torch.no_grad():
        got = m(torch.from_numpy(x), dtype=torch.bfloat16)
    ref = jconvnext.forward(params, jnp.asarray(x), JCFG, dtype=jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    assert cos_min(got, np.asarray(ref.astype(jnp.float32))) >= 0.999


def test_stack_count_is_per_stage():
    """A stage whose stack holds another depth than its config's is
    refused (the walk counts per stage, not per tower)."""
    params = jconvnext.init(jax.random.PRNGKey(0), JCFG)
    with pytest.raises(ValueError, match="stages.1.blocks has 2"):
        from_jax_tree(params, lambda path: 4 if path[-1] == "stages" else 1)


def _hf_sd(rng):
    r = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32) * 0.1)
    sd = {"embeddings.patch_embeddings.weight": r(DIMS[0], 3, 4, 4),
          "embeddings.patch_embeddings.bias": r(DIMS[0]),
          "embeddings.layernorm.weight": r(DIMS[0]),
          "embeddings.layernorm.bias": r(DIMS[0]),
          "layernorm.weight": r(DIMS[-1]), "layernorm.bias": r(DIMS[-1])}
    for s, (depth, d) in enumerate(zip(DEPTHS, DIMS)):
        pre = f"encoder.stages.{s}."
        for i in range(depth):
            b = pre + f"layers.{i}."
            sd[b + "dwconv.weight"] = r(d, 1, 7, 7)
            sd[b + "dwconv.bias"] = r(d)
            sd[b + "layernorm.weight"], sd[b + "layernorm.bias"] = r(d), r(d)
            sd[b + "pwconv1.weight"], sd[b + "pwconv1.bias"] = r(4 * d, d), \
                r(4 * d)
            sd[b + "pwconv2.weight"], sd[b + "pwconv2.bias"] = r(d, 4 * d), \
                r(d)
            sd[b + "layer_scale_parameter"] = r(d)
        if s:
            c = DIMS[s - 1]
            sd[pre + "downsampling_layer.0.weight"] = r(c)
            sd[pre + "downsampling_layer.0.bias"] = r(c)
            sd[pre + "downsampling_layer.1.weight"] = r(d, c, 2, 2)
            sd[pre + "downsampling_layer.1.bias"] = r(d)
    return sd


def _timm_sd(hf):
    """The same values under timm's keys."""
    out = {"stem.0." + leaf: hf["embeddings.patch_embeddings." + leaf]
           for leaf in ("weight", "bias")}
    for leaf in ("weight", "bias"):
        out["stem.1." + leaf] = hf["embeddings.layernorm." + leaf]
        out["head.norm." + leaf] = hf["layernorm." + leaf]
    ren = {"dwconv": "conv_dw", "layernorm": "norm", "pwconv1": "mlp.fc1",
           "pwconv2": "mlp.fc2"}
    for s, depth in enumerate(DEPTHS):
        src, dst = f"encoder.stages.{s}.", f"stages.{s}."
        for i in range(depth):
            for old, new in ren.items():
                for leaf in ("weight", "bias"):
                    out[f"{dst}blocks.{i}.{new}.{leaf}"] = hf[
                        f"{src}layers.{i}.{old}.{leaf}"]
            out[f"{dst}blocks.{i}.gamma"] = hf[
                f"{src}layers.{i}.layer_scale_parameter"]
        if s:
            for j in (0, 1):
                for leaf in ("weight", "bias"):
                    out[f"{dst}downsample.{j}.{leaf}"] = hf[
                        f"{src}downsampling_layer.{j}.{leaf}"]
    return out


@pytest.mark.parametrize("layout", ["hf", "timm"])
def test_converters_match_jax(rng, layout):
    sd = _hf_sd(rng)
    if layout == "timm":
        sd = _timm_sd(sd)
        got, jtree = (convnext.convert_timm_convnext(sd, CFG),
                      jconvnext.convert_timm_convnext(sd, JCFG))
    else:
        got, jtree = (convnext.convert_hf_convnext(sd, CFG),
                      jconvnext.convert_hf_convnext(sd, JCFG))
    ref = from_jax_tree(jtree, _count)
    assert got.keys() == ref.keys() and len(got) == len(sd)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    m = convnext.ConvNeXt(CFG)
    m.load_state_dict(got, strict=True)
    x = rng.standard_normal((1, 64, 64, 3), dtype=np.float32)
    with torch.no_grad():
        out = m.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jconvnext.forward(
        jax.tree.map(jnp.asarray, jtree), jnp.asarray(x), JCFG)), **TOL)


def test_init_statistics():
    m = convnext.ConvNeXt(CFG).init_weights(torch.Generator().manual_seed(0))
    w = m.stages[2].blocks[0].fc1.weight.detach()
    assert float(w.abs().max()) <= 0.04 and abs(w.std().item() - 0.0176) < 3e-3
    assert torch.all(m.stages[1].blocks[1].gamma.detach() == 1e-6)
    assert as_np(m.norm.weight).tolist() == [1.0] * DIMS[-1]
