"""The port's ModifiedResNet and torchvision trunk (``keep_tpu_torch.models.
resnet``) against the JAX package's on the CPU: the same seeded inputs and
the JAX ``init``'s weights (norms and biases moved), carried by
``compat.torch_loader.from_jax_tree``, agree at the JAX tests' 5e-5 in
fp32 and at cosine ≥ 0.999 in bf16; the two converters give the JAX
converters' trees on one synthetic state dict in the real key layout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keep_tpu.models import resnet as jresnet
from keep_tpu_torch.compat.torch_loader import from_jax_tree
from keep_tpu_torch.models import resnet
from torch_zoo import as_np, cos_min, moved

TOL = dict(atol=5e-5, rtol=5e-5)
LAYERS = (1, 2, 1, 1)
JCFG = jresnet.ModifiedResNetConfig(layers=LAYERS, width=16, image_size=64,
                                    heads=4, output_dim=32)
CFG = resnet.ModifiedResNetConfig(layers=LAYERS, width=16, image_size=64,
                                  heads=4, output_dim=32)


def _stacks(prefix=()):
    return lambda path: None if path[:-1] != prefix else \
        LAYERS[int(path[-1][len("layer"):]) - 1]


def _pair(seed=0):
    params = moved(jresnet.init(jax.random.PRNGKey(seed), JCFG))
    m = resnet.ModifiedResNet(CFG)
    m.load_state_dict(from_jax_tree(params, _stacks()), strict=True)
    return params, m.eval()


@pytest.mark.parametrize("size", [64, 96])
def test_modified_resnet_matches_jax(rng, size):
    """At the config's size and at a larger one (the stride-2 stages and
    the mean-token pool at another grid; the pos embed is the config's
    size, so the larger image runs the trunk alone)."""
    params, m = _pair()
    x = rng.standard_normal((2, size, size, 3), dtype=np.float32)
    with torch.no_grad():
        if size == 64:
            got = m(torch.from_numpy(x))
            ref = jax.jit(lambda p, x: jresnet.forward(p, x, JCFG))(
                params, jnp.asarray(x))
        else:
            got = m.stem(torch.from_numpy(x))
            ref = jnp.asarray(x)
            ref = jax.nn.relu(jresnet.batch_norm(
                params["stem"]["bn1"], jresnet.conv(
                    params["stem"]["conv1"], ref, stride=2, padding=1), 1e-5))
            for i in (2, 3):
                ref = jax.nn.relu(jresnet.batch_norm(
                    params["stem"][f"bn{i}"], jresnet.conv(
                        params["stem"][f"conv{i}"], ref, padding=1), 1e-5))
            ref = jresnet.avg_pool(ref, 2)
            for li in range(1, 5):
                for bi, blk in enumerate(getattr(m, f"layer{li}")):
                    stride = 2 if (li > 1 and bi == 0) else 1
                    got = blk(got)
                    ref = jresnet.bottleneck(params[f"layer{li}"][bi], ref,
                                             stride, 1e-5)
    assert got.shape == ref.shape
    np.testing.assert_allclose(as_np(got), np.asarray(ref), **TOL)


def test_modified_resnet_bf16_matches_jax(rng):
    params, m = _pair(1)
    x = rng.standard_normal((2, 64, 64, 3), dtype=np.float32)
    with torch.no_grad():
        got = m(torch.from_numpy(x), dtype=torch.bfloat16)
    ref = jax.jit(lambda p, x: jresnet.forward(p, x, JCFG,
                                               dtype=jnp.bfloat16))(
        params, jnp.asarray(x))
    assert got.dtype == torch.bfloat16
    assert cos_min(got, np.asarray(ref.astype(jnp.float32))) >= 0.999


def test_batch_norm_folds_in_fp32_then_casts():
    """s = w / sqrt(var + eps) and t = b − mean·s are taken in fp32 and cast
    to the activations' dtype before x·s + t, as the JAX package's."""
    bn = resnet.BatchNorm(8)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for t in (bn.weight, bn.bias, bn.running_mean):
            t.copy_(torch.randn(8, generator=g))
        bn.running_var.copy_(torch.rand(8, generator=g) + 0.5)
    x = torch.randn(2, 3, 3, 8, generator=g)
    p = {"scale": bn.weight.detach().numpy(), "bias": bn.bias.detach().numpy(),
         "mean": bn.running_mean.numpy(), "var": bn.running_var.numpy()}
    # fp32 to an ulp (XLA may fuse the multiply-add); bf16 to one rounding
    for dtype, jdtype, tol in ((torch.float32, jnp.float32, 2e-6),
                               (torch.bfloat16, jnp.bfloat16, 2 ** -7)):
        with torch.no_grad():
            got = bn(x.to(dtype))
        assert got.dtype == dtype
        ref = jresnet.batch_norm(p, jnp.asarray(x.numpy()).astype(jdtype),
                                 1e-5)
        np.testing.assert_allclose(as_np(got),
                                   np.asarray(ref.astype(jnp.float32)),
                                   rtol=tol, atol=tol)


def _openai_rn_sd(rng, cfg, prefix=""):
    """A synthetic OpenAI ModifiedResNet state dict (torch layout)."""
    r = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32) * 0.1)
    sd = {}

    def bn(k, c):
        sd[k + ".weight"], sd[k + ".bias"] = r(c), r(c)
        sd[k + ".running_mean"] = r(c)
        sd[k + ".running_var"] = r(c).abs() + 0.5

    w = cfg.width
    for i, (ci, co) in enumerate([(3, w // 2), (w // 2, w // 2),
                                  (w // 2, w)], start=1):
        sd[f"{prefix}conv{i}.weight"] = r(co, ci, 3, 3)
        bn(f"{prefix}bn{i}", co)
    cin = w
    for li, depth in enumerate(cfg.layers, start=1):
        planes = w * 2 ** (li - 1)
        for bi in range(depth):
            p = f"{prefix}layer{li}.{bi}"
            sd[p + ".conv1.weight"] = r(planes, cin, 1, 1)
            sd[p + ".conv2.weight"] = r(planes, planes, 3, 3)
            sd[p + ".conv3.weight"] = r(planes * 4, planes, 1, 1)
            for i, c in ((1, planes), (2, planes), (3, planes * 4)):
                bn(f"{p}.bn{i}", c)
            if bi == 0:
                sd[p + ".downsample.0.weight"] = r(planes * 4, cin, 1, 1)
                bn(p + ".downsample.1", planes * 4)
            cin = planes * 4
    return sd


def test_convert_openai_resnet_matches_jax(rng):
    sd = _openai_rn_sd(rng, CFG)
    c = CFG.final_channels
    r = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    sd["attnpool.positional_embedding"] = r(CFG.spatial ** 2 + 1, c)
    for n, o in (("q", c), ("k", c), ("v", c), ("c", CFG.output_dim)):
        sd[f"attnpool.{n}_proj.weight"] = r(o, c)
        sd[f"attnpool.{n}_proj.bias"] = r(o)
    got = resnet.convert_openai_resnet(sd, CFG)
    ref = from_jax_tree(jresnet.convert_openai_resnet(sd, JCFG), _stacks())
    assert got.keys() == ref.keys()
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    m = resnet.ModifiedResNet(CFG)
    m.load_state_dict(got, strict=True)
    x = rng.standard_normal((2, 64, 64, 3), dtype=np.float32)
    with torch.no_grad():
        out = m.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jresnet.forward(
            jax.tree.map(jnp.asarray, jresnet.convert_openai_resnet(
                sd, JCFG)), jnp.asarray(x), JCFG)), **TOL)


def _torchvision_sd(rng, layers, width):
    sd = _openai_rn_sd(rng, resnet.ModifiedResNetConfig(layers=layers,
                                                        width=width))
    for i in (1, 2, 3):  # the torchvision stem is one 7×7 conv
        for k in [k for k in sd if k.startswith((f"conv{i}.", f"bn{i}."))]:
            del sd[k]
    r = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32) * 0.1)
    sd["conv1.weight"] = r(width, 3, 7, 7)
    sd["bn1.weight"], sd["bn1.bias"] = r(width), r(width)
    sd["bn1.running_mean"], sd["bn1.running_var"] = r(width), \
        r(width).abs() + 0.5
    sd["fc.weight"], sd["fc.bias"] = r(10, 32 * width), r(10)
    return sd


def test_torchvision_trunk_matches_jax(rng):
    """The KEP ``res_ssl`` trunk: converter trees equal, the pooled
    features at 5e-5, the trunk's shape read off the state dict."""
    layers = (1, 2, 1, 1)
    sd = _torchvision_sd(rng, layers, 8)
    got = resnet.convert_torchvision_resnet(sd, layers)
    jtree = jresnet.convert_torchvision_resnet(sd, layers)
    ref = from_jax_tree(jtree, lambda path: layers[int(path[-1][5:]) - 1])
    assert got.keys() == ref.keys()
    for k in ref:
        assert torch.equal(got[k], ref[k]), k
    trunk = resnet.ResNetTrunk.for_state_dict(got)
    assert trunk.layers == layers
    trunk.load_state_dict(got, strict=True)
    x = rng.standard_normal((2, 64, 64, 3), dtype=np.float32)
    with torch.no_grad():
        feats = resnet.resnet_trunk_pooled(trunk.eval(), torch.from_numpy(x))
    jparams = jax.tree.map(jnp.asarray, jtree)
    np.testing.assert_allclose(
        feats.numpy(), np.asarray(jresnet.resnet_trunk_pooled(
            jparams, jnp.asarray(x))), **TOL)
    with torch.no_grad():
        half = resnet.resnet_trunk_pooled(trunk, torch.from_numpy(x),
                                          dtype=torch.bfloat16)
    assert cos_min(half, np.asarray(jresnet.resnet_trunk_pooled(
        jparams, jnp.asarray(x), dtype=jnp.bfloat16).astype(
        jnp.float32))) >= 0.999


def test_init_statistics():
    m = resnet.ModifiedResNet.init(CFG, torch.Generator().manual_seed(0))
    w = m.layer2[0].conv2.weight
    assert abs(w.std().item() - (w.shape[1] * 9) ** -0.5) < 0.1 * (
        w.shape[1] * 9) ** -0.5
    assert torch.equal(m.stem.bn1.running_var, torch.ones(8))
    pe = m.attnpool.pos_embed
    assert abs(pe.std().item() - CFG.final_channels ** -0.5) < 0.01
    assert float(m.attnpool.q.bias.detach().abs().max()) == 0.0


def test_openai_loader_refuses_rn_naming_the_converter(rng):
    """An OpenAI RN checkpoint with no config: the port's loader refuses it
    with the JAX package's words, naming the (now ported) converter."""
    from keep_tpu.compat import openai as jopenai
    from keep_tpu_torch.compat import openai

    sd = {f"visual.{k}": v for k, v in _openai_rn_sd(rng, CFG).items()}
    sd["token_embedding.weight"] = torch.zeros(8, 4)
    with pytest.raises(ValueError) as got:
        openai.load_openai_clip(sd)
    with pytest.raises(ValueError) as want:
        jopenai.load_openai_clip(sd)
    assert str(got.value) == str(want.value)
    assert "models.resnet.convert_openai_resnet" in str(got.value)
