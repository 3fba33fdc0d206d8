"""The port's Switch-MoE MLP and trunk (``keep_tpu_torch.models.moe``)
against the JAX package's on the CPU: twins of ``tests/test_moe.py``
(routing, capacity drops per group and global, the aux loss, the int8
experts, dense parity with identical experts, top-2, the trunk's forward
and gradients, the KEEP integration, the gather dispatch, route tracing
and pinning), each on the JAX test's weights carried across and held to
the JAX function's output at 1e-5 in fp32 besides the JAX test's own
checks; the realized routes equal to JAX's for both dispatches. The
expert-parallel sharding test stays with ROADMAP queue 1, item 10."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keep_tpu import quant as jquant
from keep_tpu.configs import BertConfig as JBertConfig
from keep_tpu.configs import KEEPConfig as JKEEPConfig
from keep_tpu.configs import ViTConfig as JViTConfig
from keep_tpu.models import keep as jkeep
from keep_tpu.models import moe as jmoe
from keep_tpu.ops import nn as jnn
from keep_tpu_torch import configs, quant
from keep_tpu_torch.compat.torch_loader import from_jax_params, from_jax_tree
from keep_tpu_torch.models import moe
from keep_tpu_torch.models.keep import KEEPModel

TOL = dict(atol=1e-5, rtol=1e-5)


def tiny_cfg(**kw):
    return dict(embed_dim=32, depth=2, num_heads=4, mlp_ratio=2.0,
                patch_size=4, img_size=16, **kw)


def make_moe_params(key, d=32, f=64, e=4):
    """tests/test_moe.py's MoE MLP weights."""
    ks = jax.random.split(key, 4)
    return {
        "router": {"kernel": jax.random.normal(ks[0], (d, e)) * 0.02},
        "wi": {"kernel": jax.random.normal(ks[1], (e, d, f)) * d**-0.5,
               "bias": jnp.zeros((e, f))},
        "wo": {"kernel": jax.random.normal(ks[2], (e, f, d)) * f**-0.5,
               "bias": jnp.zeros((e, d))},
    }


def port_mlp(p) -> moe.MoEMLP:
    """The port's ``MoEMLP`` holding the JAX MoE weights ``p``."""
    d, e = p["router"]["kernel"].shape
    f = p["wi"]["kernel"].shape[-1]
    m = moe.MoEMLP(d, f, e)
    m.load_state_dict(from_jax_tree(jax.tree.map(np.asarray, p),
                                    lambda path: None), strict=True)
    return m


def dense_mlp(wi, wo, x):
    h = jax.nn.gelu(x @ wi["kernel"][0] + wi["bias"][0], approximate=False)
    return h @ wo["kernel"][0] + wo["bias"][0]


def _identical(p):
    for w in ("wi", "wo"):
        p[w] = {k: jnp.broadcast_to(v[:1], v.shape) for k, v in p[w].items()}
    return p


def _run(fn, p, x, **kw):
    """(port out, port aux) of ``fn`` on the port's module for ``p``."""
    with torch.no_grad():
        return fn(port_mlp(p), torch.from_numpy(np.array(x)), **kw)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


@pytest.mark.parametrize("path", ["einsum", "gather"])
def test_int8_expert_mlp_matches_float(path):
    """Per-(expert, column) int8 experts track the float MLP on both
    dispatches with the same routing (the fp32 router is untouched), as the
    JAX test holds; and the port's int8 MLP is the JAX one's (codes equal,
    outputs at 1e-5: the same division, an exact int32 product)."""
    p = make_moe_params(jax.random.PRNGKey(0))
    qp = jquant.quantize_linear_weights({"moe": p}, jquant.MOE_TARGETS)["moe"]
    x = jax.random.normal(jax.random.PRNGKey(1), (2, 8, 32))
    jfn = jmoe.moe_mlp_gather if path == "gather" else jmoe.moe_mlp
    fn = moe.moe_mlp_gather if path == "gather" else moe.moe_mlp
    m = port_mlp(p)
    wrapper = torch.nn.Module()
    wrapper.moe = m
    xt = torch.from_numpy(np.array(x))
    with torch.no_grad():
        y, aux = fn(m, xt, capacity_factor=2.0)
        quant.quantize_linear_weights(wrapper, quant.MOE_TARGETS)
        yq, auxq = fn(wrapper.moe, xt, capacity_factor=2.0)
    assert isinstance(wrapper.moe.wi, moe.QExpertLinear)
    assert wrapper.moe.wo.weight_scale.shape == (4, 32)
    np.testing.assert_array_equal(
        wrapper.moe.wi.weight_q.numpy(),
        np.asarray(qp["wi"]["kernel_q"]).transpose(0, 2, 1))
    jyq, _ = jfn(qp, x, capacity_factor=2.0)
    _close(yq, jyq)
    assert float(auxq) == pytest.approx(float(aux), rel=1e-6)
    np.testing.assert_allclose(yq.numpy(), y.numpy(), rtol=0.15, atol=0.02)
    rel = (yq - y).norm() / y.norm()
    assert rel < 0.05, rel
    np.testing.assert_array_equal(y.numpy() == 0, yq.numpy() == 0)


def test_identical_experts_match_gated_dense():
    p = _identical(make_moe_params(jax.random.PRNGKey(0)))
    x = jax.random.normal(jax.random.PRNGKey(1), (6, 5, 32))
    out, aux = _run(moe.moe_mlp, p, x, top_k=1, capacity_factor=4.0)
    probs = jax.nn.softmax(x.reshape(-1, 32) @ p["router"]["kernel"], axis=-1)
    gate = jnp.max(probs, axis=-1).reshape(6, 5, 1)
    _close(out, gate * dense_mlp(p["wi"], p["wo"], x))
    jout, jaux = jmoe.moe_mlp(p, x, top_k=1, capacity_factor=4.0)
    _close(out, jout)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-6)


def test_top2_sums_both_gates():
    p = _identical(make_moe_params(jax.random.PRNGKey(2)))
    x = jax.random.normal(jax.random.PRNGKey(3), (4, 3, 32))
    out, _ = _run(moe.moe_mlp, p, x, top_k=2, capacity_factor=8.0)
    probs = jax.nn.softmax(x.reshape(-1, 32) @ p["router"]["kernel"], axis=-1)
    top2 = jnp.sum(jax.lax.top_k(probs, 2)[0], axis=-1).reshape(4, 3, 1)
    _close(out, top2 * dense_mlp(p["wi"], p["wo"], x))
    _close(out, jmoe.moe_mlp(p, x, top_k=2, capacity_factor=8.0)[0])


def test_capacity_drops_are_zero_rows():
    """A zero router ties every token; the first maximum (expert 0) wins,
    capacity 1 serves token 0 alone."""
    p = make_moe_params(jax.random.PRNGKey(4))
    p["router"]["kernel"] = jnp.zeros_like(p["router"]["kernel"])
    x = jax.random.normal(jax.random.PRNGKey(5), (1, 8, 32))
    out, _ = _run(moe.moe_mlp, p, x, top_k=1, capacity_factor=0.5)
    out = out.numpy()[0]
    assert np.abs(out[0]).max() > 0
    np.testing.assert_allclose(out[1:], 0.0, atol=1e-6)
    _close(torch.from_numpy(out), jmoe.moe_mlp(p, x, top_k=1,
                                               capacity_factor=0.5)[0][0])


def test_capacity_is_per_group():
    p = make_moe_params(jax.random.PRNGKey(12))
    p["router"]["kernel"] = jnp.zeros_like(p["router"]["kernel"])
    x = jax.random.normal(jax.random.PRNGKey(13), (3, 8, 32))
    out, _ = _run(moe.moe_mlp, p, x, top_k=1, capacity_factor=0.5)
    out = out.numpy()
    for grp in range(3):
        assert np.abs(out[grp, 0]).max() > 0
        np.testing.assert_allclose(out[grp, 1:], 0.0, atol=1e-6)


def test_top_k_exceeding_experts_raises():
    p = make_moe_params(jax.random.PRNGKey(14))
    x = jax.random.normal(jax.random.PRNGKey(15), (1, 4, 32))
    for fn in (moe.moe_mlp, moe.moe_mlp_gather):
        with pytest.raises(ValueError, match="top_k"):
            _run(fn, p, x, top_k=5)


def test_aux_loss_balance():
    p = make_moe_params(jax.random.PRNGKey(6))
    x = jax.random.normal(jax.random.PRNGKey(7), (2, 16, 32))
    p["router"]["kernel"] = jnp.zeros_like(p["router"]["kernel"])
    _, aux_uniform = _run(moe.moe_mlp, p, x, capacity_factor=8.0)
    assert abs(float(aux_uniform) - 1.0) < 1e-5
    x = x.at[..., 0].set(1.0)
    p["router"]["kernel"] = p["router"]["kernel"].at[0, 1].set(100.0)
    _, aux_collapsed = _run(moe.moe_mlp, p, x, capacity_factor=8.0)
    assert float(aux_collapsed) > 3.5
    assert float(aux_collapsed) == pytest.approx(
        float(jmoe.moe_mlp(p, x, capacity_factor=8.0)[1]), rel=1e-6)


def _trunk(params, cfg_kw, experts=4):
    cfg = configs.ViTConfig(**cfg_kw)
    t = moe.MoETrunk(cfg, experts)
    t.load_state_dict(from_jax_tree(jax.tree.map(np.asarray, params),
                                    lambda path: cfg.depth), strict=True)
    return t


@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
def test_trunk_forward_and_grads(dispatch):
    """The stacked trunk against ``forward_trunk`` (out and aux at 1e-5),
    and the gradients of mean(y²) + 0.01·aux against ``jax.grad`` (router
    and experts included)."""
    jcfg = JViTConfig(**tiny_cfg())
    params = jmoe.init(jax.random.PRNGKey(8), jcfg, num_experts=4)
    x = jax.random.normal(jax.random.PRNGKey(9), (2, 17, 32))

    def jloss(params):
        y, aux = jmoe.forward_trunk(params, x, jcfg, capacity_factor=2.0,
                                    dispatch=dispatch)
        return jnp.mean(y**2) + 0.01 * aux

    jval, jg = jax.value_and_grad(jloss)(params)
    t = _trunk(params, tiny_cfg())
    y, aux = t.forward_trunk(torch.from_numpy(np.array(x)),
                             capacity_factor=2.0, dispatch=dispatch,
                             remat=True)
    jy, jaux = jmoe.forward_trunk(params, x, jcfg, capacity_factor=2.0,
                                  dispatch=dispatch)
    _close(y, jy)
    assert aux.item() == pytest.approx(float(jaux), rel=1e-6)
    loss = (y ** 2).mean() + 0.01 * aux
    loss.backward()
    assert loss.item() == pytest.approx(float(jval), rel=1e-6)
    want = from_jax_tree(jax.tree.map(np.asarray, jg), lambda path: 2)
    for n, p in t.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[n].numpy(),
                                   atol=1e-6, rtol=1e-4, err_msg=n)
    assert t.blocks[0].moe.router.weight.grad.abs().max() > 0


def _keep_cfgs():
    jc = JKEEPConfig(
        vision=JViTConfig(img_size=16, patch_size=8, embed_dim=32, depth=2,
                          num_heads=2, moe_experts=4, moe_capacity_factor=2.0),
        text=JBertConfig(vocab_size=64, hidden_size=32, num_hidden_layers=2,
                         num_attention_heads=2, intermediate_size=64,
                         max_position_embeddings=32),
        projection_dim=32)
    pc = configs.KEEPConfig(
        vision=configs.ViTConfig(**dataclasses.asdict(jc.vision)),
        text=configs.BertConfig(**dataclasses.asdict(jc.text)),
        projection_dim=32)
    return jc, pc


def test_keep_moe_integration():
    """A KEEP config with ``moe_experts > 0``: the port builds the MoE
    trunk, ``encode_image(return_aux=True)`` gives the JAX features and aux
    (1e-5), the dense trunk's aux is 0; ``quantize()`` covers the experts
    (int8, per-(expert, column) scales) and keeps the router fp32, its
    features as the JAX int8 model's and at cosine > 0.99 of the float."""
    jc, pc = _keep_cfgs()
    params = jkeep.init(jax.random.PRNGKey(0), jc)
    m = KEEPModel(pc)
    m.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params), pc),
                      strict=True)
    assert isinstance(m.visual, moe.MoEVisionTransformer)
    assert m.visual.blocks[0].moe.wi.weight.shape == (4, pc.vision.mlp_dim,
                                                      32)
    px = jax.random.normal(jax.random.PRNGKey(1), (2, 16, 16, 3))
    jfeats, jaux = jkeep.encode_image(params, px, jc, return_aux=True)
    pxt = torch.from_numpy(np.asarray(px))
    with torch.no_grad():
        feats, aux = m.encode_image(pxt, return_aux=True)
        out = m(pxt, torch.ones(2, 8, dtype=torch.long), return_aux=True)
    _close(feats, jfeats)
    assert aux.item() == pytest.approx(float(jaux), rel=1e-6) and aux > 0
    assert torch.equal(out["aux"], aux)
    dense = KEEPModel(dataclasses.replace(pc, vision=configs.ViTConfig(
        img_size=16, patch_size=8, embed_dim=32, depth=2, num_heads=2)))
    for prm in dense.parameters():
        torch.nn.init.normal_(prm, 0, 0.02)
    with torch.no_grad():
        assert dense.encode_image(pxt, return_aux=True)[1].item() == 0.0
    qm = m.quantize()
    wi = qm.visual.blocks[0].moe.wi
    assert isinstance(wi, moe.QExpertLinear) and wi.weight_q.dtype == \
        torch.int8 and not wi.w_only
    assert wi.weight_scale.shape == (4, pc.vision.mlp_dim)
    assert qm.visual.blocks[0].moe.router.weight.dtype == torch.float32
    jq = jkeep.KEEPModel(params=params, cfg=jc).quantize()
    with torch.no_grad():
        qfeats = qm.encode_image(pxt)
    _close(qfeats, jq.encode_image(px))
    assert float((feats * qfeats).sum(-1).mean()) > 0.99


def test_keep_moe_w8a16_tree_from_jax_params():
    """A JAX KEEP tree quantized with ``moe_w8a16`` (the experts marked
    ``w_only``: W8A16) carried by ``from_jax_params`` into the port: the
    experts load as W8A16 ``QExpertLinear``s (the marker in their extra
    state), the codes as the JAX tree holds them, and the features match
    the JAX int8 model's at the int8 gate (cosine ≥ 0.999 per row) and at
    1e-5 (both dequantize the codes into the fp32 product)."""
    jc, pc = _keep_cfgs()
    params = jkeep.init(jax.random.PRNGKey(0), jc)
    jq = jkeep.KEEPModel(params=params, cfg=jc).quantize(moe_w8a16=True)
    m = KEEPModel(pc)
    m.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params), pc),
                      strict=True)
    qm = m.quantize()  # W8A8 experts; the JAX tree's marker turns them
    qm.load_state_dict(from_jax_params(jax.tree.map(np.asarray, jq.params),
                                       pc), strict=True)
    experts = [mod for mod in qm.modules()
               if isinstance(mod, moe.QExpertLinear)]
    assert len(experts) == 2 * pc.vision.depth
    assert all(e.w_only for e in experts)
    np.testing.assert_array_equal(
        qm.visual.blocks[0].moe.wo.weight_q.numpy(),
        np.asarray(jq.params["visual"]["blocks"]["moe"]["wo"]["kernel_q"][0]
                   ).transpose(0, 2, 1))
    px = jax.random.normal(jax.random.PRNGKey(1), (3, 16, 16, 3))
    with torch.no_grad():
        got = qm.encode_image(torch.from_numpy(np.asarray(px)))
    want = np.asarray(jq.encode_image(px))
    cos = (got.numpy() * want).sum(-1) / (
        np.linalg.norm(got.numpy(), axis=-1) * np.linalg.norm(want, axis=-1))
    assert (cos >= 0.999).all(), cos
    _close(got, want)


class TestGatherDispatch:
    def test_matches_einsum_when_no_drops(self):
        p = make_moe_params(jax.random.PRNGKey(20))
        x = jax.random.normal(jax.random.PRNGKey(21), (6, 5, 32))
        ref, aux_ref = _run(moe.moe_mlp, p, x, top_k=1, capacity_factor=4.0)
        out, aux = _run(moe.moe_mlp_gather, p, x, capacity_factor=4.0)
        _close(out, ref.numpy())
        assert abs(float(aux) - float(aux_ref)) < 1e-6
        _close(out, jmoe.moe_mlp_gather(p, x, capacity_factor=4.0)[0])

    def test_identical_experts_match_gated_dense(self):
        p = _identical(make_moe_params(jax.random.PRNGKey(22)))
        x = jax.random.normal(jax.random.PRNGKey(23), (4, 7, 32))
        out, _ = _run(moe.moe_mlp_gather, p, x, capacity_factor=4.0)
        probs = jax.nn.softmax(x.reshape(-1, 32) @ p["router"]["kernel"], -1)
        gate = jnp.max(probs, axis=-1).reshape(4, 7, 1)
        _close(out, gate * dense_mlp(p["wi"], p["wo"], x))

    def test_capacity_drops_are_zero_rows(self):
        """Every token to expert 0: past C = ceil(T/E · cf) the rows are
        exactly zero (the dropped tokens' shared pad slot leaks into no
        kept slot)."""
        p = make_moe_params(jax.random.PRNGKey(24))
        x = jax.random.normal(jax.random.PRNGKey(25), (2, 8, 32))
        x = x.at[..., 0].set(1.0)
        p["router"]["kernel"] = jnp.zeros_like(
            p["router"]["kernel"]).at[0, 0].set(100.0)
        out, _ = _run(moe.moe_mlp_gather, p, x, capacity_factor=1.0)
        c = moe.moe_capacity(16, 4, 1, 1.0)
        assert c == jmoe.moe_capacity(16, 4, 1, 1.0) == 4
        flat = out.numpy().reshape(16, 32)
        assert np.all(flat[:c] != 0)
        np.testing.assert_array_equal(flat[c:], 0)
        _close(out, jmoe.moe_mlp_gather(p, x, capacity_factor=1.0)[0])

    def test_global_routing_beats_grouped_drops(self):
        p = make_moe_params(jax.random.PRNGKey(26))
        x = jax.random.normal(jax.random.PRNGKey(27), (2, 8, 32)) * 0.01
        x = x.at[0, :, 0].set(1.0)
        p["router"]["kernel"] = jnp.zeros_like(
            p["router"]["kernel"]).at[0, 0].set(100.0)
        grouped, _ = _run(moe.moe_mlp, p, x, top_k=1, capacity_factor=1.0)
        glob, _ = _run(moe.moe_mlp_gather, p, x, capacity_factor=1.0)
        dropped_grouped = int((~grouped.bool().any(-1)).sum())
        dropped_global = int((~glob.bool().any(-1)).sum())
        assert dropped_global < dropped_grouped

    def test_unknown_dispatch_raises(self):
        t = moe.MoETrunk(configs.ViTConfig(**tiny_cfg()), 4)
        with pytest.raises(ValueError, match="dispatch"):
            t.forward_trunk(torch.zeros(1, 17, 32), dispatch="bogus")

    def test_topk2_native_matches_einsum_no_drops(self):
        jcfg = JViTConfig(**tiny_cfg())
        params = jmoe.init(jax.random.PRNGKey(32), jcfg, num_experts=4)
        x = jax.random.normal(jax.random.PRNGKey(33), (2, 17, 32))
        t = _trunk(params, tiny_cfg())
        xt = torch.from_numpy(np.array(x))
        with torch.no_grad():
            a, aux_a = t.forward_trunk(xt, top_k=2, dispatch="gather",
                                       capacity_factor=4.0)
            b, aux_b = t.forward_trunk(xt, top_k=2, dispatch="einsum",
                                       capacity_factor=4.0)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-6)
        assert float(aux_a) == pytest.approx(float(aux_b), rel=1e-6)
        ja, _ = jmoe.forward_trunk(params, x, jcfg, top_k=2,
                                   dispatch="gather", capacity_factor=4.0)
        _close(a, ja)

    def test_topk2_gather_gates_sum_both_experts(self):
        p = make_moe_params(jax.random.PRNGKey(40))
        for t in ("wi", "wo"):
            k0 = p[t]["kernel"][0]
            p[t]["kernel"] = jnp.broadcast_to(k0, p[t]["kernel"].shape)
        x = jax.random.normal(jax.random.PRNGKey(41), (30, 32))
        y, _ = _run(moe.moe_mlp_gather, p, x, top_k=2, capacity_factor=4.0)
        probs = jax.nn.softmax(x @ p["router"]["kernel"], -1)
        top2 = jnp.sum(jax.lax.top_k(probs, 2)[0], -1)
        want = dense_mlp(p["wi"], p["wo"], x[None])[0] * top2[:, None]
        _close(y, want, rtol=2e-5, atol=2e-5)

    def test_topk_route_force_raises(self):
        p = make_moe_params(jax.random.PRNGKey(42))
        with pytest.raises(ValueError, match="top-1"):
            _run(moe.moe_mlp_gather, p, jnp.zeros((8, 32)), top_k=2,
                 return_route=True)

    def test_chunked_cumsum_matches_flat(self):
        rng = np.random.default_rng(0)
        for t in (1, 7, 128, 129, 1000):
            x = rng.integers(0, 3, (t, 5)).astype(np.int32)
            np.testing.assert_array_equal(
                moe._chunked_cumsum(torch.from_numpy(x)).numpy(),
                np.cumsum(x, 0))


class TestRouteTraceAndPin:
    def _pair(self, dispatch="gather"):
        kw = dict(img_size=32, patch_size=8, embed_dim=64, depth=2,
                  num_heads=4, moe_experts=4, moe_dispatch=dispatch)
        jcfg = JViTConfig(**kw)
        params = jmoe.init_vit(jax.random.PRNGKey(1), jcfg)
        cfg = configs.ViTConfig(**kw)
        v = moe.MoEVisionTransformer(cfg)
        v.load_state_dict(from_jax_tree(jax.tree.map(np.asarray, params),
                                        lambda path: cfg.depth), strict=True)
        return jcfg, params, v

    def test_trace_is_noninvasive_and_pin_roundtrips(self):
        jcfg, params, v = self._pair()
        x = np.random.default_rng(0).standard_normal(
            (4, 32, 32, 3)).astype(np.float32)
        xt = torch.from_numpy(x)
        with torch.no_grad():
            ref = v(xt)[0]
            feat, _, routes = v(xt, return_routes=True)
            assert routes.shape == (2, 4 * 17)
            assert torch.equal(feat, ref)
            assert torch.equal(v(xt, routes=routes)[0], ref)
            other = v(xt, routes=(routes + 1) % 4)[0]
        assert not torch.allclose(other, ref)
        _, _, jroutes = jmoe.vit_forward(params, jnp.asarray(x), jcfg,
                                         return_routes=True)
        np.testing.assert_array_equal(routes.numpy(), np.asarray(jroutes))
        _close(ref, jmoe.vit_forward(params, jnp.asarray(x), jcfg)[0])
        with pytest.raises(ValueError, match="forced route"):
            with torch.no_grad():
                v(xt, routes=routes + 4)

    def test_einsum_routes_equal_jax(self, monkeypatch):
        """The einsum dispatch traces no route: each layer's realized
        assignment is the router's first argmax on norm2's output, taken
        from both packages' blocks on the same weights; equal, and the
        features at 1e-5."""
        jcfg, params, v = self._pair("einsum")
        x = np.random.default_rng(2).standard_normal(
            (3, 32, 32, 3)).astype(np.float32)
        seen = []
        probs = moe.Router.probs

        def record(self, h):
            p = probs(self, h)
            seen.append(p.argmax(-1).reshape(-1))
            return p

        monkeypatch.setattr(moe.Router, "probs", record)
        with torch.no_grad():
            feats = v(torch.from_numpy(x))[0]
        # the JAX stream, block by block: its attention half, then norm2
        blocks = params["blocks"]
        tokens = jnp.asarray(x)
        from keep_tpu.models import vit as jvit

        tok = jvit.patchify(params["patch_embed"], tokens, 8)
        tok = jnp.concatenate([jnp.broadcast_to(params["cls_token"],
                                                (3, 1, 64)), tok], 1)
        tok = tok + params["pos_embed"]
        for i in range(2):
            lp = jax.tree.map(lambda a: a[i], blocks)
            b, s, d = tok.shape
            ln1 = jnn.layer_norm(lp["norm1"], tok, jcfg.ln_eps)
            qkv = jnn.linear(lp["attn"]["qkv"], ln1).reshape(
                b, s, 3, 4, d // 4).transpose(2, 0, 3, 1, 4)
            att = jnn.mha_attention(qkv[0], qkv[1], qkv[2]).transpose(
                0, 2, 1, 3).reshape(b, s, d)
            h = tok + jnn.linear(lp["attn"]["proj"], att)
            ln2 = jnn.layer_norm(lp["norm2"], h, jcfg.ln_eps)
            want = jnp.argmax(jax.nn.softmax(
                ln2.reshape(-1, d) @ lp["moe"]["router"]["kernel"], -1), -1)
            np.testing.assert_array_equal(seen[i].numpy(), np.asarray(want))
            tok = jmoe.block(lp, tok, jcfg)[0]
        _close(feats, jmoe.vit_forward(params, jnp.asarray(x), jcfg)[0])

    def test_compose_with_ln_stats(self):
        jcfg, params, v = self._pair()
        x = np.random.default_rng(1).standard_normal(
            (2, 32, 32, 3)).astype(np.float32)
        with torch.no_grad():
            _, _, stats, routes = v(torch.from_numpy(x), ln_stats=True,
                                    return_routes=True)
        _, _, jstats, jroutes = jmoe.vit_forward(
            params, jnp.asarray(x), jcfg, ln_stats=True, return_routes=True)
        assert sorted(stats) == ["qkv", "wi"]
        for k in stats:
            _close(stats[k], jstats[k])
        np.testing.assert_array_equal(routes.numpy(), np.asarray(jroutes))

    def test_route_force_requires_gather(self):
        _, _, v = self._pair("einsum")
        with pytest.raises(ValueError, match="gather"):
            v(torch.zeros(1, 32, 32, 3), return_routes=True)
