"""The port's training losses against the JAX package's on the same inputs
(numpy, from a seed): values and gradients within rtol 1e-5 (fp32, both
sides; the sums run in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keep_tpu.train import loss as jloss
from keep_tpu_torch.train import loss as tloss

VARIANTS = ["hp-hn", "lhp-hn", "hp-lhn", "lhp-lhn"]
RTOL = 1e-5


def _feats(rng, n, d, n_txt=None):
    img = rng.standard_normal((n, d)).astype(np.float32)
    txt = rng.standard_normal((n_txt or n, d)).astype(np.float32)
    return img, txt


def _jax_value_and_grads(fn, *arrays):
    value, grads = jax.value_and_grad(fn, argnums=tuple(range(len(arrays))))(
        *map(jnp.asarray, arrays))
    return float(value), [np.asarray(g) for g in grads]


def _torch_value_and_grads(fn, *arrays):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    value = fn(*ts)
    value.backward()
    return float(value.detach()), [t.grad.numpy() for t in ts]


def _close(got, want, atol=0.0):
    gv, gg = got
    wv, wg = want
    assert gv == pytest.approx(wv, rel=RTOL)
    for a, b in zip(gg, wg):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=atol)


@pytest.mark.parametrize("loss_type", VARIANTS)
def test_hy_metric_loss_matches_jax(loss_type, rng):
    n_id, n_ins, d = 4, 3, 16
    img, txt = _feats(rng, n_id * n_ins, d)
    node = np.ones((n_id, n_id), np.float32)
    node[0, 2] = node[2, 0] = -1.0  # one DO-related pair masked
    scale = np.float32(5.0)

    def jfn(i, t, s):
        return jloss.hy_metric_loss(i, t, jnp.asarray(node), s,
                                    caption_num=n_id, loss_type=loss_type)

    def tfn(i, t, s):
        return tloss.hy_metric_loss(i, t, torch.from_numpy(node), s,
                                    caption_num=n_id, loss_type=loss_type)

    # gradients near zero carry the sums' rounding: atol at 1e-7 of O(1)
    _close(_torch_value_and_grads(tfn, img, txt, scale),
           _jax_value_and_grads(jfn, img, txt, scale), atol=1e-7)


def test_hy_metric_loss_extra_negatives_matches_jax(rng):
    n_id, n_ins, d = 3, 2, 8
    img, txt = _feats(rng, n_id * n_ins, d, n_txt=2 * n_id * n_ins)
    node = np.ones((n_id, n_id), np.float32)
    unknown = tloss.DOGraph({}).unknown_connection(["a", "unknown", "c"])
    np.testing.assert_array_equal(
        unknown, jloss.DOGraph({}).unknown_connection(["a", "unknown", "c"]))

    def jfn(i, t):
        return jloss.hy_metric_loss(i, t, jnp.asarray(node), 4.0,
                                    caption_num=n_id, loss_type="lhp-hn",
                                    unknown_connection=jnp.asarray(unknown))

    def tfn(i, t):
        return tloss.hy_metric_loss(i, t, torch.from_numpy(node),
                                    torch.tensor(4.0), caption_num=n_id,
                                    loss_type="lhp-hn",
                                    unknown_connection=torch.from_numpy(
                                        unknown))

    _close(_torch_value_and_grads(tfn, img, txt),
           _jax_value_and_grads(jfn, img, txt), atol=1e-7)
    with pytest.raises(ValueError, match="unknown_connection"):
        tloss.hy_metric_loss(torch.from_numpy(img), torch.from_numpy(txt),
                             torch.from_numpy(node), torch.tensor(4.0),
                             caption_num=n_id)


@pytest.mark.parametrize("loss_type", VARIANTS)
def test_hy_metric_loss_finite_at_max_scale(loss_type):
    """At logit_scale 100 (the trainer's clamp) with every sim 1 the
    exponent clamp at 85 keeps each variant finite, with finite grads, and
    equal to the JAX value."""
    n_id, n_ins, d = 3, 2, 8
    v = np.zeros((n_id * n_ins, d), np.float32)
    v[:, 0] = 1.0
    node = np.ones((n_id, n_id), np.float32)
    x = torch.tensor(v, requires_grad=True)
    loss = tloss.hy_metric_loss(x, x, torch.from_numpy(node),
                                torch.tensor(100.0), caption_num=n_id,
                                loss_type=loss_type)
    loss.backward()
    assert torch.isfinite(loss) and torch.isfinite(x.grad).all()
    ref = float(jloss.hy_metric_loss(jnp.asarray(v), jnp.asarray(v),
                                     jnp.asarray(node), 100.0,
                                     caption_num=n_id, loss_type=loss_type))
    assert float(loss) == pytest.approx(ref, rel=RTOL)


def test_metric_loss_guards_underflowed_positives():
    """Every in-group exp(−scale·sim) underflowed to 0: the reciprocal
    guards keep hp-lhn (and the others) finite, as in the JAX package."""
    n_id, n_ins = 2, 2
    n = n_id * n_ins
    sim = np.full((n, n), 0.1, np.float32)
    within = np.kron(np.eye(n_id), np.ones((n_ins, n_ins))).astype(bool)
    sim[within] = 1.1
    for loss_type in VARIANTS:
        got = float(tloss._metric_loss(torch.from_numpy(sim),
                                       torch.tensor(100.0), n_id, n_ins,
                                       loss_type))
        ref = float(jloss._metric_loss(jnp.asarray(sim), 100.0, n_id, n_ins,
                                       loss_type))
        assert np.isfinite(got) and got == pytest.approx(ref, rel=RTOL)
    with pytest.raises(ValueError, match="unknown loss_type"):
        tloss._metric_loss(torch.from_numpy(sim), torch.tensor(1.0), n_id,
                           n_ins, "nope")


def test_clip_loss_matches_jax(rng):
    img, txt = _feats(rng, 8, 16)
    img /= np.linalg.norm(img, axis=1, keepdims=True)
    txt /= np.linalg.norm(txt, axis=1, keepdims=True)
    scale = np.float32(25.0)
    _close(_torch_value_and_grads(tloss.clip_loss, img, txt, scale),
           _jax_value_and_grads(jloss.clip_loss, img, txt, scale), atol=1e-7)


def test_clip_loss_with_labels_matches_jax(rng):
    img, txt = _feats(rng, 6, 8)
    labels = np.array([0, 0, 1, 1, 2, 2])

    def jfn(i, t):
        return jloss.clip_loss(i, t, 3.0, labels=jnp.asarray(labels))

    def tfn(i, t):
        return tloss.clip_loss(i, t, torch.tensor(3.0),
                               labels=torch.from_numpy(labels))

    _close(_torch_value_and_grads(tfn, img, txt),
           _jax_value_and_grads(jfn, img, txt), atol=1e-7)


def test_mask_contrastive_matches_jax(rng):
    logits = (rng.standard_normal((6, 6)) * 30).astype(np.float32)
    labels = np.array([0, 0, 1, 1, 2, 2])

    def jfn(lg):
        return jloss.mask_contrastive_loss(lg, jnp.asarray(labels))

    def tfn(lg):
        return tloss.mask_contrastive_loss(lg, torch.from_numpy(labels))

    _close(_torch_value_and_grads(tfn, logits),
           _jax_value_and_grads(jfn, logits), atol=1e-7)


def test_do_graph_matches_jax(tmp_path):
    parents = {"cancer": [], "carcinoma": ["cancer"],
               "adenocarcinoma": ["carcinoma"], "melanoma": ["cancer"]}
    import json

    path = tmp_path / "kg.json"
    path.write_text(json.dumps({k: {"name": k, "parent": v}
                                for k, v in parents.items()}))
    g, jg = tloss.DOGraph.from_json(str(path)), jloss.DOGraph(parents)
    names = list(parents) + ["missing"]
    for a in names:
        for b in names:
            assert g.reachable(a, b) == jg.reachable(a, b), (a, b)
    labels = ["adenocarcinoma", "melanoma", "cancer", "missing", "carcinoma"]
    np.testing.assert_array_equal(g.node_connection(labels),
                                  jg.node_connection(labels))
    assert g.node_connection(labels)[0, 2] == -1
