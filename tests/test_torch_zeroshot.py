"""The port's zero-shot classifier and prompt screening
(keep_tpu_torch.zeroshot) against the same oracles as tests/test_zeroshot.py
and against the JAX package on the same inputs: the classifier stack of a
tiny KEEP at 2e-5, the screened ensemble at 1e-5 with the same top-n
order, ``random_ensemble``'s picks and ``generate_prompts`` exactly, the
bucket planner's decisions exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keep_tpu import configs as jcfgs
from keep_tpu.models import keep as jkeep
from keep_tpu.text.tokenizer import WordPieceTokenizer as JTokenizer
from keep_tpu.zeroshot import classifier as jcls
from keep_tpu.zeroshot import prompts as jprompts
from keep_tpu_torch import configs
from keep_tpu_torch.compat.torch_loader import from_jax_params
from keep_tpu_torch.models.keep import KEEPModel
from keep_tpu_torch.text.tokenizer import WordPieceTokenizer
from keep_tpu_torch.utils import rtt as rtt_mod
from keep_tpu_torch.zeroshot import (build_classifier,
                                     build_classifiers_batched,
                                     encode_texts_bucketed, prompt_select,
                                     random_ensemble, rank_cls_scores)
from keep_tpu_torch.zeroshot import classifier as tcls
from keep_tpu_torch.zeroshot import prompts as tprompts
from keep_tpu_torch.zeroshot.classifier import (choose_bucket_plan,
                                                expand_prompt,
                                                plan_length_buckets)


def normalize(x, axis=-1):
    return x / np.linalg.norm(x, axis=axis, keepdims=True)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ---- twins of tests/test_zeroshot.py ----------------------------------------


def test_build_classifier_single_template(rng):
    emb = rng.standard_normal((1, 16)).astype(np.float32)
    cls = build_classifier([_t(emb), _t(emb * 2)]).numpy()
    ref_col = normalize(normalize(emb).mean(0))
    np.testing.assert_allclose(cls[:, 0], ref_col, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(cls, axis=0), 1.0, atol=1e-6)
    assert cls.shape == (16, 2)


def test_build_classifier_multi_template(rng):
    embs = [rng.standard_normal((5, 16)).astype(np.float32) for _ in range(3)]
    cls = build_classifier([_t(e) for e in embs]).numpy()
    for c, e in enumerate(embs):
        np.testing.assert_allclose(cls[:, c], normalize(normalize(e).mean(0)),
                                   atol=1e-6)
    np.testing.assert_allclose(
        cls, np.asarray(jcls.build_classifier([jnp.asarray(e) for e in embs])),
        atol=1e-6)
    cls_q = build_classifier([_t(e) for e in embs],
                             first_template_only=True).numpy()
    for c, e in enumerate(embs):
        np.testing.assert_allclose(cls_q[:, c], normalize(e[0]), atol=1e-6)


def test_rank_cls_scores(rng):
    logits = rng.random((7, 40, 3)).astype(np.float32)
    got = rank_cls_scores(_t(logits)).numpy()
    srt = np.sort(logits, axis=-1)
    largest, second = srt[..., -1], srt[..., -2]
    ref = ((largest - second) - np.abs(largest + second - 1)).mean(-1)
    np.testing.assert_allclose(got, ref, atol=1e-6)
    np.testing.assert_allclose(
        got, np.asarray(jcls.rank_cls_scores(jnp.asarray(logits))), atol=1e-6)


@pytest.mark.parametrize("c", [2, 3, 5])
def test_rank_cls_scores_with_ties_equal_top_k(c, rng):
    """The two largest of each row are top_k's values, ties included (a
    tied max counts twice), on a strided [P, N, C] view as the screening
    passes it."""
    logits = np.round(rng.random((6, 50, c)) * 4).astype(np.float32) / 4
    view = _t(np.ascontiguousarray(logits.transpose(1, 0, 2))).transpose(0, 1)
    top2 = torch.topk(_t(logits), 2, dim=-1).values
    ref = ((top2[..., 0] - top2[..., 1])
           - (top2[..., 0] + top2[..., 1] - 1).abs()).mean(-1)
    assert torch.equal(rank_cls_scores(view), ref)
    np.testing.assert_allclose(
        ref.numpy(), np.asarray(jcls.rank_cls_scores(jnp.asarray(logits))),
        atol=1e-6)


def _screening_inputs(rng, p=12, d=16, c=2, n=100):
    classifiers = normalize(rng.standard_normal((p, d, c)).astype(np.float32),
                            axis=1)
    feats = rng.standard_normal((n, d)).astype(np.float32)
    return classifiers, feats


def test_prompt_select_matches_oracle(rng):
    topn = 5
    classifiers, feats = _screening_inputs(rng)
    got = prompt_select(_t(classifiers), _t(feats), topn).numpy()
    fn = normalize(feats)
    scores = []
    for k in range(len(classifiers)):
        srt = np.sort(fn @ classifiers[k], axis=1)
        largest, second = srt[:, -1], srt[:, -2]
        scores.append(((largest - second) - np.abs(largest + second - 1)).mean())
    order = np.argsort(-np.asarray(scores), kind="stable")
    merged = classifiers[order[:topn]].sum(0)
    np.testing.assert_allclose(got, normalize(merged, axis=0), atol=1e-5)


def test_random_ensemble_seeding(rng):
    classifiers = _t(rng.standard_normal((9, 8, 2)).astype(np.float32))
    a = random_ensemble(classifiers, topn=4).numpy()
    b = random_ensemble(classifiers, topn=4).numpy()
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(np.linalg.norm(a, axis=0), 1.0, atol=1e-6)


class FakeTok:
    def __call__(self, texts, max_length=256):
        n = len(texts)
        ids = np.zeros((n, 4), np.int32)
        for i, t in enumerate(texts):
            ids[i, 0] = (sum(map(ord, t)) % 1000) + 1
        return {"input_ids": ids, "attention_mask": np.ones((n, 4), np.int32),
                "token_type_ids": np.zeros((n, 4), np.int32)}


def _fake_encode(d=8):
    def encode(ids, mask):
        g = np.random.default_rng(np.asarray(ids)[:, 0].astype(np.int64))
        return _t(normalize(g.standard_normal((ids.shape[0], d)).astype(
            np.float32)))
    return encode


def test_build_classifiers_batched(rng):
    prompts = {
        "0": {"classnames": {"Normal": "normal tissue", "Tumor": "melanoma"},
              "templates": "CLASSNAME."},
        "1": {"classnames": {"Normal": "benign", "Tumor": "cancer"},
              "templates": ["an image of CLASSNAME.", "CLASSNAME"]},
    }
    label_map = {"Normal": 0, "Tumor": 1}
    stack = build_classifiers_batched(_fake_encode(), FakeTok(), prompts,
                                      label_map, batch_size=3)
    assert isinstance(stack, torch.Tensor) and stack.shape == (2, 8, 2)
    np.testing.assert_allclose(np.linalg.norm(stack.numpy(), axis=1), 1.0,
                               atol=1e-5)
    stack3 = build_classifiers_batched(
        _fake_encode(), FakeTok(),
        {"0": {"classnames": {"A": "a", "B": "b", "Normal": "normal"},
               "templates": "CLASSNAME."}},
        {"A": 0, "B": 1}, add_normal=True, batch_size=2)
    assert stack3.shape == (1, 8, 3)


def test_non_contiguous_label_map_rejected():
    prompt = {"classnames": {"Tumor": "tumor"}, "templates": "CLASSNAME."}
    with pytest.raises(ValueError, match="contiguous"):
        expand_prompt(prompt, {"Tumor": 1})
    with pytest.raises(ValueError, match="unique"):
        expand_prompt(prompt, {"Tumor": 0, "Normal": 0})


NODES = {
    "DOID:leaf": {"name": "cutaneous melanoma",
                  "synonyms": ["malignant melanoma of skin"],
                  "parent": ["DOID:mid"]},
    "DOID:mid": {"name": "melanoma", "synonyms": ["skin cancer, melanoma"],
                 "parent": ["DOID:14566"]},
    "DOID:14566": {"name": "disease of cellular proliferation",
                   "synonyms": [], "parent": []},
}


def test_generate_prompts():
    phr = tprompts.tumor_phrasings(NODES, "DOID:leaf")
    assert "cutaneous melanoma" in phr
    assert "malignant melanoma of skin" in phr
    assert "melanoma cutaneous melanoma" in phr
    assert "disease of cellular proliferation" not in phr
    nodes2 = {
        "DOID:leaf": {"name": "leafoma", "parent": ["DOID:mid"]},
        "DOID:mid": {"name": "midoma", "parent": ["DOID:gp"]},
        "DOID:gp": {"name": "gpoma", "parent": []},
    }
    phr2 = tprompts.tumor_phrasings(nodes2, "DOID:leaf")
    assert "gpoma midoma leafoma" in phr2 and "gpoma leafoma" not in phr2
    assert tprompts.generate_prompts(NODES, "DOID:leaf", templates=[]) == {}
    prompts = tprompts.generate_prompts(NODES, "DOID:leaf",
                                        normal_phrases=["normal tissue"],
                                        templates=["CLASSNAME."])
    assert set(prompts["0"]) == {"classnames", "templates"}
    assert len(prompts) == len(phr)
    assert expand_prompt(prompts["0"], {"Normal": 0, "Tumor": 1})[0] == [
        "normal tissue."]


def test_generate_prompts_equal_jax():
    """The default templates and normal phrases come from the port's own
    train/data.py; the prompts are the JAX package's, exactly."""
    assert tprompts.DEFAULT_NORMAL_PHRASES == jprompts.DEFAULT_NORMAL_PHRASES
    for node in NODES:
        assert tprompts.tumor_phrasings(NODES, node) == \
            jprompts.tumor_phrasings(NODES, node)
        assert tprompts.generate_prompts(NODES, node) == \
            jprompts.generate_prompts(NODES, node)


def test_prompt_select_clamps_topn(rng):
    cls = normalize(rng.standard_normal((4, 16, 2)).astype(np.float32), axis=1)
    feats = rng.standard_normal((10, 16)).astype(np.float32)
    merged = prompt_select(_t(cls), _t(feats), topn=50)
    assert merged.shape == (16, 2)
    np.testing.assert_allclose(np.linalg.norm(merged.numpy(), axis=0), 1.0,
                               atol=1e-5)


def _padding_invariant_encode(d=8, per_width_s=0.0, fixed_s=0.0, calls=None):
    import time as _time

    table = np.random.default_rng(1).standard_normal((1000, d)).astype(
        np.float32)

    def encode(ids, mask):
        ids = np.asarray(ids)
        m = np.asarray(mask).astype(np.float32)
        if calls is not None:
            calls.append(ids.shape[1])
        _time.sleep(fixed_s + ids.shape[1] * per_width_s)
        tok = table[ids % 1000] * m[..., None]
        return _t(tok.sum(1) / np.maximum(m.sum(1, keepdims=True), 1))
    return encode


def test_build_classifiers_batched_bucketed_matches_unbucketed():
    class VarTok:
        def __call__(self, texts, max_length=256):
            n, width = len(texts), 12
            ids = np.zeros((n, width), np.int32)
            mask = np.zeros((n, width), np.int32)
            for i, t in enumerate(texts):
                h = sum(map(ord, t))
                ln = 2 + (h % (width - 2))
                ids[i, :ln] = (np.arange(ln) + h) % 997 + 1
                mask[i, :ln] = 1
            return {"input_ids": ids, "attention_mask": mask}

    prompts = {str(i): {"classnames": {"Normal": f"normal {i}",
                                       "Tumor": f"tumor {'x' * i}"},
                        "templates": "an image of CLASSNAME."}
               for i in range(5)}
    label_map = {"Normal": 0, "Tumor": 1}
    a = build_classifiers_batched(_padding_invariant_encode(), VarTok(),
                                  prompts, label_map, batch_size=3,
                                  length_buckets=(4, 8, 16))
    b = build_classifiers_batched(_padding_invariant_encode(), VarTok(),
                                  prompts, label_map, batch_size=3,
                                  length_buckets=None)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


@pytest.mark.parametrize("rtt_s", [0.001, 0.140])
def test_plan_length_buckets_equals_jax(rtt_s):
    g = np.random.default_rng(0)
    kw = dict(full=256, batch_size=512, sec_per_token=1.0e-6, rtt_s=rtt_s)
    for lengths in (g.integers(1, 257, 600),
                    np.clip(g.normal(16, 5, 2772).astype(int), 6, 40)):
        assert plan_length_buckets(lengths, **kw) == \
            jcls.plan_length_buckets(lengths, **kw)
    fast, _ = plan_length_buckets(g.integers(1, 257, 600), **dict(
        kw, rtt_s=0.001))
    assert fast == (32, 64, 128, 256)


def test_plan_length_buckets_measures_the_device():
    """Without ``rtt_s`` the planner measures a null round trip and the
    download rate on the device (here the CPU) and keys ``SEC_PER_TOKEN``
    by its type."""
    lengths = np.full(40, 10)
    _, info = plan_length_buckets(lengths, 64, 8, device="cpu")
    assert info["sec_per_token"] == tcls.SEC_PER_TOKEN["cpu"]
    assert info["per_dispatch_fixed_s"] > 0
    assert rtt_mod.measure_rtt(device="cpu") is rtt_mod.measure_rtt(
        device="cpu")  # memoised
    assert set(rtt_mod.measure_bandwidth(device="cpu")) == {
        "upload_mb_per_s", "download_mb_per_s", "mb"}
    assert "tpu" not in tcls.SEC_PER_TOKEN


def _probe_corpus(rng, n=24, full=64, short=8, n_long=4):
    ids = np.zeros((n, full), np.int32)
    mask = np.zeros((n, full), np.int32)
    for i in range(n):
        ln = int(rng.integers(full - 8, full)) if i < n_long \
            else int(rng.integers(2, short + 1))
        ids[i, :ln] = rng.integers(1, 1000, size=ln)
        mask[i, :ln] = 1
    return ids, mask


def test_choose_bucket_plan_dominated_skips_probe(rng):
    n, full = 10, 64
    ids = np.zeros((n, full), np.int32)
    mask = np.zeros((n, full), np.int32)
    for i in range(n):
        ln = int(rng.integers(2, 8))
        ids[i, :ln] = rng.integers(1, 1000, size=ln)
        mask[i, :ln] = 1
    calls: list = []
    plan, info = choose_bucket_plan(
        _padding_invariant_encode(calls=calls), ids, mask, batch_size=16,
        buckets=(8, 16, 32, 64), device="cpu")
    assert plan is not None and info["method"] == "dominated"
    assert calls == []


def test_choose_bucket_plan_probe_decides_both_ways(rng):
    ids, mask = _probe_corpus(rng)
    plan, info = choose_bucket_plan(
        _padding_invariant_encode(fixed_s=0.02), ids, mask, batch_size=8,
        buckets=(8, 16, 32, 64), device="cpu")
    assert info["method"] == "probe" and plan is None
    plan, info = choose_bucket_plan(
        _padding_invariant_encode(per_width_s=0.0005), ids, mask,
        batch_size=8, buckets=(8, 16, 32, 64), device="cpu")
    assert info["method"] == "probe" and plan is not None
    assert info["est_bucketed_s"] * info["margin"] < info["est_flat_s"]


def test_choose_bucket_plan_small_job_follows_link(rng, monkeypatch):
    n, full = 12, 64
    ids = np.zeros((n, full), np.int32)
    mask = np.zeros((n, full), np.int32)
    for i in range(n):
        ln = 4 if i < 5 else (12 if i < 8 else 60)
        ids[i, :ln] = rng.integers(1, 1000, size=ln)
        mask[i, :ln] = 1
    calls: list = []
    enc = _padding_invariant_encode(calls=calls)
    for rtt_ms, expect_plan in ((28.0, False), (0.4, True)):
        monkeypatch.setattr(rtt_mod, "_memo", {"cpu": {
            "median_ms": rtt_ms, "p95_ms": rtt_ms, "min_ms": rtt_ms,
            "n": 1}})
        plan, info = choose_bucket_plan(enc, ids, mask, batch_size=8,
                                        buckets=(8, 16, 32, 64),
                                        device="cpu")
        assert info["method"].startswith("small_job")
        assert (plan is not None) == expect_plan
    assert calls == []


def test_encode_texts_bucketed_auto_reuses_probe_work(rng):
    ids, mask = _probe_corpus(rng)
    ref = encode_texts_bucketed(_padding_invariant_encode(), ids, mask,
                                batch_size=8, length_buckets=None)
    calls: list = []
    info: dict = {}
    auto = encode_texts_bucketed(
        _padding_invariant_encode(per_width_s=0.0005, calls=calls), ids, mask,
        batch_size=8, length_buckets="auto", device="cpu", info=info)
    np.testing.assert_allclose(auto, ref, atol=1e-6)
    assert len(calls) <= 8
    assert info["method"] == "probe" and "plan" in info


def test_encode_texts_bucketed_auto_parity(rng):
    n, full = 17, 64
    ids = np.zeros((n, full), np.int32)
    mask = np.zeros((n, full), np.int32)
    for i in range(n):
        ln = int(rng.integers(2, full + 1))
        ids[i, :ln] = rng.integers(1, 1000, size=ln)
        mask[i, :ln] = 1
    enc = _padding_invariant_encode()
    ref = encode_texts_bucketed(enc, ids, mask, batch_size=5,
                                length_buckets=None)
    auto = encode_texts_bucketed(enc, ids, mask, batch_size=5,
                                 length_buckets="auto", device="cpu")
    np.testing.assert_allclose(auto, ref, atol=1e-6)
    with pytest.raises(ValueError, match="auto"):
        encode_texts_bucketed(enc, ids, mask, length_buckets="bogus")
    with pytest.raises(ValueError, match="no texts"):
        encode_texts_bucketed(enc, ids[:0], mask[:0], length_buckets=None)


# ---- against the JAX package on the same tiny KEEP --------------------------

VOCAB = ("[PAD] [UNK] [CLS] [SEP] [MASK] normal tissue tumor melanoma "
         "cutaneous skin cancer malignant an image of a . benign").split()
VISION = dict(img_size=16, patch_size=8, embed_dim=32, depth=1, num_heads=2)
TEXT = dict(vocab_size=len(VOCAB), hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=64)
JCFG = jcfgs.KEEPConfig(vision=jcfgs.ViTConfig(**VISION),
                        text=jcfgs.BertConfig(**TEXT), projection_dim=32)
CFG = configs.KEEPConfig(vision=configs.ViTConfig(**VISION),
                         text=configs.BertConfig(**TEXT), projection_dim=32)


@pytest.fixture(scope="module")
def towers():
    params = jkeep.init(jax.random.PRNGKey(0), JCFG)
    port = KEEPModel(CFG)
    port.load_state_dict(from_jax_params(jax.tree.map(np.asarray, params),
                                         CFG))
    port.eval()
    jmodel = jkeep.KEEPModel(params=params, cfg=JCFG)

    def tenc(ids, mask):
        with torch.inference_mode():
            return port.encode_text(_t(ids).long(), _t(mask).long())

    jenc = jax.jit(lambda i, m: jmodel.encode_text(i, m))
    vocab = {w: i for i, w in enumerate(VOCAB)}
    return tenc, jenc, WordPieceTokenizer(vocab=vocab), JTokenizer(vocab=vocab)


def test_encode_texts_bucketed_exact_parity(towers, rng):
    """Bucketed == flat through the port's BERT tower (the JAX test's
    tolerance), and both == the JAX tower's flat features at 2e-5."""
    tenc, jenc, _, _ = towers
    n, full = 23, 48
    lengths = rng.integers(2, full + 1, size=n)
    lengths[0], lengths[1] = 2, full
    ids = np.zeros((n, full), np.int32)
    mask = np.zeros((n, full), np.int32)
    for i, ln in enumerate(lengths):
        ids[i, :ln] = rng.integers(1, len(VOCAB), size=ln)
        mask[i, :ln] = 1
    ref = tenc(ids, mask).numpy()
    got = encode_texts_bucketed(tenc, ids, mask, batch_size=7,
                                length_buckets=(8, 16, 32, 64))
    np.testing.assert_allclose(got, ref, atol=2e-6, rtol=1e-5)
    flat = encode_texts_bucketed(tenc, ids, mask, batch_size=7,
                                 length_buckets=None)
    np.testing.assert_array_equal(flat, ref)
    np.testing.assert_allclose(flat, np.asarray(jenc(ids, mask)), atol=2e-5,
                               rtol=2e-5)


PROMPTS = {
    str(i): {"classnames": {"Normal": n, "Tumor": t},
             "templates": tpl}
    for i, (n, t, tpl) in enumerate([
        ("normal tissue", "cutaneous melanoma", "an image of CLASSNAME ."),
        ("benign", "skin cancer", ["CLASSNAME .", "a CLASSNAME image ."]),
        ("normal skin", "malignant melanoma", "CLASSNAME"),
        ("normal tissue", "tumor", "an image of a CLASSNAME tissue .")])}


@pytest.mark.parametrize("buckets", [None, (4, 8), "auto"])
@pytest.mark.parametrize("add_normal", [False, True])
def test_build_classifiers_batched_equals_jax(towers, buckets, add_normal):
    tenc, jenc, ttok, jtok = towers
    label_map = {"Tumor": 0} if add_normal else {"Normal": 0, "Tumor": 1}
    kw = dict(add_normal=add_normal, max_length=16, batch_size=3,
              length_buckets=buckets)
    got = build_classifiers_batched(tenc, ttok, PROMPTS, label_map,
                                    device="cpu", **kw)
    ref = np.asarray(jcls.build_classifiers_batched(jenc, jtok, PROMPTS,
                                                    label_map, **kw))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("topn", [1, 5, 12])
def test_prompt_select_equals_jax(topn, rng):
    classifiers, feats = _screening_inputs(rng, p=16, c=3, n=300)
    merged, scores, order = tcls._prompt_select_jit(_t(classifiers),
                                                    _t(feats), topn)
    jmerged, jscores, jorder = jcls._prompt_select_jit(
        jnp.asarray(classifiers), jnp.asarray(feats), topn)
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores),
                               atol=1e-6)
    np.testing.assert_allclose(merged.numpy(), np.asarray(jmerged),
                               atol=1e-5)


def test_prompt_select_ties_go_to_the_lower_index(rng):
    """Duplicated classifiers score the same; jax.lax.top_k keeps the lower
    index first, and so does the port, whose sum runs in that order."""
    classifiers, feats = _screening_inputs(rng, p=6, n=50)
    classifiers = np.concatenate([classifiers, classifiers[::-1]])
    _, scores, order = tcls._prompt_select_jit(_t(classifiers), _t(feats), 9)
    _, _, jorder = jcls._prompt_select_jit(jnp.asarray(classifiers),
                                           jnp.asarray(feats), 9)
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    s = scores.numpy()[order.numpy()]
    assert (np.diff(s) <= 0).all()


@pytest.mark.parametrize("total,topn", [(9, 4), (1386, 50), (3, 50)])
def test_random_ensemble_equals_jax(total, topn, rng):
    classifiers = rng.standard_normal((total, 8, 2)).astype(np.float32)
    import random

    picks = [random.Random(c).randint(0, total - 1) for c in range(topn)]
    assert list(tcls._random_picks(total, topn)) == picks
    np.testing.assert_allclose(
        random_ensemble(_t(classifiers), topn).numpy(),
        np.asarray(jcls.random_ensemble(jnp.asarray(classifiers), topn)),
        atol=1e-6)
