"""The port's in-training eval (``keep_tpu_torch.train.eval``, the eval
sets of ``train.main.build_eval_data`` and ``metrics.retrieval``) against
the JAX package's on the CPU: the host metrics equal on the same features,
the encoders' features within 2e-5 (fp32, tiny widths, LoRA merged), the
eval sets' pixels within one 8-bit step, and the training CLI with CSV eval
sets (twin of ``tests/test_train_main.py::test_train_with_csv_eval_sets``)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from keep_tpu.metrics import retrieval as jretrieval
from keep_tpu.models import keep as jkeep
from keep_tpu.text.tokenizer import WordPieceTokenizer as JTokenizer
from keep_tpu.train import data as jdata
from keep_tpu.train import eval as jeval
from keep_tpu.train import lora as jlora
from keep_tpu.train import main as jmain
from keep_tpu.train.config import TrainRunConfig as JRunConfig
from keep_tpu_torch.compat.torch_loader import from_jax_lora
from keep_tpu_torch.configs import PreprocessConfig
from keep_tpu_torch.metrics import clip_retrieval_metrics, retrieval_precision
from keep_tpu_torch.text.tokenizer import WordPieceTokenizer
from keep_tpu_torch.train import data
from keep_tpu_torch.train import eval as zs_eval
from keep_tpu_torch.train import lora
from keep_tpu_torch.train import main as tmain
from keep_tpu_torch.train.config import TrainRunConfig
from tests.test_torch_train import (CFG, JCFG, VOCAB, _port_model,  # noqa: F401
                                    _run_config, jparams, run_dirs)

# one 8-bit step of the eval transform, normalised (both packages round
# half to even between the bicubic passes; tests/test_torch_preprocess.py)
STEP = 1.0 / 255.0 / min(PreprocessConfig().std) + 1e-6


def _features(rng, n, d=16, ties=False):
    x = rng.standard_normal((n, d)).astype(np.float32)
    if ties:  # a coarse grid: equal scores, so the sorts' tie order counts
        x = np.round(x * 2) / 2
    return x


@pytest.mark.parametrize("ties", [False, True])
def test_retrieval_metrics_equal_jax(rng, ties):
    img, txt = _features(rng, 40, ties=ties), _features(rng, 40, ties=ties)
    assert (clip_retrieval_metrics(img, txt, 3.0)
            == jretrieval.clip_retrieval_metrics(img, txt, 3.0))
    preds = [rng.permutation(40)[:60] for _ in range(40)]
    targets = list(rng.integers(0, 40, 40))
    for ks in ((10, 50), (1, 5)):
        assert (retrieval_precision(targets, preds, ks)
                == jretrieval.retrieval_precision(targets, preds, ks))


def _prompts(rounds: int, classes=("normal", "tumor")) -> dict:
    names = {"normal": "normal tissue", "tumor": "tumor", "mel": "melanoma"}
    return {str(i): {"classnames": {c: names[c] for c in classes},
                     "templates": (["an image of CLASSNAME .", "x"]
                                   if i % 2 else "CLASSNAME is shown .")}
            for i in range(rounds)}


def test_host_eval_functions_equal_jax(rng):
    """Captions from prompts, zero-shot classification (midpoint
    percentiles), retrieval and the validation metrics: equal to the JAX
    package's on the same features."""
    prompts = _prompts(7, ("normal", "tumor", "mel"))
    for rounds in (1, 7):
        assert (zs_eval.label_captions_from_prompts(prompts, rounds)
                == jeval.label_captions_from_prompts(prompts, rounds))
    img = _features(rng, 30)
    labels = list(rng.choice(["normal", "tumor", "mel"], 30))
    caps = {c: _features(rng, 7) for c in ("normal", "tumor", "mel")}
    assert (zs_eval.zeroshot_classification(img, labels, caps, 7)
            == jeval.zeroshot_classification(img, labels, caps, 7))
    txt = _features(rng, 30)
    assert (zs_eval.zeroshot_retrieval(img, txt, topk=5)
            == jeval.zeroshot_retrieval(img, txt, topk=5))
    unit = lambda x: x / np.linalg.norm(x, axis=1, keepdims=True)  # noqa
    assert (zs_eval.validation_metrics(unit(img), unit(txt), 14.3)
            == jeval.validation_metrics(unit(img), unit(txt), 14.3))


def test_encode_in_batches_pads_the_tail(rng):
    """One shape for every batch (the tail zero-padded), the padding rows
    dropped, as the JAX package's; tensors are fetched to the host."""
    x = rng.standard_normal((10, 4)).astype(np.float32)
    y = rng.integers(0, 9, (10, 3))
    shapes = []

    def enc(a, b):
        shapes.append((a.shape, b.shape))
        return torch.from_numpy(a * 2.0)

    got = zs_eval.encode_in_batches(enc, [x, y], 4)
    assert shapes == [((4, 4), (4, 3))] * 3
    np.testing.assert_array_equal(got, x * 2.0)
    np.testing.assert_array_equal(
        got, jeval.encode_in_batches(lambda a, b: a * 2.0, [x, y], 4))


def _eval_data(rng, n=12):
    pixels = rng.standard_normal((n, 16, 16, 3)).astype(np.float32)
    labels = list(rng.choice(["normal", "tumor"], n))
    texts = [["an image of lung adenocarcinoma .", "melanoma of skin .",
              "normal tissue is shown ."][i % 3] for i in range(n)]
    return {"zeroshot_cls": (pixels, labels),
            "zeroshot_ret": (pixels[::-1].copy(), texts),
            "val": (pixels, texts)}


def test_zero_shot_eval_matches_jax(jparams, rng, tmp_path):
    """The eval's encoders (``train.main.eval_encoders`` on LoRA-merged
    weights) against the JAX encoders on ``apply_lora``: features within
    2e-5; ``zero_shot_eval`` and ``validation_metrics`` on the same
    encoders' features (the JAX ones): equal metrics."""
    ad = jlora.init_lora(jax.random.PRNGKey(1), jparams, rank=2)
    ad = jax.tree.map(lambda x: np.asarray(x) + np.float32(0.03), ad)
    merged = jlora.apply_lora(jax.tree.map(jnp.asarray, jparams),
                              jax.tree.map(jnp.asarray, ad), 2.0)
    model = _port_model(jparams)
    weights = lora.apply_lora({n: p.detach()
                               for n, p in model.named_parameters()},
                              from_jax_lora(ad, CFG), 2.0)
    enc_img, enc_txt = tmain.eval_encoders(model, weights, "cpu")

    def jenc_img(px):
        return jkeep.encode_image(merged, jnp.asarray(px), JCFG,
                                  use_flash=True)

    def jenc_txt(ids, mask):
        return jkeep.encode_text(merged, jnp.asarray(ids), jnp.asarray(mask),
                                 cfg=JCFG, use_flash=True)

    evald = _eval_data(rng)
    vocab = {w: i for i, w in enumerate(VOCAB)}
    tok, jtok = WordPieceTokenizer(vocab=vocab), JTokenizer(vocab=vocab)
    pixels = evald["val"][0]
    np.testing.assert_allclose(enc_img(pixels).numpy(),
                               np.asarray(jenc_img(pixels)), atol=2e-5,
                               rtol=0)
    enc = tok(evald["val"][1], max_length=16)
    np.testing.assert_array_equal(
        enc["input_ids"], jtok(evald["val"][1], max_length=16)["input_ids"])
    np.testing.assert_allclose(
        enc_txt(enc["input_ids"], enc["attention_mask"]).numpy(),
        np.asarray(jenc_txt(enc["input_ids"], enc["attention_mask"])),
        atol=2e-5, rtol=0)
    # the model's own parameters are back in place after each encode
    assert all(isinstance(p, torch.nn.Parameter)
               for p in model.parameters())

    (tmp_path / "prompts.json").write_text(json.dumps(_prompts(5)))
    kw = dict(prompts_path=str(tmp_path / "prompts.json"), batch_size=4,
              max_length=16)
    got = zs_eval.zero_shot_eval(jenc_img, jenc_txt, tok, evald, **kw)
    want = jeval.zero_shot_eval(jenc_img, jenc_txt, jtok, evald, **kw)
    assert got == want
    assert set(got) == {"zeroshot-cls-WF1-median", "zeroshot-cls-WF1-Q1",
                        "zeroshot-cls-WF1-Q3", "zeroshot-ret-p@10",
                        "zeroshot-ret-p@50"}
    vimg = zs_eval.encode_in_batches(jenc_img, [pixels], 4)
    vtxt = zs_eval.encode_in_batches(
        jenc_txt, [enc["input_ids"], enc["attention_mask"]], 4)
    assert (zs_eval.validation_metrics(vimg, vtxt, 14.3)
            == jeval.validation_metrics(
                jeval.encode_in_batches(jenc_img, [pixels], 4),
                jeval.encode_in_batches(
                    jenc_txt, [enc["input_ids"], enc["attention_mask"]], 4),
                14.3))


@pytest.fixture(scope="module")
def eval_dirs(tmp_path_factory):
    """Eval images of two source sizes, comma-separated cls / ret / val CSVs
    (val images resolve against the training image root) and a prompt
    JSON; a tab-separated copy of the ret CSV."""
    d = tmp_path_factory.mktemp("evaldata")
    rng = np.random.default_rng(1)
    for i in range(6):
        shape = (16, 16, 3) if i % 2 else (20, 24, 3)
        Image.fromarray(rng.integers(0, 255, shape, dtype=np.uint8)).save(
            d / f"ev{i}.png")
    (d / "cls.csv").write_text("image_name,label\n" + "\n".join(
        f"ev{i}.png,{'tumor' if i % 2 else 'normal'}" for i in range(6)))
    (d / "ret.csv").write_text("image_name,caption\n" + "\n".join(
        f"ev{i}.png,an image of lung cancer ." for i in range(6)))
    (d / "ret.tsv").write_text("image_name\tcaption\n" + "\n".join(
        f"ev{i}.png\tlung tumor, normal tissue" for i in range(6)))
    (d / "prompts.json").write_text(json.dumps(_prompts(3)))
    (d / "val.csv").write_text("image_name,caption\n" + "\n".join(
        f"im{i}.png,melanoma of skin ." for i in range(6)))
    return d


def _with_eval_sets(raw: dict, d) -> dict:
    raw["dataset"].update(
        zeroshot_cls=str(d / "cls.csv"), zeroshot_cls_imdir=str(d),
        zeroshot_cls_prompts=str(d / "prompts.json"),
        zeroshot_ret=str(d / "ret.csv"), zeroshot_ret_imdir=str(d),
        val_data=str(d / "val.csv"))
    return raw


def test_csv_dataset_matches_jax(eval_dirs, run_dirs):
    """CsvTextImageDataset (comma with the tab fallback, an explicit
    separator, word dropout from a seed) and ``dataset_image_names`` equal
    the JAX package's."""
    for path, sep in (("ret.csv", "both"), ("ret.tsv", "both"),
                      ("ret.tsv", "\t")):
        for drop in (False, True):
            kw = dict(caption_key="caption", sep=sep, text_drop=drop, seed=4)
            ds = data.CsvTextImageDataset(str(eval_dirs / path), **kw)
            jds = jdata.CsvTextImageDataset(str(eval_dirs / path), **kw)
            assert len(ds) == len(jds) == 6
            assert [dataclasses.astuple(ds[i]) for i in range(6)] == [
                dataclasses.astuple(jds[i]) for i in range(6)]
            assert (data.dataset_image_names(ds)
                    == jdata.dataset_image_names(jds))
    gkw = dict(num_instance=2, seed=0)
    groups = str(run_dirs / "groups.json")
    assert (data.dataset_image_names(data.GroupDataset(groups, **gkw))
            == jdata.dataset_image_names(jdata.GroupDataset(groups, **gkw)))
    with pytest.raises(TypeError, match="unsupported"):
        data.dataset_image_names([])


def test_build_eval_data_matches_jax(eval_dirs, run_dirs, tmp_path):
    """The eval sets the port preprocesses (on the CPU here) against the JAX
    package's: the same labels and captions, the pixels within one 8-bit
    step (tests/test_torch_preprocess.py)."""
    raw = _with_eval_sets(_run_config(run_dirs, tmp_path), eval_dirs)
    got = tmain.build_eval_data(TrainRunConfig.from_dict(raw), device="cpu")
    want = jmain.build_eval_data(JRunConfig.from_dict(raw))
    assert got.keys() == want.keys() == {"zeroshot_cls", "zeroshot_ret",
                                         "val"}
    for task in got:
        assert got[task][1] == want[task][1]
        assert got[task][0].shape == (6, 16, 16, 3)
        np.testing.assert_allclose(got[task][0], np.asarray(want[task][0]),
                                   atol=STEP, rtol=0)


def test_train_with_csv_eval_sets(eval_dirs, run_dirs, tmp_path):
    """The eval through the CSV path in ``train()``: zero-shot WF1
    quartiles, retrieval p@k and the validation metrics land in the result
    and in results.jsonl, each finite, the shares in [0, 1] and the ranks
    ≥ 1."""
    raw = _with_eval_sets(_run_config(run_dirs, tmp_path, epochs=1,
                                      zeroshot_frequency=1), eval_dirs)
    res = tmain.train(TrainRunConfig.from_dict(raw), device="cpu")
    for key in ("zeroshot-cls-WF1-median", "zeroshot-ret-p@10",
                "val_contrastive_loss", "image_to_text_R@1",
                "text_to_image_median_rank"):
        assert key in res, (key, sorted(res))
    for k, v in res.items():
        if k in ("epoch", "train_loss"):
            continue
        assert np.isfinite(v), k
        if "rank" in k:
            assert v >= 1, k
        elif k != "val_contrastive_loss":
            assert 0 <= v <= 1, k
    lines = (tmp_path / "exp" / "checkpoints" / "results.jsonl"
             ).read_text().splitlines()
    assert json.loads(lines[-1])["zeroshot-cls-WF1-median"] == \
        res["zeroshot-cls-WF1-median"]
