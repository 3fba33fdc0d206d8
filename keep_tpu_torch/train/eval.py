"""In-training evaluation: zero-shot classification and retrieval, and the
validation contrastive metrics (counterpart of ``keep_tpu/train/eval.py``).

- zeroshot-cls: encode every eval image; build ``rounds`` caption rounds
  from the prompt JSON (round i gives one caption per class); per round,
  1-NN over the class captions' features; the weighted F1's median and
  quartiles (midpoint percentiles) over the rounds.
- zeroshot-ret / zeroshot-po: encode image / text pairs; per text, the top
  50 images by similarity; p@10 / p@50 against the paired index.
- val: the contrastive loss and R@K / rank metrics on paired features.

The encoders are the caller's (the model's ``encode_image`` /
``encode_text`` on its device); the ranking math is the JAX package's host
numpy, copied, so that the same features give the same metrics.
"""

from __future__ import annotations

import json
from typing import Callable, Optional, Sequence

import numpy as np

from keep_tpu_torch.metrics import (classification_metrics,
                                    clip_retrieval_metrics,
                                    retrieval_precision)
from keep_tpu_torch.zeroshot.classifier import _fetch, encode_texts_bucketed


def label_captions_from_prompts(prompts: dict,
                                rounds: int = 50) -> dict[str, list[str]]:
    """{class: [caption per round]} from the prompt JSON. ``templates`` may
    be a string or a list; a list gives its first entry, one caption per
    round."""
    types = list(prompts["0"]["classnames"].keys())
    out = {t: [] for t in types}
    for t in types:
        for i in range(rounds):
            p = prompts[str(i)]
            tpl = p["templates"]
            if isinstance(tpl, (list, tuple)):
                tpl = tpl[0]
            out[t].append(tpl.replace("CLASSNAME", p["classnames"][t]))
    return out


def encode_in_batches(encode_fn: Callable, arrays: Sequence[np.ndarray],
                      batch_size: int) -> np.ndarray:
    """``encode_fn`` over batches of ``arrays`` (one shape for every batch:
    the tail is padded with zeros and its padding rows dropped), features
    fetched to the host."""
    n = arrays[0].shape[0]
    feats = []
    for i in range(0, n, batch_size):
        chunk = [a[i: i + batch_size] for a in arrays]
        if chunk[0].shape[0] < batch_size:
            pad = batch_size - chunk[0].shape[0]
            chunk = [np.pad(c, ((0, pad),) + ((0, 0),) * (c.ndim - 1))
                     for c in chunk]
        feats.append(_fetch(encode_fn(*chunk)))
    return np.concatenate(feats, axis=0)[:n]


def zeroshot_classification(image_features: np.ndarray, labels: Sequence[str],
                            caption_features: dict[str, np.ndarray],
                            rounds: int = 50) -> dict:
    """WF1 over ``rounds`` caption rounds. ``caption_features[class]`` is
    [rounds, D]."""
    img = image_features / np.linalg.norm(image_features, axis=1,
                                          keepdims=True)
    class_names = list(caption_features.keys())
    wf1 = []
    for i in range(rounds):
        round_emb = np.stack([caption_features[t][i] for t in class_names])
        round_emb = round_emb / np.linalg.norm(round_emb, axis=1,
                                               keepdims=True)
        idx = np.argmax(img @ round_emb.T, axis=1)
        preds = [class_names[j] for j in idx]
        wf1.append(classification_metrics(list(labels), preds)["WF1"])
    q1, med, q3 = np.percentile(np.asarray(wf1), (25, 50, 75),
                                method="midpoint")
    return {"zeroshot-cls-WF1-median": float(med),
            "zeroshot-cls-WF1-Q1": float(q1),
            "zeroshot-cls-WF1-Q3": float(q3),
            "rounds": wf1}


def zeroshot_retrieval(image_features: np.ndarray, text_features: np.ndarray,
                       topk: int = 50) -> dict:
    """Text → image retrieval p@10 / p@50."""
    img = image_features / np.linalg.norm(image_features, axis=1,
                                          keepdims=True)
    txt = text_features / np.linalg.norm(text_features, axis=1, keepdims=True)
    best = np.argsort(-(txt @ img.T), axis=1, kind="stable")[:, :topk]
    return retrieval_precision(list(range(len(img))), list(best))


def validation_metrics(image_features: np.ndarray, text_features: np.ndarray,
                       logit_scale: float) -> dict:
    """The validation contrastive loss and R@K / rank metrics."""
    img = np.asarray(image_features)
    txt = np.asarray(text_features)
    logits = logit_scale * img @ txt.T
    log_sm = logits - _logsumexp(logits, axis=1)
    log_sm_t = logits.T - _logsumexp(logits.T, axis=1)
    loss = -0.5 * (np.mean(np.diag(log_sm)) + np.mean(np.diag(log_sm_t)))
    out = {"val_contrastive_loss": float(loss)}
    out.update(clip_retrieval_metrics(img, txt, logit_scale))
    return out


def _logsumexp(x, axis):
    m = x.max(axis=axis, keepdims=True)
    return m + np.log(np.exp(x - m).sum(axis=axis, keepdims=True))


def zero_shot_eval(encode_image_fn: Callable, encode_text_fn: Callable,
                   tokenizer, data: dict, *,
                   prompts_path: Optional[str] = None, batch_size: int = 64,
                   max_length: int = 256, rounds: Optional[int] = None,
                   device=None) -> dict:
    """The in-training eval over the eval sets ``data`` holds.

    ``data`` maps a task to ONE (pixels, labels or texts) pair of host
    arrays (batched inside): 'zeroshot_cls': (pixels [N, S, S, 3], labels
    [N] str); 'zeroshot_ret' / 'zeroshot_po': (pixels, texts). Captions and
    texts go through ``zeroshot.classifier.encode_texts_bucketed``
    (``device``: where ``encode_text_fn`` runs, for its cost model)."""
    results = {}

    def encode_texts(texts):
        enc = tokenizer(list(texts), max_length=max_length)
        return encode_texts_bucketed(
            encode_text_fn, np.asarray(enc["input_ids"]),
            np.asarray(enc["attention_mask"]), batch_size=batch_size,
            device=device)

    if "zeroshot_cls" in data and prompts_path:
        pixels, labels = data["zeroshot_cls"]
        img = encode_in_batches(encode_image_fn, [pixels], batch_size)
        with open(prompts_path) as f:
            prompts = json.load(f)
        # the reference assumes exactly 50 prompt rounds; take the file's
        if rounds is None:
            rounds = min(50, len(prompts))
        caps = label_captions_from_prompts(prompts, rounds)
        cap_feats = {t: encode_texts(texts) for t, texts in caps.items()}
        cls = zeroshot_classification(img, labels, cap_feats, rounds)
        results.update({k: v for k, v in cls.items() if k != "rounds"})

    for task in ("zeroshot_ret", "zeroshot_po"):
        if task in data:
            pixels, texts = data[task]
            img = encode_in_batches(encode_image_fn, [pixels], batch_size)
            ret = zeroshot_retrieval(img, encode_texts(texts))
            tag = task.split("_")[1]
            results[f"zeroshot-{tag}-p@10"] = ret["p@10"]
            results[f"zeroshot-{tag}-p@50"] = ret["p@50"]
    return results
