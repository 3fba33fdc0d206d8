"""OpenCLIP zero-shot classifier builder and ImageNet eval (counterpart of
``keep_tpu/zeroshot/openclip.py``; the reference's
``zero_shot_classifier.py:21-69`` and ``zero_shot.py``).

Per class batch, every (class name × template) text is encoded,
L2-normalised, reshaped [classes, templates, D], averaged over the
templates and normalised again; the columns of all batches form the
[D, num_classes] weights. Classes go in batches of a fixed size (the last
padded with its final class), so the text encoder sees one shape.
"""

from __future__ import annotations

from typing import Callable, Sequence, Union

import numpy as np
import torch

from keep_tpu_torch.ops.nn import l2_normalize


def build_zero_shot_classifier(
        encode_text: Callable[[np.ndarray, np.ndarray], torch.Tensor],
        tokenizer, classnames: Sequence[str],
        templates: Sequence[Union[Callable, str]],
        num_classes_per_batch: int = 10,
        max_length: int = 77) -> torch.Tensor:
    """→ [D, num_classes] fp32 zero-shot weights, on the device
    ``encode_text`` returns. ``tokenizer(texts, max_length=...)`` gives
    ``{"input_ids", "attention_mask"}``; ``encode_text(input_ids,
    attention_mask)`` takes them as numpy arrays and returns [N, D]
    features (normalised here); ``templates`` are ``'{}'`` format strings
    or callables."""
    if not templates or not classnames:
        raise ValueError("need at least one class name and one template")
    use_format = isinstance(templates[0], str)
    nt, nb = len(templates), num_classes_per_batch
    cols = []
    for start in range(0, len(classnames), nb):
        batch = list(classnames[start: start + nb])
        real = len(batch)
        batch += [batch[-1]] * (nb - real)  # one shape for every batch
        texts = [t.format(c) if use_format else t(c)
                 for c in batch for t in templates]
        enc = tokenizer(texts, max_length=max_length)
        emb = encode_text(np.asarray(enc["input_ids"]),
                          np.asarray(enc["attention_mask"]))
        emb = l2_normalize(torch.as_tensor(emb).float())
        emb = emb.reshape(nb, nt, -1).mean(dim=1)
        cols.append(l2_normalize(emb)[:real])
    return torch.cat(cols, dim=0).T


def accuracy(logits: torch.Tensor, target: torch.Tensor,
             topk=(1,)) -> list[float]:
    """Top-k accuracies (reference zero_shot.py:18-21); ties rank the lower
    class first, as the JAX package's stable sort does."""
    pred = torch.argsort(-logits, dim=-1, stable=True)[:, :max(topk)]
    correct = pred == target.to(pred.device)[:, None]
    n = logits.shape[0]
    return [float(correct[:, :k].any(dim=1).sum()) / n for k in topk]


def zero_shot_eval_imagenet(encode_image: Callable[[torch.Tensor],
                                                   torch.Tensor],
                            classifier: torch.Tensor, batches,
                            logit_scale: float = 100.0) -> dict:
    """Zero-shot eval over (pixels, labels) batches: logits = scale ·
    normalised features @ classifier, top-1 and top-5 accuracy (the
    reference's zero_shot.py ``run()`` on the OpenCLIP path)."""
    top1 = top5 = n = 0.0
    for pixels, labels in batches:
        feats = l2_normalize(encode_image(torch.as_tensor(pixels)).float())
        logits = logit_scale * feats @ classifier.float().to(feats.device)
        a1, a5 = accuracy(logits, torch.as_tensor(labels), topk=(1, 5))
        b = len(labels)
        top1 += a1 * b
        top5 += a5 * b
        n += b
    return {"imagenet-zeroshot-val-top1": top1 / max(n, 1),
            "imagenet-zeroshot-val-top5": top5 / max(n, 1)}
