"""Zero-shot classifier construction and prompt-ensemble screening
(counterpart of ``keep_tpu/zeroshot/classifier.py``).

Reference semantics (WSI_evaluation/utils.py:64-146):
- per prompt dict ``{classnames: {label: name}, templates: str|[str]}``:
  encode each class's template texts, L2-normalise, mean over templates,
  renormalise, stack → [D, n_classes] classifier.
- prompt screening: per classifier, logits over all N tiles; score =
  mean((max − 2nd-max) − |max + 2nd-max − 1|); take the top-n classifiers
  by score, sum their matrices, L2-normalise the columns → the ensemble.

All prompt texts go through the text tower in a few fixed-shape batches,
bucketed by token length; the classifier stack is one segment-mean; the
screening is one ``[N, D] × [D, P·C]`` product and a top-k, on the
features' device.
Its fp32 products are taken at full fp32 precision whatever the caller's
TF32 setting (``ops.nn.ieee_fp32``). Ties in the top-k go to the lower
prompt index, as ``jax.lax.top_k`` orders them.

``first_template_only=True`` reproduces the reference's
``encode_text(...)[0]`` quirk (utils.py:74).
"""

from __future__ import annotations

import functools
import time
from collections import deque
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from keep_tpu_torch.ops.nn import ieee_fp32, l2_normalize


def expand_prompt(prompt: Mapping, label_map: Mapping[str, int],
                  add_normal: bool = False) -> list[list[str]]:
    """One prompt dict → per-class template texts, class order = label index
    (reference get_zeroshot_classifier, utils.py:86-104)."""
    classnames = prompt["classnames"]
    templates = prompt["templates"]
    idx_to_class = {v: k for k, v in label_map.items()}
    if len(idx_to_class) != len(label_map):
        # duplicate indices: inverting the dict would drop classes and
        # misalign every argmax label downstream
        raise ValueError(f"label_map indices must be unique; got {label_map}")
    if sorted(idx_to_class) != list(range(len(idx_to_class))):
        raise ValueError(
            f"label_map indices must be contiguous from 0; got {label_map}")
    if add_normal:
        idx_to_class[len(idx_to_class)] = "Normal"
    if isinstance(templates, str):
        templates = [templates]
    texts = []
    for idx in range(len(idx_to_class)):
        name = classnames[idx_to_class[idx]]
        texts.append([t.replace("CLASSNAME", name) for t in templates])
    return texts


def build_classifier(class_embeddings: Sequence,
                     first_template_only: bool = False) -> torch.Tensor:
    """Per-class [T, D] embeddings → [D, C] classifier (normalise → template
    mean → renormalise → stack; utils.py:76-83), on the embeddings'
    device."""
    cols = []
    for emb in class_embeddings:
        emb = torch.atleast_2d(torch.as_tensor(emb))
        if first_template_only:
            emb = emb[:1]
        col = l2_normalize(emb.float()).mean(dim=0)
        cols.append(col / torch.linalg.vector_norm(col))
    return torch.stack(cols, dim=1)


# Seconds per token position of the text tower at the classifier's batch,
# by torch device type, for the "auto" plan chooser's cost model. Only the
# relative size against the per-dispatch fixed cost matters. "cuda": one
# bf16 BERT-base dispatch of 256 × 256 tokens took 64.41 ms on an NVIDIA
# H100 80GB HBM3 at 700 W (chip_smoke.py's wsi_classifier phase,
# full_width_dispatch_ms). "cpu": the JAX package's CPU value.
SEC_PER_TOKEN = {"cuda": 64.41e-3 / (256 * 256), "cpu": 4.0e-4}
FEATURE_DIM_GUESS = 768  # fetch-size estimate for the cost model (KEEP D)


def plan_length_buckets(
    lengths: np.ndarray,
    full: int,
    batch_size: int,
    buckets: Sequence[int] = (32, 64, 128, 256),
    *,
    rtt_s: float | None = None,
    sec_per_token: float | None = None,
    device=None,
) -> tuple[tuple[int, ...] | None, dict]:
    """Bucketed vs flat encoding from a cost model.

    Bucketing saves padded-token compute but pays one dispatch (and one
    feature fetch) per extra batch. Cost per dispatch: ``fixed +
    batch_size·width·sec_per_token``, with ``fixed`` the measured null round
    trip on ``device`` (``utils.rtt``) plus the feature download at the
    measured rate. ``device`` is where the text tower runs (default: the
    card when there is one); it picks the ``SEC_PER_TOKEN`` entry and the
    device the round trip is measured on. Returns ``(bucket_tuple | None,
    info)``; ``None`` means flat wins.
    """
    from keep_tpu_torch.utils import rtt as _rtt

    lengths = np.asarray(lengths)
    n = int(lengths.size)
    device = _rtt.default_device(device)
    if sec_per_token is None:
        sec_per_token = SEC_PER_TOKEN.get(device.type, SEC_PER_TOKEN["cpu"])
    if rtt_s is None:
        meas = _rtt.measure_rtt(device=device)
        bw = _rtt.measure_bandwidth(device=device)
        fetch_mb = batch_size * FEATURE_DIM_GUESS * 4 / 2**20
        rtt_s = meas["median_ms"] / 1e3 + fetch_mb / bw["download_mb_per_s"]
    bks = sorted({min(int(b), full) for b in buckets if b > 0})
    if not bks or bks[-1] < full:
        bks.append(full)

    def batches(rows: int) -> int:
        return -(-rows // batch_size)

    est_flat = batches(n) * (rtt_s + batch_size * full * sec_per_token)
    est_bucketed, prev = 0.0, -1
    for b in bks:
        rows = int(((lengths > prev) & (lengths <= b)).sum())
        prev = b
        est_bucketed += batches(rows) * (rtt_s + batch_size * b * sec_per_token)
    choice = tuple(bks) if est_bucketed < est_flat else None
    return choice, {
        "est_bucketed_s": est_bucketed,
        "est_flat_s": est_flat,
        "per_dispatch_fixed_s": rtt_s,
        "sec_per_token": sec_per_token,
    }


# The measured probe ships bucketed only when it beats flat by more than
# 15%: the probe's blocking timings slightly overstate pipelined totals for
# the dispatch-heavy path, so near-ties go to flat (the reference's way).
BUCKET_PROBE_MARGIN = 1.15
# Below this many flat batches the probe's extra dispatches rival the job
# itself; then the link decides (see choose_bucket_plan).
PROBE_MIN_FLAT_BATCHES = 3


def _width_rows(lengths: np.ndarray, bks: Sequence[int]) -> list:
    """Row indices per bucket width (ascending widths, empty widths dropped).
    The first bucket also takes length-0 rows (all-pad masks)."""
    prev, out = -1, []
    for j, b in enumerate(bks):
        lo = -1 if j == 0 else prev
        rows = np.flatnonzero((lengths > lo) & (lengths <= b))
        prev = b
        if rows.size:
            out.append((int(b), rows))
    return out


def _pad_chunk(ids, mask, chunk, width, batch_size):
    """One batch of rows cut to ``width`` and padded to ``batch_size`` rows:
    one GEMM shape per width, so the probe and the job run the same cuBLAS
    algorithms."""
    bid = ids[chunk][:, :width]
    bmask = mask[chunk][:, :width]
    if bid.shape[0] < batch_size:
        pad = batch_size - bid.shape[0]
        bid = np.pad(bid, ((0, pad), (0, 0)))
        bmask = np.pad(bmask, ((0, pad), (0, 0)))
    return bid, bmask


def _fetch(feats) -> np.ndarray:
    """The encoder's output on the host (waits for a device tensor)."""
    if isinstance(feats, torch.Tensor):
        return feats.detach().cpu().numpy()
    return np.asarray(feats)


def choose_bucket_plan(
    encode_fn: Callable[[np.ndarray, np.ndarray], object],
    ids: np.ndarray,
    mask: np.ndarray,
    *,
    batch_size: int = 256,
    buckets: Sequence[int] = (32, 64, 128, 256),
    collect: list | None = None,
    device=None,
) -> tuple[tuple[int, ...] | None, dict]:
    """Bucketed vs flat, decided in three tiers:

    1. the analytic :func:`plan_length_buckets` says flat → flat;
    2. bucketing adds NO dispatches (every bucket packs into the flat batch
       count) → bucketed without probing: the same dispatch count at
       smaller widths cannot lose;
    3. otherwise, under ``PROBE_MIN_FLAT_BATCHES`` flat batches the link
       decides (co-located with the card: the analytic plan); above it a
       probe times two blocking dispatches per used width (min of 2) on
       real rows, whose features go back through ``collect`` as
       ``(features, row_indices)`` pairs so that the job reuses them.
       Bucketed ships only when its measured total beats flat by
       :data:`BUCKET_PROBE_MARGIN`.

    Returns ``(bucket_tuple | None, info)``; ``info["method"]`` names the
    tier.
    """
    ids = np.asarray(ids)
    mask = np.asarray(mask)
    lengths = mask.sum(axis=1)
    n, full = ids.shape
    plan, info = plan_length_buckets(lengths, full, batch_size, buckets,
                                     device=device)
    if plan is None:
        return None, {"method": "analytic_flat", **info}

    wr = _width_rows(lengths, plan)
    flat_batches = -(-n // batch_size)
    per_width_batches = {w: -(-rows.size // batch_size) for w, rows in wr}
    bucket_batches = sum(per_width_batches.values())
    if bucket_batches <= flat_batches:
        return plan, {"method": "dominated", "flat_batches": flat_batches,
                      "bucket_batches": bucket_batches, **info}
    if flat_batches < PROBE_MIN_FLAT_BATCHES:
        # the probe's extra dispatches would rival the job: on a slow link
        # ship flat, co-located keep the analytic plan
        from keep_tpu_torch.utils import rtt as _rtt

        small_choice = (None if _rtt.rtt_dominated(_rtt.measure_rtt(
            device=device)) else plan)
        return small_choice, {
            "method": "small_job_" + ("flat" if small_choice is None
                                      else "bucketed"),
            "flat_batches": flat_batches,
            "bucket_batches": bucket_batches, **info}

    def probe(width, rows):
        # two blocking dispatches on real rows, the min of 2 as the
        # estimate (a first call's setup or a spike inflates one sample);
        # the outputs are valid features → collect
        chunks = [rows[i: i + batch_size]
                  for i in range(0, rows.size, batch_size)][:2]
        seen = set()
        ts = []
        for chunk in chunks if len(chunks) > 1 else chunks * 2:
            bid, bmask = _pad_chunk(ids, mask, chunk, width, batch_size)
            t0 = time.perf_counter()
            feats = _fetch(encode_fn(bid, bmask))
            ts.append(time.perf_counter() - t0)
            key = int(chunk[0])
            if collect is not None and key not in seen:
                collect.append((feats[: chunk.size], chunk))
                seen.add(key)
        return min(ts)

    t_w = {w: probe(w, rows) for w, rows in wr}
    # the full-width sample comes from the END of the corpus: rows the job
    # encodes anyway, which shrink the bucketed remainder
    t_full = probe(full, np.arange(n)[-min(2 * batch_size, n):])
    est_flat = flat_batches * t_full
    est_bucketed = sum(per_width_batches[w] * t_w[w] for w in t_w)
    choice = plan if est_bucketed * BUCKET_PROBE_MARGIN < est_flat else None
    return choice, {
        "method": "probe",
        "flat_batches": flat_batches,
        "bucket_batches": bucket_batches,
        "probe_ms_per_width": {w: round(t * 1e3, 2) for w, t in t_w.items()},
        "probe_ms_full": round(t_full * 1e3, 2),
        "est_flat_s": round(est_flat, 4),
        "est_bucketed_s": round(est_bucketed, 4),
        "margin": BUCKET_PROBE_MARGIN,
        "analytic": info,
    }


def encode_texts_bucketed(
    encode_fn: Callable[[np.ndarray, np.ndarray], object],
    ids: np.ndarray,
    mask: np.ndarray,
    *,
    batch_size: int = 256,
    length_buckets: Sequence[int] | str | None = "auto",
    device=None,
    info: dict | None = None,
) -> np.ndarray:
    """Encode ``[N, L]`` padded token ids in per-length buckets → ``[N, D]``.

    BERT-family towers mask padded keys out of attention and pool from
    position 0, so ``encode(ids[:, :b])`` equals ``encode(ids)`` up to
    summation order whenever every real token fits in ``b``; the reference
    pads everything to 256 tokens while its prompts average ~15.
    ``length_buckets=None`` encodes flat (one full-width pass); ``"auto"``
    lets :func:`choose_bucket_plan` decide (``device`` is where
    ``encode_fn`` runs, for its cost model), reusing the probe's features.
    ``info``, when given, receives the chooser's record.

    ``encode_fn(ids, mask)`` returns features as a tensor (on any device)
    or an array; batch k+1 is dispatched before batch k is fetched, so on
    the card the fetch of one overlaps the compute of the next.
    """
    ids = np.asarray(ids)
    mask = np.asarray(mask)
    n, full = ids.shape
    lengths = mask.sum(axis=1)
    done = np.zeros(n, bool)
    out = None
    if isinstance(length_buckets, str):
        if length_buckets != "auto":
            raise ValueError(f"length_buckets={length_buckets!r} "
                             "(expected a tuple, None, or 'auto')")
        probed: list = []
        length_buckets, chosen = choose_bucket_plan(
            encode_fn, ids, mask, batch_size=batch_size, collect=probed,
            device=device)
        if info is not None:
            info.update(chosen, plan=length_buckets)
        for feats, chunk in probed:  # the probe's outputs are the job's
            if out is None:
                out = np.empty((n, feats.shape[1]), feats.dtype)
            out[chunk] = feats
            done[chunk] = True
    if length_buckets:
        buckets = sorted({min(int(b), full) for b in length_buckets if b > 0})
        if not buckets or buckets[-1] < full:
            buckets.append(full)
    else:
        buckets = [full]

    def dispatches():
        prev = -1  # the first bucket takes length-0 rows too (all-pad masks)
        for b in buckets:
            rows = np.flatnonzero((lengths > prev) & (lengths <= b) & ~done)
            prev = b
            for i in range(0, rows.size, batch_size):
                chunk = rows[i: i + batch_size]
                # the probe's _pad_chunk: the same shapes as its dispatches
                bid, bmask = _pad_chunk(ids, mask, chunk, b, batch_size)
                yield encode_fn(bid, bmask), chunk  # not fetched yet

    pending: deque = deque()

    def drain():
        nonlocal out
        feats, chunk = pending.popleft()
        feats = _fetch(feats)[: chunk.size]
        if out is None:
            out = np.empty((n, feats.shape[1]), feats.dtype)
        out[chunk] = feats

    for item in dispatches():
        pending.append(item)
        if len(pending) > 1:
            drain()
    while pending:
        drain()
    if out is None:  # n == 0
        raise ValueError("no texts to encode")
    return out


def build_classifiers_batched(
    encode_fn: Callable[[np.ndarray, np.ndarray], object],
    tokenizer,
    prompts: Mapping[str, Mapping],
    label_map: Mapping[str, int],
    add_normal: bool = False,
    max_length: int = 256,
    batch_size: int = 256,
    first_template_only: bool = False,
    length_buckets: Sequence[int] | str | None = "auto",
    device=None,
    info: dict | None = None,
) -> torch.Tensor:
    """All prompts → [P, D, C] classifier stack on ``device`` (default: the
    CPU), with batched text encoding.

    ``encode_fn(input_ids, attention_mask) -> [B, D]`` is the text tower;
    every text of every prompt, class and template goes through it in
    fixed-size batches (the tail padded), bucketed by token length
    (``encode_texts_bucketed``, which also gets ``device`` and ``info``).
    """
    keys = sorted(prompts.keys(), key=lambda k: int(k))
    all_texts: list[str] = []
    spans: list[list[tuple[int, int]]] = []  # per prompt, per class
    for k in keys:
        per_class = expand_prompt(prompts[k], label_map, add_normal)
        prompt_spans = []
        for texts in per_class:
            start = len(all_texts)
            all_texts.extend(texts)
            prompt_spans.append((start, len(all_texts)))
        spans.append(prompt_spans)

    enc = tokenizer(all_texts, max_length=max_length)
    feats = encode_texts_bucketed(
        encode_fn, enc["input_ids"], enc["attention_mask"],
        batch_size=batch_size, length_buckets=length_buckets, device=device,
        info=info)

    # one vectorised segment-mean over the [N, D] features on the host
    starts = np.array([s for ps in spans for (s, _) in ps])
    ends = np.array([e for ps in spans for (_, e) in ps])
    f = np.asarray(feats, np.float32)
    fn = f / np.maximum(np.linalg.norm(f, axis=1, keepdims=True), 1e-12)
    if first_template_only:
        cols = fn[starts]  # the reference's [0] quirk (utils.py:74)
    else:
        seg = np.repeat(np.arange(len(starts)), ends - starts)
        sums = np.zeros((len(starts), f.shape[1]), np.float32)
        np.add.at(sums, seg, fn)
        cols = sums / np.maximum((ends - starts)[:, None], 1)
    cols = cols / np.maximum(np.linalg.norm(cols, axis=1, keepdims=True), 1e-12)
    p, c = len(spans), len(spans[0])
    stack = np.ascontiguousarray(cols.reshape(p, c, -1).transpose(0, 2, 1))
    return torch.from_numpy(stack).to(device or "cpu")  # [P, D, C]


def rank_cls_scores(logits: torch.Tensor) -> torch.Tensor:
    """[P, N, C] logits → [P] screening scores (utils.py:107-117)."""
    # the two largest of each row, as top_k's values (a tie gives the max
    # twice): the max, then the max with that one entry masked.
    # torch.topk takes ~200 ms on the card at 1,386 × 100,000 rows of two
    largest, at = logits.max(dim=-1)
    second = logits.scatter(-1, at[..., None], float("-inf")).amax(dim=-1)
    diff = largest - second
    complement = torch.abs(largest + second - 1.0)
    return (diff - complement).mean(dim=-1)


def _prompt_select_jit(classifiers: torch.Tensor, features: torch.Tensor,
                       topn: int) -> tuple:
    """The screening itself (the JAX package jits a function of this name;
    here it is eager tensor ops on the features' device): → (merged [D, C],
    scores [P], order [topn])."""
    feats = l2_normalize(features.float())
    classifiers = classifiers.to(feats.device, torch.float32)
    p, d, c = classifiers.shape
    with ieee_fp32():
        # one [N, D] × [D, P·C] product that reads the features once (an
        # einsum to [P, N, C] runs P products of C columns each)
        logits = feats @ classifiers.permute(1, 0, 2).reshape(d, p * c)
    scores = rank_cls_scores(logits.view(-1, p, c).transpose(0, 1))
    # descending score, ties to the lower index (jax.lax.top_k's order); the
    # sum below runs in that order
    order = torch.argsort(-scores, stable=True)[:topn]
    merged = classifiers[order].sum(dim=0)  # [D, C]
    merged = merged / torch.linalg.vector_norm(merged, dim=0, keepdim=True)
    return merged, scores, order


def prompt_select(classifiers, features, topn: int = 50) -> torch.Tensor:
    """Screen [P, D, C] classifiers on [N, D] tile features and return the
    column-normalised sum of the top ``topn`` (utils.py:119-146) as [D, C],
    on the features' device. ``topn`` clamps to the pool size."""
    classifiers = torch.as_tensor(classifiers)
    topn = min(topn, int(classifiers.shape[0]))
    merged, _, _ = _prompt_select_jit(classifiers, torch.as_tensor(features),
                                      topn)
    return merged


@functools.lru_cache(maxsize=8)
def _random_picks(total: int, topn: int) -> tuple[int, ...]:
    import random

    # the reference's `random.seed(cter); randint` (the same Mersenne
    # seeding) without touching the caller's global random stream
    return tuple(random.Random(cter).randint(0, total - 1)
                 for cter in range(topn))


def random_ensemble(classifiers, topn: int = 50) -> torch.Tensor:
    """The no-screening ensemble (zeroshot_detection_WSI.py:60-67): the sum
    of ``topn`` seeded-random classifiers (with replacement),
    column-normalised, on the classifiers' device."""
    classifiers = torch.as_tensor(classifiers)
    picks = torch.tensor(_random_picks(int(classifiers.shape[0]), topn),
                         device=classifiers.device)
    merged = classifiers[picks].sum(dim=0)
    return merged / torch.linalg.vector_norm(merged, dim=0, keepdim=True)
