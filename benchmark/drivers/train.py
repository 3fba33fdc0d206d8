"""KEEP's training step, as ``train.main`` runs it on a card: the step of
``train.trainer.make_train_step`` over fp32 master weights with bf16
compute, HyMetricLoss, clipping and AdamW, both towers unfrozen (an epoch
past the freeze phases), fed host batches through ``trainer.to_device``.

Traffic parameters (``traffic/<mix>.json``): ``batch_size`` and
``caption_num`` (groups a batch; instances = batch / groups), ``image_size``,
``caption_tokens`` ([least, most] WordPiece tokens a caption, [CLS] and
[SEP] included, padded to ``max_length``), ``hierarchy_nodes`` (nodes of
the seeded group hierarchy behind ``node_connection``), ``pool_batches``
(distinct host batches, cycled), ``loss``, ``optimizer`` (a constant
learning rate), ``checked_steps`` (the first steps, run in set-up through
the window's own call, that the reference follows) and ``trace_seconds``.

Output check, over the first ``checked_steps`` steps, each on its own
rows: the loss of each step; the clipped gradient of the first step, read
from the optimizer's first moment after it (``mu = (1 − b1) · g``); and
each leaf's change over the steps. Norms are compared leaf by leaf (the
program's leaves; the reference's q, k, v of a BERT layer make its fused
qkv), the gap measured against the larger of the reference leaf's norm and
the median leaf's; leaves whose reference gradient is under a thousandth of
the median leaf's are left out.
"""

from __future__ import annotations

import gc
import re
import time

import numpy as np
import torch

from benchmark import program, weights
from benchmark.reference import keep_ref, keep_train_ref
from benchmark.trace import span, traced


def program_leaf(key: str) -> str:
    """The program's parameter that holds a released-layout leaf."""
    for pat, rep in (
            (r"^visual\.patch_embed\.proj\.", "visual.patch_embed."),
            (r"^(visual\.blocks\.\d+\.ls\d)\.gamma$", r"\1"),
            (r"^visual_head\.0\.", "visual_head.fc1."),
            (r"^visual_head\.2\.", "visual_head.fc2."),
            (r"^text\.embeddings\.(word|position|token_type)_embeddings"
             r"\.weight$", r"text.embeddings.\1"),
            (r"^text\.embeddings\.LayerNorm\.", "text.embeddings.norm."),
            (r"^text\.encoder\.layer\.(\d+)\.attention\.self\."
             r"(query|key|value)\.", r"text.blocks.\1.attn.qkv."),
            (r"^text\.encoder\.layer\.(\d+)\.attention\.output\.dense\.",
             r"text.blocks.\1.attn.out."),
            (r"^text\.encoder\.layer\.(\d+)\.attention\.output\.LayerNorm\.",
             r"text.blocks.\1.attn.norm."),
            (r"^text\.encoder\.layer\.(\d+)\.intermediate\.dense\.",
             r"text.blocks.\1.mlp.fc1."),
            (r"^text\.encoder\.layer\.(\d+)\.output\.dense\.",
             r"text.blocks.\1.mlp.fc2."),
            (r"^text\.encoder\.layer\.(\d+)\.output\.LayerNorm\.",
             r"text.blocks.\1.norm."),
            (r"^text\.pooler\.dense\.", "text.pooler.")):
        if re.search(pat, key):
            return re.sub(pat, rep, key)
    return key


def grouped_norms(tensors: dict) -> dict:
    """Norms of released-layout leaves, grouped into the program's leaves."""
    sq: dict[str, float] = {}
    for k, t in tensors.items():
        n = program_leaf(k)
        sq[n] = sq.get(n, 0.0) + float((t.double() ** 2).sum())
    return {k: v ** 0.5 for k, v in sq.items()}


def worst_leaf_gap(got: dict, want: dict, keep: set) -> float:
    """The largest |‖got‖ − ‖want‖| over the kept leaves, each against the
    larger of ‖want‖ and the median kept leaf's."""
    med = float(np.median([want[k] for k in keep]))
    return max(abs(got[k] - want[k]) / max(want[k], med) for k in keep)


# ---- traffic -----------------------------------------------------------------


def hierarchy(n: int, rng: np.random.Generator) -> list:
    """A seeded forest: each node's parent, or -1 for a root."""
    return [-1] + [int(rng.integers(0, i)) if rng.random() < 0.8 else -1
                   for i in range(1, n)]


def ancestors(parent: list, i: int) -> set:
    out = set()
    while parent[i] >= 0:
        i = parent[i]
        out.add(i)
    return out


def make_batches(traffic: dict, model: dict, seed: int, device) -> list:
    """``pool_batches`` host batches, all rows distinct: normalised pixels,
    token ids, masks and each batch's ``node_connection``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed ^ 0x7A11)
    rng = np.random.default_rng(seed ^ 0x7A12)
    b, s_img = traffic["batch_size"], traffic["image_size"]
    groups, L = traffic["caption_num"], model["max_text_length"]
    vocab = model["text"]["vocab_size"]
    lo, hi = traffic["caption_tokens"]
    parent = hierarchy(traffic["hierarchy_nodes"], rng)
    anc = [ancestors(parent, i) for i in range(len(parent))]
    out = []
    for _ in range(traffic["pool_batches"]):
        pixels = torch.randn(b, s_img, s_img, 3, generator=gen,
                             device=device).cpu().numpy()
        ids = np.zeros((b, L), np.int64)
        lens = rng.integers(lo, hi + 1, b)
        for r, n in enumerate(lens):
            ids[r, 0], ids[r, n - 1] = 101, 102  # [CLS] ... [SEP]
            ids[r, 1: n - 1] = rng.integers(min(999, vocab // 2), vocab,
                                            n - 2)
        mask = (ids != 0).astype(np.int64)
        labels = rng.choice(len(parent), groups, replace=False)
        conn = np.ones((groups, groups), np.float32)
        for i, a in enumerate(labels):
            for j, c in enumerate(labels):
                if i != j and (a in anc[c] or c in anc[a]):
                    conn[i, j] = -1.0
        out.append({"pixels": pixels, "input_ids": ids,
                    "attention_mask": mask,
                    "token_type_ids": np.zeros_like(ids),
                    "node_connection": conn})
    return out


# ---- the program -------------------------------------------------------------


def build(cell):
    """The training model, its optimizer and state, and its step, as
    ``train.main`` builds them for an unfrozen epoch."""
    from keep_tpu_torch.compat.torch_loader import load_keep_state_dict
    from keep_tpu_torch.models.keep import KEEPModel
    from keep_tpu_torch.train import optim
    from keep_tpu_torch.train.trainer import (LossConfig, make_train_step,
                                              tree_state)

    cfg, traffic = cell.config, cell.traffic
    tr = cfg["train"]
    if tr["precision"] != "amp_bf16":
        raise ValueError(f"unknown training precision {tr['precision']!r}")
    kcfg = program.keep_config(cfg)
    model = KEEPModel(kcfg, dtype=torch.bfloat16, use_flash=tr["use_flash"],
                      weight_dtype=torch.float32, device=cell.device,
                      gelu_approx=tr["block_gelu"] == "tanh")
    sd = weights.make_state_dict(cfg["model"], cell.seed, cell.device)
    model.load_state_dict(load_keep_state_dict(sd, kcfg), strict=True)
    del sd
    model.train()
    o = traffic["optimizer"]
    tx = optim.AdamW(lambda count: o["lr"], decay_mask=optim.wd_mask(model),
                     weight_decay=o["weight_decay"], b1=o["b1"], b2=o["b2"],
                     eps=o["eps"], grad_clip_norm=o["grad_clip_norm"])
    state = tree_state(model, tx)
    loss = traffic["loss"]
    step = make_train_step(model, LossConfig(loss["kind"],
                                             traffic["caption_num"],
                                             loss["loss_subtype"]),
                           tx, remat=tr["remat"])
    return model, state, step


def checked_steps(cell, state, step, batches) -> dict:
    """The first steps through the window's own call and feed, and what the
    reference is held to: each loss, the first clipped gradient's leaf
    norms, each leaf's change over the steps."""
    from keep_tpu_torch.train.trainer import to_device

    b1 = cell.traffic["optimizer"]["b1"]
    theta0 = {n: p.detach().clone() for n, p in state.params.items()}
    losses, grad = [], None
    for k in range(cell.traffic["checked_steps"]):
        state, met = step(state, to_device(batches[k], cell.device))
        losses.append(float(met["loss"]))
        if k == 0:
            grad = {n: float((m.double() / (1 - b1)).norm())
                    for n, m in state.opt_state["mu"].items()}
    change = {n: float((p.detach().double() - theta0[n].double()).norm())
              for n, p in state.params.items()}
    return {"losses": losses, "grad": grad, "change": change}, state


def reference_readings(cell, batches, fp8: bool = False) -> dict:
    """The reference's losses, first clipped gradient and changes over the
    same steps and rows."""
    cfg, traffic = cell.config, cell.traffic
    sd = weights.make_state_dict(cfg["model"], cell.seed, cell.device)
    theta0 = {k: v.clone() for k, v in sd.items()}
    o = traffic["optimizer"]
    ref = keep_train_ref.Trainer(sd, cfg["model"], o, traffic["caption_num"],
                                 fp8=fp8)
    del sd
    losses, grad = [], None
    for k in range(traffic["checked_steps"]):
        batch = {n: torch.as_tensor(v).to(cell.device)
                 for n, v in batches[k].items()}
        loss, g = ref.step(batch)
        losses.append(loss)
        if k == 0:
            grad = grouped_norms(g)
        del g
    change = grouped_norms({k: ref.P[k].detach() - theta0[k]
                            for k in ref.P})
    return {"losses": losses, "grad": grad, "change": change}


def compare(got: dict, want: dict) -> dict:
    """The three numbers the check compares."""
    med = float(np.median(list(want["grad"].values())))
    keep = {k for k, v in want["grad"].items() if v >= 1e-3 * med}
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                   want["losses"]))
    return {"loss_gap": loss,
            "grad_gap": worst_leaf_gap(got["grad"], want["grad"], keep),
            "change_gap": worst_leaf_gap(got["change"], want["change"], keep)}


def free(*objs) -> None:
    del objs
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(cell, outcome) -> None:
    from keep_tpu_torch.train.trainer import to_device

    traffic = cell.traffic
    model, state, step = build(cell)
    batches = make_batches(traffic, cell.config["model"], cell.seed,
                           cell.device)
    got, state = checked_steps(cell, state, step, batches)
    if cell.device == "cuda":
        torch.cuda.synchronize()
    outcome.e2e["setup_s"] = time.perf_counter() - cell.t_start

    seconds = (min(cell.seconds, traffic["trace_seconds"]) if cell.trace
               else cell.seconds)
    n_pool, j, steps = len(batches), traffic["checked_steps"], 0
    before = program.launches()
    with traced(cell.trace) as trace:
        t0 = time.perf_counter()
        while time.perf_counter() < t0 + seconds:
            with span("to_device"):
                batch = to_device(batches[j % n_pool], cell.device)
            with span("step"):
                state, _ = step(state, batch)
            j += 1
            steps += 1
        if cell.device == "cuda":
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    outcome.launches = {k: v - before[k]
                        for k, v in program.launches().items()}
    trace.window_s = window_s
    outcome.trace, outcome.window_s = trace, window_s
    samples = steps * traffic["batch_size"]
    outcome.attempted, outcome.failed = samples, 0
    outcome.e2e["train_samples_per_s"] = samples / window_s
    outcome.work = {"steps": steps, "samples": samples}
    if cell.device == "cuda":
        outcome.memory_peak_bytes = torch.cuda.max_memory_allocated()

    # the program's state is freed before the reference runs
    del model, state, step
    free()
    keep_ref.no_tf32()
    want = reference_readings(cell, batches)
    for name, value in compare(got, want).items():
        outcome.checks.append({"name": name, "value": value,
                               "limit": cell.limits[name]["limit"]})


# ---- the readings behind the limits (benchmark/control.py) --------------------


def program_reading(cell) -> dict:
    _, state, step = build(cell)
    batches = make_batches(cell.traffic, cell.config["model"], cell.seed,
                           cell.device)
    got, state = checked_steps(cell, state, step, batches)
    del state, step
    free()
    keep_ref.no_tf32()
    return compare(got, reference_readings(cell, batches))


def control_reading(cell) -> dict:
    """The reference with its linears in fp8, in the program's place."""
    batches = make_batches(cell.traffic, cell.config["model"], cell.seed,
                           cell.device)
    keep_ref.no_tf32()
    low = reference_readings(cell, batches, fp8=True)
    free()
    return compare(low, reference_readings(cell, batches))


def _half_batch(trainer):
    """The loss over the first half of the rows and groups, its mean taken
    over them."""
    import dataclasses

    real = trainer.compute_loss

    def half(model, batch, loss_cfg, **kw):
        rows, groups = batch["pixels"].shape[0] // 2, loss_cfg.caption_num // 2
        cut = {k: v[:groups, :groups] if k == "node_connection" else v[:rows]
               for k, v in batch.items()}
        return real(model, cut, dataclasses.replace(loss_cfg,
                                                    caption_num=groups), **kw)

    return "compute_loss", half


# faults planted in the program for their readings: (the trainer module's
# attribute replaced, its replacement); a step that leaves its state
# unchanged reads 1 on ``change_gap`` and needs no run
FAULTS = {"half_batch": _half_batch}


def fault_reading(cell, fault: str) -> dict:
    from keep_tpu_torch.train import trainer

    name, broken = FAULTS[fault](trainer)
    real = getattr(trainer, name)
    setattr(trainer, name, broken)
    try:
        return program_reading(cell)
    finally:
        setattr(trainer, name, real)
