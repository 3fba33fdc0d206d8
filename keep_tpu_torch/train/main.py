"""Training entry point: ``python -m keep_tpu_torch.train.main --config
cfg.yml`` (counterpart of ``keep_tpu/train/main.py``), single process on one
device.

Experiment naming, logging, model build (random init, optional pretrained
towers), resume-latest, data, LR schedule, freeze phases with the freeze
check, the epoch loop, results.jsonl and checkpoints every
``save_frequency`` epochs. On a CUDA device with ``model.use_flash`` the
attention of both towers runs the hand-written kernels (forward and
backward); on the CPU the same calls take their plain versions because the
tensors are on the CPU. The device is ``--device`` (``train(device=...)``),
``cuda`` by default: without a card the run raises unless the caller asks
for the CPU with ``--device cpu``; it never moves to the CPU by itself.

Not ported yet, and refused with NotImplementedError: more than one process
or device and the ``solver.tp/pp/sp/ep/fsdp`` layouts (ROADMAP queue 1,
item 10), ``solver.lora_rank`` (item 9, ``train/lora.py``), the MoE trunk
(item 11), the in-training zero-shot and validation eval (item 9,
``train/eval.py``, with the zero-shot classifier of item 6),
``save.async_checkpointing`` and ``save.remote_sync`` (item 9).
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import logging
import os
import time
from typing import Optional

import numpy as np
import torch

from keep_tpu_torch.models.keep import KEEPModel
from keep_tpu_torch.train import checkpoint as ckpt
from keep_tpu_torch.train import optim, schedules
from keep_tpu_torch.train.config import TrainRunConfig
from keep_tpu_torch.train.data import (BatchIterator, GroupDataset,
                                       Prefetcher, load_knowledge_json)
from keep_tpu_torch.train.freeze import FreezeSchedule, diff_report, snapshot
from keep_tpu_torch.train.loss import DOGraph
from keep_tpu_torch.train.trainer import (LossConfig, make_accum_train_step,
                                          make_train_step, to_device,
                                          tree_state)
from keep_tpu_torch.utils.logging import (AverageMeter, append_results,
                                          setup_logging)


def experiment_name(cfg: TrainRunConfig) -> str:
    if cfg.save.experiment_name:
        return cfg.save.experiment_name
    date_str = datetime.datetime.now().strftime("%Y_%m_%d-%H_%M_%S")
    return "-".join([date_str, f"model_{cfg.model.type}",
                     f"lr_{cfg.solver.lr}", f"b_{cfg.dataloader.batch_size}",
                     f"e_{cfg.solver.epochs}"])


def build_schedule(cfg: TrainRunConfig, steps_per_epoch: int):
    total = cfg.solver.epochs * steps_per_epoch
    s = cfg.solver
    if s.lr_scheduler == "cosine":
        return schedules.cosine_lr(s.lr, s.warmup, total)
    if s.lr_scheduler == "const":
        return schedules.const_lr(s.lr, s.warmup)
    if s.lr_scheduler == "const-cooldown":
        return schedules.const_lr_cooldown(s.lr, s.warmup, total,
                                           s.cooldown_steps, s.cooldown_power,
                                           s.cooldown_end_lr)
    raise ValueError(f"unknown lr scheduler {s.lr_scheduler}")


def check_supported(cfg: TrainRunConfig) -> None:
    """Raises NotImplementedError for what the port does not train yet,
    naming the ROADMAP item that brings it."""
    s = cfg.solver
    refused = {
        "solver.tp / pp / sp / ep / fsdp (ROADMAP queue 1, item 10: "
        "distributed)": (s.tp > 1 or s.pp > 1 or s.sp or s.ep > 1 or s.fsdp),
        "more than one process (ROADMAP queue 1, item 10: distributed)":
            int(os.environ.get("WORLD_SIZE", "1")) > 1,
        "more than one CUDA device (ROADMAP queue 1, item 10: distributed; "
        "pin one with CUDA_VISIBLE_DEVICES)": torch.cuda.device_count() > 1,
        "solver.lora_rank > 0 (ROADMAP queue 1, item 9: train/lora.py)":
            s.lora_rank > 0,
        "save.async_checkpointing (ROADMAP queue 1, item 9: checkpoints)":
            cfg.save.async_checkpointing,
        "save.remote_sync (ROADMAP queue 1, item 9: train/sync.py)":
            bool(cfg.save.remote_sync),
        "an MoE trunk, keep.vision.moe_experts > 0 (ROADMAP queue 1, "
        "item 11: models/moe.py)": cfg.keep.vision.moe_experts > 0,
        "in-training eval, dataset.zeroshot_cls / zeroshot_ret / val_data "
        "(ROADMAP queue 1, item 9: train/eval.py, with the zero-shot "
        "classifier of item 6)": bool(cfg.dataset.zeroshot_cls
                                      or cfg.dataset.zeroshot_ret
                                      or cfg.dataset.val_data),
        "dataset.tokenizer_type other than 'bert' (ROADMAP queue 1, item 11)":
            cfg.dataset.tokenizer_type != "bert",
    }
    bad = [k for k, v in refused.items() if v]
    if bad:
        raise NotImplementedError("not ported yet: " + "; ".join(bad))


def build_model(cfg: TrainRunConfig, device) -> KEEPModel:
    """A KEEP drawn with the statistics of the JAX package's ``keep.init``
    from ``cfg.seed``, fp32 master weights, compute in the run's precision,
    the exact GELU as the JAX trainer uses, and the optional pretrained
    towers loaded over the random ones."""
    from keep_tpu_torch.compat.torch_loader import (load_hf_bert_state_dict,
                                                    load_state_dict_file,
                                                    load_timm_vit_state_dict)

    dtype = torch.bfloat16 if "bf16" in cfg.model.precision else torch.float32
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    model = KEEPModel.init(cfg.keep, gen, logit_scale=cfg.model.logit_scale,
                           device=device, dtype=dtype,
                           weight_dtype=torch.float32,
                           use_flash=cfg.model.use_flash, gelu_approx=False)
    towers = {}
    if cfg.model.pretrained_image:
        towers.update(load_timm_vit_state_dict(
            load_state_dict_file(cfg.model.pretrained_image), cfg.keep))
        logging.info("loaded pretrained visual tower from %s",
                      cfg.model.pretrained_image)
    if cfg.model.pretrained_text:
        towers.update(load_hf_bert_state_dict(
            load_state_dict_file(cfg.model.pretrained_text), cfg.keep))
        logging.info("loaded pretrained text tower from %s",
                      cfg.model.pretrained_text)
    if towers:
        missing = set(towers) - set(model.state_dict())
        if missing:
            raise KeyError(f"pretrained towers carry unknown keys: "
                           f"{sorted(missing)[:5]}")
        model.load_state_dict(towers, strict=False)
    return model


def _tokenizer(cfg: TrainRunConfig):
    from keep_tpu_torch.text.tokenizer import WordPieceTokenizer

    vocab = cfg.dataset.vocab_path or cfg.dataset.img_dir
    if vocab.endswith(".txt"):
        return WordPieceTokenizer(vocab)
    return WordPieceTokenizer.from_pretrained(vocab)


def resolve_device(name: str | torch.device) -> torch.device:
    """The torch device to train on. A CUDA device without a card raises
    SystemExit naming ``--device cpu``: the run never falls back to the CPU
    by itself."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to train on the "
                         "CPU")
    return device


def train(cfg: TrainRunConfig, tokenizer=None, dataset=None,
          image_loader=None, eval_data=None, params: Optional[dict] = None,
          device: str | torch.device = "cuda") -> dict:
    """Runs training on ``device`` and returns the last epoch's record.
    ``dataset``, ``image_loader`` and ``tokenizer`` replace the configured
    sources; ``params`` (a ``KEEPModel`` state dict) replaces the random
    initial weights. ``eval_data`` must be empty: the in-training eval is
    not ported."""
    check_supported(cfg)
    if eval_data:
        raise NotImplementedError(
            "in-training eval is not ported yet (ROADMAP queue 1, item 9: "
            "train/eval.py)")
    device = resolve_device(device)
    name = experiment_name(cfg)
    out_dir = os.path.join(cfg.save.output_dir, name)
    ckpt_dir = os.path.join(out_dir, "checkpoints")
    os.makedirs(ckpt_dir, exist_ok=True)
    setup_logging(os.path.join(out_dir, "out.log"))
    logging.info("experiment %s → %s on %s", name, out_dir, device)
    with open(os.path.join(out_dir, "params.txt"), "w") as f:
        f.write(json.dumps(dataclasses.asdict(cfg), indent=2, default=str))
    if cfg.save.copy_codebase:
        _copy_codebase(out_dir)

    from keep_tpu_torch.utils.writers import MetricWriter

    writer = MetricWriter(out_dir, wandb_project=cfg.save.wandb_project)
    tokenizer = tokenizer or _tokenizer(cfg)
    nodes = (load_knowledge_json(cfg.dataset.knowledge_file)
             if cfg.dataset.knowledge_file else None)
    do_graph = DOGraph({k: v["parent"] for k, v in nodes.items()}
                       if nodes else {})
    if dataset is None:
        dataset = GroupDataset(
            cfg.dataset.train_data,
            num_instance=cfg.dataloader.batch_size // cfg.dataloader.caption_num,
            knowledge_json=nodes, text_drop=cfg.dataloader.text_drop,
            labeled_cap=cfg.dataset.label_cap, seed=cfg.seed)
    preload = None
    if cfg.dataset.preload_data and image_loader is None:
        from keep_tpu_torch.train.data import preload_images

        preload = preload_images(dataset, cfg.dataset.img_dir,
                                 workers=cfg.dataloader.workers)
        logging.info("preloaded %d images", len(preload))

    def make_iter():
        return BatchIterator(
            dataset=dataset, tokenizer=tokenizer, img_dir=cfg.dataset.img_dir,
            batch_size=cfg.dataloader.batch_size,
            caption_num=cfg.dataloader.caption_num,
            image_size=cfg.keep.vision.img_size,
            max_length=cfg.keep.max_text_length, do_graph=do_graph,
            image_loader=image_loader, preload=preload, seed=cfg.seed,
            workers=cfg.dataloader.workers)

    steps_per_epoch = make_iter().num_batches
    accum = max(1, cfg.solver.accum_freq)
    # the schedule advances per optimizer step
    schedule = build_schedule(cfg, max(1, steps_per_epoch // accum))

    model = build_model(cfg, device)
    if params is not None:
        model.load_state_dict(params, strict=True)
    model.train()
    loss_cfg = LossConfig(
        kind=cfg.model.type if cfg.model.type == "hierarchy_metric" else "clip",
        caption_num=cfg.dataloader.caption_num,
        loss_subtype=cfg.model.loss_subtype)
    fs = FreezeSchedule(
        freeze_visual_epochs=cfg.solver.freeze_visual_epochs,
        freeze_text_epochs=cfg.solver.freeze_text_epochs,
        freeze_knowledge_epochs=cfg.solver.freeze_knowledge_epochs,
        # with a knowledge-BERT checkpoint the whole text tower freezes
        keep_text_head_open=not bool(cfg.model.pretrained_text))
    # ONE optimizer for the whole run: freezing enters as a mask, so the
    # moments and the schedule count run on across freeze phases
    tx = optim.AdamW(schedule, decay_mask=optim.wd_mask(model),
                     weight_decay=cfg.solver.weight_decay,
                     b1=cfg.solver.beta1, b2=cfg.solver.beta2,
                     eps=cfg.solver.eps,
                     grad_clip_norm=cfg.solver.grad_clip_norm,
                     mu_dtype=cfg.solver.mu_dtype)
    state = tree_state(model, tx)

    start_epoch = 0
    if cfg.save.resume:
        epoch_sel = None if cfg.save.resume == "latest" else int(
            cfg.save.resume)
        try:
            restored = ckpt.restore(ckpt_dir, epoch=epoch_sel)
        except FileNotFoundError:
            logging.info("resume requested but no checkpoint found; fresh "
                         "start")
        else:
            model.load_state_dict(restored["params"], strict=True)
            state.opt_state = _opt_state_to(restored["opt_state"], device)
            state.step = int(restored["step"])
            start_epoch = restored["epoch"] + 1
            logging.info("resumed from epoch %d (step %d, optimizer state "
                         "restored)", restored["epoch"], state.step)

    names = list(state.params)
    if accum > 1:
        base_step = make_accum_train_step(model, loss_cfg, tx, accum)
    phase_steps: dict = {}

    def phase_step_fn(epoch: int):
        if accum > 1:
            return base_step  # the dynamic mask alone
        key = tuple(sorted(fs.frozen_towers(epoch)))
        if key not in phase_steps:
            static = None
            if key:
                m = optim.freeze_mask(names, fs.frozen_fn(epoch))
                static = {n: f > 0.5 for n, f in m.items()}
            phase_steps[key] = make_train_step(model, loss_cfg, tx,
                                               static_frozen=static)
        return phase_steps[key]

    cur_phase = None
    frozen = None
    results = {"epoch": start_epoch - 1, "resumed": start_epoch > 0}
    if start_epoch >= cfg.solver.epochs:
        logging.info("resume epoch %d >= epochs %d: nothing to train",
                     start_epoch, cfg.solver.epochs)
    n_ins = cfg.dataloader.batch_size // cfg.dataloader.caption_num
    for epoch in range(start_epoch, cfg.solver.epochs):
        phase = fs.frozen_towers(epoch)
        if phase != cur_phase:
            frozen = optim.freeze_mask(names, fs.frozen_fn(epoch))
            step_fn = phase_step_fn(epoch)
            cur_phase = phase
            logging.info("epoch %d: frozen towers = %s", epoch,
                         sorted(phase) or "none")
        pre_snapshot = snapshot(state.params)
        dataset.resample_epoch(epoch)
        loss_meter, step_time = AverageMeter(), AverageMeter()
        pending_losses: list = []
        pending: list = []
        t0 = time.time()
        for i, batch in enumerate(Prefetcher(make_iter())):
            if accum > 1:
                pending.append(batch)
                if len(pending) < accum:
                    continue
                arrays = {k: np.stack([b[k] for b in pending])
                          for k in ("pixels", "input_ids", "attention_mask")}
                # ONE reachability matrix over every chunk's group labels
                labels = [lab for b in pending
                          for lab in b["cap_labels"][::n_ins]]
                arrays["node_connection"] = do_graph.node_connection(labels)
                pending = []
            else:
                arrays = batch
            state, metrics = step_fn(state, to_device(arrays, device), frozen)
            # losses stay on the device until the log cadence
            pending_losses.append(metrics["loss"])
            step_time.update(time.time() - t0)
            t0 = time.time()
            if i % 100 == 0:
                for v in pending_losses:
                    loss_meter.update(float(v))
                pending_losses.clear()
                logging.info("epoch %d step %d/%d loss %.4f (%.2f samples/s)",
                             epoch, i, steps_per_epoch, loss_meter.avg,
                             cfg.dataloader.batch_size * accum
                             / max(step_time.avg, 1e-9))
        for v in pending_losses:
            loss_meter.update(float(v))
        logging.info("epoch %d freeze check: %s", epoch,
                     diff_report(pre_snapshot, state.params))
        results = {"epoch": epoch, "train_loss": loss_meter.avg}
        append_results(os.path.join(ckpt_dir, "results.jsonl"), results)
        writer.write(state.step, results)
        if ((epoch + 1) % cfg.save.save_frequency == 0
                or epoch + 1 == cfg.solver.epochs):
            ckpt.save(ckpt_dir, epoch, model.state_dict(), state.opt_state,
                      step=state.step,
                      keep_previous=not cfg.save.delete_previous_checkpoint)
            logging.info("saved checkpoint epoch %d", epoch)
    writer.close()
    return results


def _opt_state_to(opt_state: dict, device) -> dict:
    return {"count": int(opt_state["count"]),
            "mu": {n: t.to(device) for n, t in opt_state["mu"].items()},
            "nu": {n: t.to(device) for n, t in opt_state["nu"].items()}}


def _copy_codebase(out_dir: str) -> None:
    import shutil

    src = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    dst = os.path.join(out_dir, "code", "keep_tpu_torch")
    if not os.path.exists(dst):
        shutil.copytree(src, dst, ignore=shutil.ignore_patterns(
            "__pycache__", "*.pyc", "build"))
    logging.info("code snapshot at %s", dst)


def main(argv: Optional[list[str]] = None):
    parser = argparse.ArgumentParser(
        description="Train KEEP (single process, one device).")
    parser.add_argument("--config", required=True,
                        help="run config, YAML or JSON")
    parser.add_argument("--resume",
                        help="override save.resume ('latest' or an epoch)")
    parser.add_argument("--experiment-name",
                        help="override save.experiment_name")
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (default: cuda)")
    args = parser.parse_args(argv)
    cfg = TrainRunConfig.from_yaml(args.config)
    if args.resume is not None:
        cfg.save.resume = args.resume
    if args.experiment_name is not None:
        cfg.save.experiment_name = args.experiment_name
    return train(cfg, device=args.device)


if __name__ == "__main__":
    main()
