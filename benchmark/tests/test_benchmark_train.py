"""The training cell's check at a small size on the CPU: the reference
follows the program's step exactly where both compute in fp32, and a run
with the step broken underneath is not correct."""

import dataclasses

import pytest
import torch

import smallcell
from benchmark.drivers import train


def small_train(seed=7, seconds=0.5):
    _, cell = smallcell.small_cell("keep-bf16.train", seed=seed,
                                   seconds=seconds)
    cell.traffic.update(batch_size=16, caption_num=4, image_size=64,
                        pool_batches=4, hierarchy_nodes=16,
                        caption_tokens=[8, 32])
    cell.config["model"]["vision"]["img_size"] = 64
    return cell


def test_reference_follows_the_program_in_fp32(monkeypatch):
    from keep_tpu_torch.models import keep

    real = keep.KEEPModel.__init__

    def fp32(self, cfg, **kw):
        real(self, cfg, **dict(kw, dtype=torch.float32))

    monkeypatch.setattr(keep.KEEPModel, "__init__", fp32)
    cell = small_train()
    _, state, step = train.build(cell)
    batches = train.make_batches(cell.traffic, cell.config["model"],
                                 cell.seed, "cpu")
    got, _ = train.checked_steps(cell, state, step, batches)
    gaps = train.compare(got, train.reference_readings(cell, batches))
    assert gaps["loss_gap"] < 1e-5
    assert gaps["grad_gap"] < 1e-4
    assert gaps["change_gap"] < 1e-3


def _unchanged(monkeypatch):
    from keep_tpu_torch.train import trainer

    def apply(state, grads, tx, frozen, loss, layout=None, model=None):
        return state, {"loss": loss}

    monkeypatch.setattr(trainer, "_optimizer_apply", apply)


def _half_batch(monkeypatch):
    from keep_tpu_torch.train import trainer

    real = trainer.compute_loss

    def half(model, batch, loss_cfg, **kw):
        rows, groups = batch["pixels"].shape[0] // 2, loss_cfg.caption_num // 2
        cut = {k: v[:groups, :groups] if k == "node_connection" else v[:rows]
               for k, v in batch.items()}
        return real(model, cut, dataclasses.replace(loss_cfg,
                                                    caption_num=groups), **kw)

    monkeypatch.setattr(trainer, "compute_loss", half)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch])
def test_broken_step_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    out = smallcell.run(small_train(seed=8))
    assert not out.correct, out.checks


def test_sound_step_reads_below_the_faults():
    out = smallcell.run(small_train(seed=8))
    assert out.work["steps"] > 0
    assert all(c["value"] < 0.1 for c in out.checks), out.checks
