"""Sequence parallelism in the port (``keep_tpu_torch.parallel.sp``,
Megatron-SP over the tensor-parallel group) against the port's one-process
run, on the CPU over gloo (one process per rank,
``tests/torch_dp_worker.py``): ``train()`` at tp = 2 with ``solver.sp``
(world 2) follows the one-process trajectory, as
``tests/test_torch_tp.py`` holds it. The tiny ViT's stream is 5 tokens
(CLS and 4 patches), which mp = 2 does not divide: it is padded to 6 and
trimmed back before each attention. The JAX package's refusals: sp without
tp, sp with accumulation, sp on the MoE trunk.
"""

import pytest
import torch

from keep_tpu_torch import configs
from keep_tpu_torch.models.keep import KEEPModel
from keep_tpu_torch.parallel import mesh as pmesh
from keep_tpu_torch.parallel.sp import SeqParallel, seq_sharding
from keep_tpu_torch.train import trainer
from tests.test_torch_tp import (assert_same_run, layout_config,  # noqa: F401
                                 reference, run_cache, run_layout, start)
from tests.test_torch_train import MOE_VISION, TEXT, run_dirs  # noqa: F401


def test_tp2_sp_follows_one_process(run_dirs, tmp_path, start, reference):
    """solver.tp = 2 + solver.sp at world 2: the streams split along S
    between the blocks (ViT's 5 tokens padded to 6), the one-process
    trajectory."""
    raw = layout_config(run_dirs, tmp_path / "sp", tp=2, sp=True)
    ranks = run_layout(raw, tmp_path, "sp", 2, start[0])
    assert_same_run(ranks, raw, layout_config(run_dirs, tmp_path / "probe"),
                    reference)


@pytest.mark.parametrize("s,n,sp", [(197, 2, 198), (5, 2, 6), (16, 2, 16),
                                    (257, 4, 260), (1, 2, 2)])
def test_padded_length(s, n, sp):
    """The stream pads to the least multiple of mp at or past S."""
    shard = SeqParallel(None, n, 0).shard(s)
    assert (shard.s, shard.sp, shard.n) == (s, sp, n)


def test_sp_refused_on_the_moe_trunk():
    """The MoE trunk refuses a sequence split before any collective, as
    the JAX package refuses sp on it."""
    cfg = configs.KEEPConfig(
        vision=configs.ViTConfig(**MOE_VISION),
        text=configs.BertConfig(**TEXT), projection_dim=32,
        max_text_length=16)
    model = KEEPModel.init(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    with pytest.raises(ValueError, match="not composed with the MoE trunk"):
        model.encode_image(torch.zeros(2, 16, 16, 3),
                           act_sharding=SeqParallel(None, 2, 0))


def test_sp_refused_with_accumulation():
    """``make_accum_train_step`` refuses a layout with a sequence split,
    as the JAX trainer refuses sp with accum_freq > 1."""
    mesh = pmesh.ProcessMesh(("dp", "mp"), (1, 2), (0, 0), (None, None))
    layout = trainer.ParallelLayout(mesh, {}, {}, seq_sharding(mesh))
    with pytest.raises(ValueError, match="accum_freq > 1"):
        trainer.make_accum_train_step(None, trainer.LossConfig(), None, 2,
                                      layout=layout)
