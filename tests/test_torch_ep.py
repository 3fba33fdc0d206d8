"""Expert parallelism in the port (``keep_tpu_torch.models.moe``'s
``ep_specs`` / ``shard_experts_``, the trainer's ep layout) against the
JAX package's ``ep_shardings`` and against the port's one-process run, on
the CPU over gloo (one process per rank, ``tests/torch_dp_worker.py``):

- which leaves split over 'ep' (the expert axis of ``wi`` / ``wo``,
  kernels and biases) equals ``keep_tpu.models.moe.ep_shardings`` on the
  same MoE KEEP, a non-dividing expert count replicated;
- ``train()`` of the MoE KEEP (2 experts, the grouped einsum dispatch) at
  ep = 2 (world 2) and at dp 2 × ep 2 (world 4), from the JAX trainer's
  initial weights, follows the one-process run as ``tests/test_torch_tp.py``
  holds the other layouts; ep = 2's losses also the JAX trainer's
  ``solver.ep=2`` run's on its mesh (``test_train_moe_ep_equivalence``);
  every leaf a rank holds is bit-equal to the other ranks' copies after
  the last step, and each rank holds its own expert of each block;
- the JAX trainer's refusals, in its words, and the gather dispatch's
  under an ep split.
"""

import jax
import numpy as np
import pytest
import torch

from keep_tpu import configs as jcfgs
from keep_tpu.models import keep as jkeep
from keep_tpu.models import moe as jmoe
from keep_tpu_torch import configs
from keep_tpu_torch.models import moe
from keep_tpu_torch.models.keep import KEEPModel
from keep_tpu_torch.parallel import tp as ptp
from keep_tpu_torch.train import main as tmain
from keep_tpu_torch.train.config import TrainRunConfig
from tests.test_torch_multiprocess import _portable, cached, jax_losses
from tests.test_torch_tp import (UPDATE_GATE, Run,  # noqa: F401
                                 assert_same_run, final_params, jax_start,
                                 layout_config, one_process, run_cache,
                                 run_layout, update_errs)
from tests.test_torch_train import (CFG_MOE, MOE_VISION, TEXT,  # noqa: F401
                                    _run_config, run_dirs)


def moe_config(run_dirs, out_dir, epochs: int = 2, **solver) -> dict:
    """The layout config on the MoE KEEP with the grouped dispatch."""
    raw = layout_config(run_dirs, out_dir, epochs=epochs, **solver)
    raw["keep"]["vision"] = dict(MOE_VISION, moe_dispatch="einsum")
    return raw


@pytest.fixture(scope="module")
def moe_start(run_dirs, tmp_path_factory, run_cache) -> tuple[str, dict]:
    """The JAX trainer's initial MoE parameters as the port's state dict,
    and the file they are saved in."""
    raw = moe_config(run_dirs, tmp_path_factory.mktemp("moe_start"))
    params = cached(run_cache, "start", _portable(raw),
                    lambda: jax_start(raw, CFG_MOE))
    path = str(tmp_path_factory.mktemp("moe_start") / "params.pt")
    torch.save(params, path)
    return path, params


@pytest.fixture(scope="module")
def moe_reference(run_dirs, tmp_path_factory, moe_start, run_cache) -> Run:
    raw = moe_config(run_dirs, tmp_path_factory.mktemp("moe_one"))
    return Run(*cached(run_cache, "one_process", _portable(raw),
                       lambda: tuple(one_process(raw, moe_start[1]))))


def _moe_cfgs(experts: int):
    vision = dict(MOE_VISION, moe_experts=experts)
    return (jcfgs.KEEPConfig(vision=jcfgs.ViTConfig(**vision),
                             text=jcfgs.BertConfig(**TEXT),
                             projection_dim=32, max_text_length=16),
            configs.KEEPConfig(vision=configs.ViTConfig(**vision),
                               text=configs.BertConfig(**TEXT),
                               projection_dim=32, max_text_length=16))


@pytest.mark.parametrize("experts,n_ep", [(4, 2), (4, 4), (2, 2), (4, 8)])
def test_ep_specs_match_jax(experts, n_ep):
    """The leaves that split over 'ep' are the JAX layout's, by element
    count (the expert stacks' kernels and biases; 4 experts over 8 ranks
    split nothing); the expert axis is 0 of the port's [E, out, in] weight
    and [E, out] bias."""
    from jax.sharding import Mesh

    jcfg, cfg = _moe_cfgs(experts)
    jshapes = jax.eval_shape(lambda k: jkeep.init(k, jcfg),
                             jax.random.PRNGKey(0))
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(8 // n_ep, n_ep),
                ("dp", "ep"))
    jspecs = jmoe.ep_shardings(jshapes, mesh)
    want = sum(int(np.prod(x.shape)) for x, sh in zip(
        jax.tree.leaves(jshapes), jax.tree.leaves(jspecs))
        if any(a is not None for a in sh.spec))
    model = KEEPModel(cfg, device="meta")
    specs = moe.ep_specs(model, n_ep)
    got = sum(p.numel() for k, p in model.named_parameters() if specs[k])
    assert got == want
    assert (got > 0) == (experts % n_ep == 0)
    if got:
        assert specs["visual.blocks.0.moe.wi.weight"] == ptp.Split(0)
        assert specs["visual.blocks.1.moe.wo.bias"] == ptp.Split(0)
    assert specs["visual.blocks.0.moe.router.weight"] is None
    assert specs["visual.blocks.0.attn.qkv.weight"] is None


def _assert_experts(finals: list, ranks_ep: list, experts: int, n: int):
    """Every leaf a rank holds is bit-equal to the other ranks' copies of
    it (its dp peers' for an expert, every rank's for a replicated leaf);
    each rank's expert leaves hold E/ep experts."""
    seen: dict = {}
    for r, (final, ep_rank) in enumerate(zip(finals, ranks_ep)):
        for k, v in final.items():
            key = (k, ep_rank) if ".moe.w" in k else k
            if ".moe.w" in k:
                assert v.shape[0] == experts // n, (r, k, v.shape)
            if key in seen:
                assert torch.equal(v, seen[key]), (r, k)
            seen[key] = v


def _finals(tmp_path, name: str, n: int) -> list:
    return [torch.load(tmp_path / f"{name}_out.{r}.final.pt",
                       weights_only=True) for r in range(n)]


def test_ep2_follows_one_process(run_dirs, tmp_path, moe_start,
                                 moe_reference, run_cache):
    """solver.ep = 2 at world 2 (dp 1 × ep 2): one expert of two a rank,
    both ranks on the same rows, the experts' output gathered over ep; the
    one-process trajectory; the losses also the JAX trainer's ep = 2 run's
    on its 8-device mesh (dp 4 × ep 2) at ``test_train_main.py``'s rtol
    1e-5 / atol 1e-6."""
    raw = moe_config(run_dirs, tmp_path / "ep", ep=2)
    ranks = run_layout(raw, tmp_path, "ep", 2, moe_start[0])
    assert_same_run(ranks, raw, moe_config(run_dirs, tmp_path / "probe"),
                    moe_reference)
    _assert_experts(_finals(tmp_path, "ep", 2), [0, 1], 2, 2)
    want = jax_losses(moe_config(run_dirs, tmp_path / "jax", ep=2),
                      run_cache)
    np.testing.assert_allclose(ranks[0]["losses"], want, rtol=1e-5,
                               atol=1e-6)


def test_dp2_ep2_follows_one_process(run_dirs, tmp_path, moe_start,
                                     moe_reference):
    """solver.ep = 2 at world 4 (dp 2 × ep 2): the routing's statistics
    over dp, the experts over ep; the one-process trajectory."""
    raw = moe_config(run_dirs, tmp_path / "dep", ep=2)
    ranks = run_layout(raw, tmp_path, "dep", 4, moe_start[0])
    assert_same_run(ranks, raw, moe_config(run_dirs, tmp_path / "probe"),
                    moe_reference)
    _assert_experts(_finals(tmp_path, "dep", 4), [0, 1, 0, 1], 2, 2)


def test_one_process_checkpoint_resumes_under_ep(run_dirs, tmp_path,
                                                  moe_start, moe_reference):
    """A one-process MoE run's checkpoint (epoch 0) resumes at ep = 2
    (world 2): each rank takes its experts of the one-process leaves and
    moments (``ParallelLayout.load``) and trains epoch 1 onto the
    one-process trajectory."""
    one = moe_config(run_dirs, tmp_path / "resume", epochs=1)
    one_process(one, moe_start[1])
    raw = moe_config(run_dirs, tmp_path / "resume", ep=2)
    raw["save"]["resume"] = "latest"
    ranks = run_layout(raw, tmp_path, "resume", 2, moe_start[0])
    for r in ranks:
        np.testing.assert_allclose(r["losses"], moe_reference.losses[1:],
                                   rtol=1e-5, atol=1e-6)
    errs = update_errs(final_params(raw), moe_reference)
    bad = {k: e for k, e in errs.items() if not e <= UPDATE_GATE}
    assert not bad, bad


@pytest.mark.parametrize("solver,vision,world,match", [
    ({"ep": 2}, None, 8, "solver.ep requires model.vision.moe_experts > 0"),
    ({"ep": 2, "tp": 2}, {}, 8, r"solver.ep composes with dp only \(not "
                                r"solver.tp / solver.pp\)"),
    ({"ep": 2, "pp": 2}, {}, 8, "solver.ep composes with dp only"),
    ({"ep": 2}, {"moe_dispatch": "gather"}, 8,
     "solver.ep requires vision.moe_dispatch='einsum'"),
    ({"ep": 2, "fsdp": True}, {}, 8, "solver.ep and solver.fsdp are "
                                     "mutually exclusive"),
    ({"ep": 2, "lora_rank": 2}, {}, 8, "composes with dp only"),
    ({"ep": 3}, {}, 8, "solver.ep=3 does not divide 8 devices"),
    ({"ep": 2}, {}, 8, r"batch_size 6 not divisible by dp=4 \(devices 8 / "
                       r"ep=2\)"),
])
def test_ep_config_errors_as_jax(run_dirs, tmp_path, solver, vision, world,
                                 match):
    """The JAX trainer's ep errors (``keep_tpu/train/main.py``), in its
    words, before anything runs."""
    raw = _run_config(run_dirs, tmp_path)
    if vision is not None:
        raw["keep"]["vision"] = dict(MOE_VISION, **vision)
    raw["solver"].update(solver)
    raw["dataloader"].update(batch_size=6, caption_num=2)
    with pytest.raises(ValueError, match=match):
        tmain.check_supported(TrainRunConfig.from_dict(raw), world)


def test_gather_dispatch_refused_under_ep():
    """An MoE MLP whose experts split over ep refuses the gather dispatch
    (the grouped dispatch is the ep form)."""
    mlp = moe.MoEMLP(8, 16, 2)
    mlp.ep = moe.ExpertParallel(None, 2, 0)
    with pytest.raises(ValueError, match="moe_dispatch='einsum'"):
        moe.moe_mlp_gather(mlp, torch.zeros(4, 8))
