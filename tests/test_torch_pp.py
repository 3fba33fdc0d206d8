"""Pipeline parallelism in the port (``keep_tpu_torch.parallel.pp``, the
trainer's pp layout) against the JAX package's ``keep_tpu.parallel.pp``
and against the port's one-process run, on the CPU over gloo (one process
per rank, ``tests/torch_dp_worker.py``); the twin of ``tests/test_pp.py``:

- ``pipeline_blocks`` over four ranks (``torch_dp_worker.py pipeline``)
  at 4 stages and at 2 stages of a dp 2 × pp 2 mesh, M 2 / 4 / 8, with and
  without remat, against the loop over all layers: the output on every
  rank, the stage's layers' and the input's gradients; its shape errors;
  one stage is the loop itself;
- ``vit_forward_pp`` (blocks whole and staged) against the JAX package's
  ``vit_forward_pp`` on its 8-device CPU mesh;
- which leaves stage (``pp_state_specs``, ``pp_fraction`` against
  ``keep_tpu.parallel.pp.pp_fraction``);
- ``train()`` at pp = 2 (world 2) and at dp 2 × pp 2 (world 4) from the
  JAX trainer's initial weights follow the one-process run as
  ``tests/test_torch_tp.py`` holds the other layouts (losses at rtol 1e-5
  / atol 1e-6, each step's gradient per leaf, the update over the run);
  pp = 2's losses also the JAX trainer's pp = 2 run's on its mesh; every
  leaf a rank holds is bit-equal to the other ranks' copies after the
  last step, and each rank holds its stage's trunk blocks only;
- the JAX trainer's refusals, in its words.
"""

import json

import jax
import numpy as np
import pytest
import torch

from keep_tpu import configs as jcfgs
from keep_tpu.models import keep as jkeep
from keep_tpu.models import vit as jvit
from keep_tpu.parallel import pp as jpp
from keep_tpu_torch import configs
from keep_tpu_torch.compat.torch_loader import from_jax_tree
from keep_tpu_torch.models.keep import KEEPModel
from keep_tpu_torch.parallel import pp
from keep_tpu_torch.train import main as tmain
from keep_tpu_torch.train import trainer
from keep_tpu_torch.train.config import TrainRunConfig
from tests.test_torch_multiprocess import _run_workers, jax_losses
from tests.test_torch_tp import (UPDATE_GATE, assert_same_run,  # noqa: F401
                                 final_params, layout_config, one_process,
                                 reference, run_cache, run_layout, start,
                                 update_errs)
from tests.test_torch_train import (CFG, JCFG, MOE_VISION,  # noqa: F401
                                    _run_config, run_dirs)

VIT = dict(img_size=32, patch_size=16, embed_dim=32, depth=8, num_heads=4)
CASES = ["4_4_plain", "4_8_plain", "2_2_plain", "2_4_plain", "4_4_remat",
         "2_2_remat"]


@pytest.fixture(scope="module")
def pipeline_run(tmp_path_factory):
    """One four-rank run of ``torch_dp_worker.py pipeline``: each rank's
    readings and ViT features, beside the JAX package's ``vit.forward`` and
    ``vit_forward_pp`` over 4 stages of its CPU mesh on the same ViT and
    pixels."""
    from jax.sharding import Mesh

    d = tmp_path_factory.mktemp("pipeline")
    cfg = jcfgs.ViTConfig(**VIT)
    params = jax.tree.map(np.asarray, jvit.init(jax.random.PRNGKey(0), cfg))
    sd = from_jax_tree({"visual": params}, lambda path: VIT["depth"])
    torch.save({k.removeprefix("visual."): v for k, v in sd.items()},
               d / "vit.pt")
    x = np.random.default_rng(0).standard_normal((8, 32, 32, 3),
                                                 dtype=np.float32)
    torch.save(torch.from_numpy(x), d / "pixels.pt")
    spec = {"vit": str(d / "vit.pt"), "pixels": str(d / "pixels.pt"),
            "vit_cfg": VIT, "out": str(d / "pipe")}
    _run_workers("pipeline", spec, d, n=4)
    mesh = Mesh(np.array(jax.devices()[:4]), ("pp",))
    return {
        "readings": [json.loads((d / f"pipe.{r}.json").read_text())
                     for r in range(4)],
        "feats": [torch.load(d / f"pipe.{r}.vit.pt", weights_only=True)
                  for r in range(4)],
        "jax_plain": np.asarray(jvit.forward(params, x, cfg)),
        "jax_pp": np.asarray(jpp.vit_forward_pp(params, x, cfg, mesh,
                                                num_microbatches=4))}


@pytest.mark.parametrize("case", CASES)
def test_pipeline_blocks_match_the_loop(pipeline_run, case):
    """``tests/test_pp.py``'s toy trunk (8 layers of tanh(h·w + b), 16
    wide, batch 8) pipelined at ``case`` (stages_microbatches_remat): the
    loop's output on every rank, the stage's layers' gradients (summed
    over dp under dp 2 × pp 2) and the input's, at the JAX tests'
    tolerances."""
    for r, rd in enumerate(pipeline_run["readings"]):
        got = rd[case]
        assert got["out"] <= 1e-6, (r, got)
        assert got["grad_params"] <= 1e-5, (r, got)
        assert got["grad_input"] <= 1e-5, (r, got)


def test_pipeline_shape_errors(pipeline_run):
    """6 layers over 4 stages and a batch of 3 over 4 microbatches raise
    the JAX package's ValueErrors."""
    for rd in pipeline_run["readings"]:
        assert rd["shape_errors"] == [
            "depth 6 not divisible by 4 'pp' stages",
            "batch 3 not divisible by 4 microbatches"]


def test_pipeline_single_stage_is_the_loop(pipeline_run):
    for rd in pipeline_run["readings"]:
        assert rd["one_stage_equal"] is True


@pytest.mark.parametrize("kind", ["whole", "staged"])
def test_vit_forward_pp_matches_jax(pipeline_run, kind):
    """The ViT (depth 8 over 4 stages, two blocks a stage) pipelined with
    its blocks whole on every rank, and staged (each rank holding its own
    two): every rank's features equal the JAX package's ``vit_forward_pp``
    on its mesh and its plain ``vit.forward`` at ``test_pp.py``'s 1e-5."""
    for feats in pipeline_run["feats"]:
        got = feats[kind].numpy()
        np.testing.assert_allclose(got, pipeline_run["jax_pp"], atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(got, pipeline_run["jax_plain"],
                                   atol=1e-5, rtol=1e-5)


def test_pp_state_specs_stage_the_visual_trunk():
    """The visual blocks stage along the layer order, everything else
    replicates (``test_pp_state_shardings_matcher``); a depth that does
    not divide stages nothing; a moment dict mirrors the names."""
    model = KEEPModel(CFG, device="meta")
    names = [k for k, _ in model.named_parameters()]
    specs = pp.pp_state_specs(names, CFG.vision.depth, 2)
    assert specs["visual.blocks.0.attn.qkv.weight"] == 0
    assert specs["visual.blocks.1.mlp.fc2.bias"] == 1
    assert specs["text.blocks.1.attn.qkv.weight"] is None
    assert specs["visual.pos_embed"] is None
    assert specs["logit_scale"] is None
    assert all(v is None for v in pp.pp_state_specs(names, 2, 4).values())
    assert pp.stage_of(5, 8, 4) == 2


@pytest.mark.parametrize("which,n", [("tiny", 2), ("tiny", 4), ("full", 2),
                                     ("full", 4)])
def test_pp_fraction_matches_jax(which, n):
    """The same parameter elements stage in both packages: the tests'
    tiny KEEP (2 blocks: all staged at pp = 2, none at 4) and ViT-L/16 +
    BERT-base."""
    from jax.sharding import Mesh

    jcfg, cfg = ((jcfgs.KEEPConfig(), configs.KEEPConfig()) if which ==
                 "full" else (JCFG, CFG))
    jshapes = jax.eval_shape(lambda k: jkeep.init(k, jcfg),
                             jax.random.PRNGKey(0))
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(8 // n, n),
                ("dp", "pp"))
    got = pp.pp_fraction(KEEPModel(cfg, device="meta"), n)
    assert got == pytest.approx(jpp.pp_fraction(jshapes, mesh), rel=1e-12)
    assert (got > 0) == (cfg.vision.depth % n == 0)


def test_staged_block_raises():
    """A block held by another stage refuses to run: the staged trunk goes
    through the pipeline (``encode_image_pp``)."""
    with pytest.raises(RuntimeError, match="held by pp stage 1"):
        pp.HeldElsewhere(3, 1)(torch.zeros(1))


def test_pp_refuses_the_moe_trunk():
    """``encode_image_pp`` and the trainer's pp branch raise for the MoE
    trunk, as the JAX package's do."""
    model = KEEPModel(configs.KEEPConfig(
        vision=configs.ViTConfig(**MOE_VISION), text=CFG.text,
        projection_dim=32, max_text_length=16), device="cpu")
    with pytest.raises(NotImplementedError, match="MoE trunk"):
        model.encode_image_pp(torch.zeros(2, 16, 16, 3))
    with pytest.raises(NotImplementedError, match="MoE trunk"):
        trainer._encode_batch(model, {"pixels": torch.zeros(2, 16, 16, 3)},
                              pp_mesh=object())


def _assert_pieces(ranks_final: list, stages: list, depth: int, n: int):
    """Every leaf a rank holds is bit-equal to the other ranks' copies of
    it; each rank holds its own stage's trunk blocks only."""
    seen: dict = {}
    for r, (final, stage) in enumerate(zip(ranks_final, stages)):
        blocks = {int(k.split(".")[2]) for k in final
                  if k.startswith("visual.blocks.")}
        assert blocks == {j for j in range(depth)
                          if pp.stage_of(j, depth, n) == stage}, (r, blocks)
        for k, v in final.items():
            if k in seen:
                assert torch.equal(v, seen[k]), (r, k)
            seen[k] = v


def _finals(tmp_path, name: str, n: int) -> list:
    return [torch.load(tmp_path / f"{name}_out.{r}.final.pt",
                       weights_only=True) for r in range(n)]


def test_pp2_follows_one_process(run_dirs, tmp_path, start, reference,
                                 run_cache):
    """solver.pp = 2 at world 2 (dp 1 × pp 2): the visual trunk's blocks
    one a stage, two microbatches of 4, the one-process trajectory; the
    losses also the JAX trainer's at pp = 2 on its 8-device mesh (dp 4 ×
    pp 2) within ``test_train_main.py``'s rtol 1e-5 / atol 1e-6."""
    raw = layout_config(run_dirs, tmp_path / "pp", pp=2)
    ranks = run_layout(raw, tmp_path, "pp", 2, start[0])
    assert_same_run(ranks, raw, layout_config(run_dirs, tmp_path / "probe"),
                    reference)
    _assert_pieces(_finals(tmp_path, "pp", 2), [0, 1], CFG.vision.depth, 2)
    want = jax_losses(layout_config(run_dirs, tmp_path / "jax", pp=2),
                      run_cache)
    np.testing.assert_allclose(ranks[0]["losses"], want, rtol=1e-5,
                               atol=1e-6)


def test_dp2_pp2_follows_one_process(run_dirs, tmp_path, start, reference):
    """solver.pp = 2 at world 4 (dp 2 × pp 2): each dp index pipelines its
    own 4 rows; the one-process trajectory."""
    raw = layout_config(run_dirs, tmp_path / "dpp", pp=2)
    ranks = run_layout(raw, tmp_path, "dpp", 4, start[0])
    assert_same_run(ranks, raw, layout_config(run_dirs, tmp_path / "probe"),
                    reference)
    _assert_pieces(_finals(tmp_path, "dpp", 4), [0, 1, 0, 1],
                   CFG.vision.depth, 2)


def test_one_process_checkpoint_resumes_under_pp(run_dirs, tmp_path, start,
                                                  reference):
    """A one-process run's checkpoint (epoch 0) resumes at pp = 2 (world 2):
    each rank takes its stage's leaves and moments of the one-process
    leaves (``ParallelLayout.load``) and trains epoch 1 onto the
    one-process trajectory."""
    one = layout_config(run_dirs, tmp_path / "resume", epochs=1)
    one_process(one, start[1])
    raw = layout_config(run_dirs, tmp_path / "resume", pp=2)
    raw["save"]["resume"] = "latest"
    ranks = run_layout(raw, tmp_path, "resume", 2, start[0])
    for r in ranks:
        np.testing.assert_allclose(r["losses"], reference.losses[1:],
                                   rtol=1e-5, atol=1e-6)
    errs = update_errs(final_params(raw), reference)
    bad = {k: e for k, e in errs.items() if not e <= UPDATE_GATE}
    assert not bad, bad


@pytest.mark.parametrize("solver,world,batch,match", [
    ({"tp": 2, "pp": 2}, 8, 8, "solver.tp and solver.pp are mutually "
                               "exclusive"),
    ({"pp": 2, "fsdp": True}, 8, 8, "solver.pp and solver.fsdp are mutually "
                                    "exclusive"),
    ({"pp": 2, "accum_freq": 2}, 8, 8, "solver.pp does not compose with "
                                       "accum_freq > 1"),
    ({"pp": 2, "moe": True}, 8, 8, "the MoE trunk trains with dp/fsdp/ep"),
    ({"pp": 2, "lora_rank": 2}, 8, 8, "composes with dp only"),
    ({"pp": 3}, 8, 8, "solver.pp=3 does not divide 8 devices"),
    ({"pp": 2}, 1, 8, "solver.pp=2 does not divide 1 devices"),
    ({"pp": 2}, 8, 6, r"batch_size 6 not divisible by dp=4 \(devices 8 / "
                      r"pp=2\)"),
    ({"pp": 2}, 4, 6, "solver.pp=2: batch_size 6 must split into pp "
                      "microbatches each divisible by dp=2"),
])
def test_pp_config_errors_as_jax(run_dirs, tmp_path, solver, world, batch,
                                 match):
    """The JAX trainer's pp errors (``keep_tpu/train/main.py``), in its
    words, before anything runs."""
    raw = _run_config(run_dirs, tmp_path)
    solver = dict(solver)
    if solver.pop("moe", False):
        raw["keep"]["vision"]["moe_experts"] = 4
    raw["solver"].update(solver)
    raw["dataloader"].update(batch_size=batch, caption_num=2)
    with pytest.raises(ValueError, match=match):
        tmain.check_supported(TrainRunConfig.from_dict(raw), world)


@pytest.mark.parametrize("world,batch", [(2, 8), (4, 8), (8, 16)])
def test_pp_layouts_accepted(run_dirs, tmp_path, world, batch):
    """pp = 2 passes the checks wherever the JAX trainer builds its
    (dp, pp) mesh."""
    raw = _run_config(run_dirs, tmp_path, pp=2)
    raw["dataloader"]["batch_size"] = batch
    tmain.check_supported(TrainRunConfig.from_dict(raw), world)
