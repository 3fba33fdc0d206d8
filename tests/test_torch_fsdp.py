"""FSDP in the port (``keep_tpu_torch.parallel.fsdp``, the trainer's
``ParallelLayout``) against the JAX package's ``keep_tpu.parallel.fsdp``
and against the port's one-process run, on the CPU over gloo (one process
per rank, ``tests/torch_dp_worker.py``):

- the specs: which leaves shard, as a fraction of the parameter elements,
  equals the JAX package's on the same KEEP (its stacked [L, ...] leaves
  against the port's per-block ones: the threshold on L × the leaf's
  size), the full-width KEEP and the tests' tiny one; the tp × fsdp
  composition of ``test_tp_fsdp_spec_composition``;
- the trajectories: ``train()`` with ``solver.fsdp`` at world 2, the dense
  KEEP and the MoE trunk, follow the one-process run (losses at rtol 1e-5
  / atol 1e-6, each step's gradient and the final parameters per leaf, as
  ``tests/test_torch_tp.py`` holds them); each rank keeps only its shards
  of the state.
"""

import jax
import numpy as np
import pytest
import torch

from keep_tpu import configs as jcfgs
from keep_tpu.models import keep as jkeep
from keep_tpu.parallel import fsdp as jfsdp
from keep_tpu_torch import configs
from keep_tpu_torch.models.keep import KEEPModel
from keep_tpu_torch.parallel import fsdp
from tests.test_torch_multiprocess import jax_losses
from tests.test_torch_tp import (assert_same_run,  # noqa: F401
                                 layout_config, one_process, reference,
                                 run_cache, run_layout, start)
from tests.test_torch_train import (CFG, JCFG, MOE_VISION,  # noqa: F401
                                    run_dirs)


def _shapes(cfg) -> dict:
    """The port's parameter shapes of a KEEP (on the meta device)."""
    m = KEEPModel(cfg, device="meta")
    return {n: tuple(p.shape) for n, p in m.named_parameters()}


def _jax_mesh(n: int):
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:n]), ("dp",))


@pytest.mark.parametrize("which,min_size", [("full", 1 << 16),
                                            ("tiny", 256)])
def test_sharded_fraction_matches_jax(which, min_size):
    """The same parameter elements shard in both packages (the fraction
    and the total agree): ViT-L/16 + BERT-base at the default 65,536 (the
    qkv bias shards in both: 24 × 3072), and the tests' tiny KEEP at
    256."""
    jcfg, cfg = ((jcfgs.KEEPConfig(), configs.KEEPConfig())
                 if which == "full" else (JCFG, CFG))
    shapes = _shapes(cfg)
    jshapes = jax.eval_shape(lambda k: jkeep.init(k, jcfg),
                             jax.random.PRNGKey(0))
    for n in (2, 4):
        got = fsdp.sharded_fraction(shapes, n, min_size)
        want = jfsdp.sharded_fraction(jshapes, _jax_mesh(n), min_size)
        assert got == pytest.approx(want, rel=1e-12), (n, got, want)
        assert 0 < got < 1
    total = sum(int(np.prod(s)) for s in shapes.values())
    jtotal = sum(int(np.prod(np.shape(x)))
                 for x in jax.tree.leaves(jshapes))
    assert total == jtotal
    specs = fsdp.state_shardings(shapes, 2, min_size)
    if which == "full":
        assert specs["visual.blocks.0.attn.qkv.bias"] == ("dp",)
        assert jfsdp.fsdp_spec((24, 3072), 2) != jax.sharding.PartitionSpec()
        assert specs["visual.blocks.0.norm1.weight"] == (None,)
        assert specs["logit_scale"] == ()


def test_tp_fsdp_spec_composition():
    """``test_tp_fsdp_spec_composition``'s leaves in the port's layout
    (torch [out, in] kernels, one leaf per block of 24): a qkv leaf gets
    'mp' on its output axis and 'dp' on its input axis, proj the reverse;
    a LayerNorm gain and a plain leaf shard over 'dp' alone. The qkv bias
    is the documented difference: JAX shards it on the layer axis, which a
    per-block leaf does not have."""
    spec = fsdp.fsdp_spec
    assert spec((128, 64), 4, 1024, base=("mp", None), stack=24) == (
        "mp", "dp")
    assert spec((64, 128), 4, 1024, base=(None, "mp"), stack=24) == (
        "dp", "mp")
    assert spec((128,), 4, 1024, base=("mp",), stack=24) == ("mp",)
    assert spec((64,), 4, 1024, stack=24) == ("dp",)
    assert spec((256, 64), 4, 1024) == ("dp", None)
    assert spec((1, 197, 64), 4, 1024) == (None, None, "dp")
    assert fsdp.stack_sizes(["a.blocks.0.w", "a.blocks.1.w", "b"]) == {
        "a.blocks.0.w": 2, "a.blocks.1.w": 2, "b": 1}


def test_shards_gather_back():
    """A leaf's shards join back along their axis; ``place_state`` keeps a
    small leaf whole."""
    t = torch.arange(24.0).view(4, 6)
    assert torch.equal(torch.cat([fsdp.shard_of(t, 1, 2, r)
                                  for r in range(2)], dim=1), t)
    placed = fsdp.place_state({"big": t, "small": torch.ones(3)}, 2, 1,
                              min_size=8)
    assert placed["big"].shape == (4, 3) and placed["small"].shape == (3,)


def test_fsdp_follows_one_process(run_dirs, tmp_path, start, reference,
                                  run_cache):
    """solver.fsdp at world 2 (the JAX test's min size 256): the
    one-process trajectory, and the state each rank keeps is its shard of
    every large leaf (the ranks' records); the losses also the JAX
    trainer's with fsdp on its 8-device mesh within
    ``test_train_matches_jax``'s rtol 1e-5."""
    raw = layout_config(run_dirs, tmp_path / "fsdp", fsdp=True,
                        fsdp_min_size=256)
    ranks = run_layout(raw, tmp_path, "fsdp", 2, start[0])
    assert_same_run(ranks, raw, layout_config(run_dirs, tmp_path / "probe"),
                    reference)
    want = jax_losses(layout_config(run_dirs, tmp_path / "jax", fsdp=True,
                                    fsdp_min_size=256), run_cache)
    np.testing.assert_allclose(ranks[0]["losses"], want, rtol=1e-5)


def test_fsdp_moe_trunk_follows_one_process(run_dirs, tmp_path):
    """fsdp composes with the MoE trunk (the expert stacks shard): the
    one-process trajectory of the same MoE run."""
    def moe(name, **solver):
        raw = layout_config(run_dirs, tmp_path / name, **solver)
        raw["keep"]["vision"] = dict(MOE_VISION, moe_dispatch="einsum")
        return raw

    want = one_process(moe("one"))
    raw = moe("fsdp", fsdp=True, fsdp_min_size=256)
    ranks = run_layout(raw, tmp_path, "fsdp", 2)
    assert_same_run(ranks, raw, moe("probe"), want)
