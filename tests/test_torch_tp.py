"""Tensor parallelism in the port (``keep_tpu_torch.parallel.tp``, the
trainer's ``ParallelLayout``) against the JAX package's and against the
port's one-process run, on the CPU over gloo (one process per rank,
``tests/torch_dp_worker.py``):

- the split: which leaves split over mp, as a fraction of the parameter
  elements, equals ``keep_tpu.parallel.tp.tp_fraction`` on the same KEEP;
  a qkv rank piece holds the q, k and v rows of its heads;
- the trajectories: ``train()`` at tp = 2 (world 2) and at tp = 2 with
  fsdp (world 4: dp 2 × mp 2), from the JAX trainer's initial weights,
  follow the one-process run over 2 epochs: every step's loss at the JAX
  tests' rtol 1e-5 / atol 1e-6, each step's gradient at the same
  parameters per leaf (``LEAF_GATE``), each leaf's update over the run
  (the checkpoint's one-process leaves less the first) within
  ``UPDATE_GATE`` of the one-process update; tp = 2's losses also follow
  the JAX trainer's tp = 2 run on its 8-device mesh;
- a checkpoint written by a tp run resumes in one process, on the
  one-process trajectory;
- the JAX trainer's config errors, in its words (``check_supported``).

Each run is a few seconds at these sizes; the file stays under a minute on
one worker. What the layout files share (the JAX initial weights, the
one-process run, the JAX mesh losses) is computed once per pytest run
(``tests/test_torch_multiprocess.cached``), whichever xdist worker asks
first.
"""

import copy
import dataclasses
import json
import math
import os
from typing import NamedTuple

import jax
import numpy as np
import pytest
import torch

from keep_tpu.parallel.tp import tp_fraction as jtp_fraction
from keep_tpu.train import main as jmain
from keep_tpu.train.config import TrainRunConfig as JRunConfig
from keep_tpu_torch.compat.torch_loader import from_jax_params, to_jax_params
from keep_tpu_torch.models.keep import KEEPModel
from keep_tpu_torch.parallel import tp as ptp
from keep_tpu_torch.train import checkpoint as ckpt
from keep_tpu_torch.train import main as tmain
from keep_tpu_torch.train.config import TrainRunConfig
from tests.test_torch_multiprocess import (_portable, _run_workers, cache_dir,
                                           cached, jax_losses, probe_grads)
from tests.test_torch_train import CFG, _run_config, run_dirs  # noqa: F401
from tests.torch_dp_worker import record_grads, record_losses

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
# a step's gradient leaf (at the same parameters) from one process's, as a
# share of the leaf's largest value (test_gradient_noise_floor)
LEAF_GATE = 2e-2
# a leaf's update over the run (final − initial) from one process's,
# ‖Δgot − Δwant‖ / ‖Δwant‖: the layouts read up to 5.4e-3 here (tp's
# gradients carry this toy's noise floor), a leaf left as it started 1.0,
# one rank's shard of it ~0.7 (test_update_gate_sees_planted_faults)
UPDATE_GATE = 5e-2


def layout_config(run_dirs, out_dir, epochs: int = 2, **solver) -> dict:
    """The run config the layout tests share: both towers train from the
    first step."""
    return _run_config(run_dirs, out_dir, epochs=epochs,
                       freeze_visual_epochs=0, **solver)


def final_params(raw: dict) -> dict:
    """The last checkpoint's parameters of a run (one-process leaves)."""
    d = os.path.join(raw["save"]["output_dir"], "exp", "checkpoints")
    return ckpt.restore(d, epoch=ckpt.latest_epoch(d))["params"]


class Run(NamedTuple):
    """A run as the layouts are held to it: every step's loss, the final
    parameters and the initial ones (one-process leaves)."""

    losses: list
    params: dict
    init: dict


def one_process(raw: dict, params: dict | None = None) -> Run:
    """The one-process run of ``raw`` (from ``params`` if given)."""
    losses: list = []
    steps: list = []
    with record_losses(tmain, losses), record_grads(steps):
        tmain.train(TrainRunConfig.from_dict(raw), device="cpu",
                    params=params)
    return Run(losses, final_params(raw), steps[0]["params"])


def run_layout(raw: dict, tmp_path, name: str, n: int,
               params: str | None = None) -> list[dict]:
    """Runs ``raw`` in ``n`` ranks (from the state dict saved at
    ``params`` if given); returns each rank's record (losses) with its
    steps' one-process parameters and gradients (``steps``)."""
    spec = {"config": raw, "out": str(tmp_path / f"{name}_out"),
            "params": params}
    _run_workers("train", spec, tmp_path, n=n)
    out = []
    for r in range(n):
        rec = json.loads((tmp_path / f"{name}_out.{r}.json").read_text())
        rec["steps"] = torch.load(tmp_path / f"{name}_out.{r}.grads.pt",
                                  weights_only=True)
        out.append(rec)
    return out


def _leaf_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got − want| over the leaf's largest |want|."""
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def update_errs(got: dict, want: Run) -> dict:
    """Each leaf's update over the run against ``want``'s,
    ‖Δgot − Δwant‖ / ‖Δwant‖ (0 where both stayed put)."""
    out = {}
    for k, v in want.params.items():
        dw, dg = v - want.init[k], got[k] - want.init[k]
        scale = float(dw.norm())
        diff = float((dg - dw).norm())
        out[k] = diff / scale if scale else (0.0 if not diff else math.inf)
    return out


def assert_same_run(ranks: list[dict], raw: dict, probe: dict,
                    want: Run) -> None:
    """Every rank's losses against the one-process run's at the JAX tests'
    rtol 1e-5 / atol 1e-6 and its first parameters equal to the
    one-process run's; each step's gradient (gathered into one-process
    leaves) against one process's at the same parameters, each leaf within
    ``LEAF_GATE`` of its largest value: the floor that
    ``test_gradient_noise_floor`` measures for any route whose sums run in
    another order, where a missing or doubled mp sum moves a leaf by half
    its scale or more; each leaf's update over the run (the checkpoint's
    final parameters less the first) within ``UPDATE_GATE`` of the
    one-process update. ``probe``: the one-process config (a fresh output
    dir) that takes each step from the layout run's parameters."""
    assert len(want.losses) == 2 and np.isfinite(want.losses).all()
    for r in ranks:
        np.testing.assert_allclose(r["losses"], want.losses, **LOSS_TOL)
        first = r["steps"][0]["params"]
        assert first.keys() == want.init.keys()
        assert all(torch.equal(first[k], v) for k, v in want.init.items())
    one_grads: list = []
    with probe_grads(tmain, [s["params"] for s in ranks[0]["steps"]],
                     one_grads):
        tmain.train(TrainRunConfig.from_dict(probe), device="cpu",
                    params=want.init)
    for r in ranks:
        assert len(r["steps"]) == len(one_grads) == 2
        for got, ref in zip(r["steps"], one_grads):
            assert got["grads"].keys() == ref.keys()
            for n, t in ref.items():
                assert got["grads"][n].shape == t.shape, n
                err = _leaf_err(got["grads"][n], t)
                assert err <= LEAF_GATE, (r["rank"], n, err)
    got = final_params(raw)
    assert got.keys() == want.params.keys()
    errs = update_errs(got, want)
    bad = {k: e for k, e in errs.items() if not e <= UPDATE_GATE}
    assert not bad, bad


def jax_start(raw: dict, cfg=CFG) -> dict:
    """The JAX trainer's initial parameters of ``raw`` as the port's state
    dict."""
    jcfg = JRunConfig.from_dict(copy.deepcopy(raw))
    return from_jax_params(
        jax.tree.map(np.asarray, jmain.build_params(jcfg, jcfg.seed)), cfg)


@pytest.fixture(scope="session")
def run_cache(tmp_path_factory) -> str:
    return cache_dir(tmp_path_factory)


@pytest.fixture(scope="module")
def start(run_dirs, tmp_path_factory, run_cache) -> tuple[str, dict]:
    """The JAX trainer's initial parameters of the layout config as the
    port's state dict, and the file they are saved in: every run here
    starts from them, so that the JAX mesh runs are comparable."""
    raw = layout_config(run_dirs, tmp_path_factory.mktemp("start"))
    params = cached(run_cache, "start", _portable(raw),
                    lambda: jax_start(raw))
    path = str(tmp_path_factory.mktemp("start") / "params.pt")
    torch.save(params, path)
    return path, params


@pytest.fixture(scope="module")
def reference(run_dirs, tmp_path_factory, start, run_cache):
    """The one-process run every layout here is held to."""
    raw = layout_config(run_dirs, tmp_path_factory.mktemp("one"))
    return Run(*cached(run_cache, "one_process", _portable(raw),
                       lambda: tuple(one_process(raw, start[1]))))


def _model(cfg=CFG) -> KEEPModel:
    gen = torch.Generator().manual_seed(0)
    return KEEPModel.init(cfg, gen, device="cpu")


def test_tp_fraction_matches_jax():
    """The leaves that split over mp = 2 (qkv by head, fc1, proj / out and
    fc2, the visual head's pair) are the JAX layout's, by element count;
    at mp = 4 the 2-head towers' attention pairs stay replicated (4 does
    not divide 2 heads) while JAX splits their leaves (its rule is per
    leaf: 3D and D divide by 4): the recorded difference."""
    from jax.sharding import Mesh

    model = _model()
    jparams = to_jax_params(
        {k: v.detach() for k, v in model.state_dict().items()}, CFG)
    devices = np.array(jax.devices()[:8])
    for mp in (2, 4):
        mesh = Mesh(devices.reshape(8 // mp, mp), ("dp", "mp"))
        got = ptp.tp_fraction(model, mp)
        want = jtp_fraction(jparams, mesh)
        if mp == 2:
            assert got == pytest.approx(want, rel=1e-12)
        else:
            assert got < want
    specs = ptp.tp_shardings(model, 2)
    assert specs["visual.blocks.0.attn.qkv.weight"] == ptp.Split(0, 3)
    assert specs["text.blocks.1.attn.out.weight"] == ptp.Split(1)
    assert specs["text.blocks.1.attn.out.bias"] is None
    assert specs["visual_head.fc1.bias"] == ptp.Split(0)
    assert specs["text.embeddings.word"] is None


def test_gradient_noise_floor(run_dirs, tmp_path):
    """Why the layouts' gradients are held per leaf at ``LEAF_GATE`` and
    not at rtol 1e-5: on this run's data one process's own step-0
    gradients move by more than 1e-4 of a leaf's largest value when the
    parameters move by 1e-7 of themselves (fp32 noise, what any change of
    summation order makes of them), and stay within the gate."""
    from tests.torch_dp_worker import record_grads

    runs = []
    for name, noise in (("a", 0.0), ("b", 1e-7)):
        raw = layout_config(run_dirs, tmp_path / name, epochs=1)
        kw = {}
        if runs:
            gen = torch.Generator().manual_seed(5)
            kw["params"] = {k: v * (1 + noise * torch.randn(
                v.shape, generator=gen)) for k, v in runs[0][0][
                    "params"].items()}
        steps: list = []
        with record_grads(steps):
            tmain.train(TrainRunConfig.from_dict(raw), device="cpu", **kw)
        runs.append(steps)
    a, b = runs[0][0]["grads"], runs[1][0]["grads"]
    worst = max(_leaf_err(b[n], a[n]) for n in a)
    assert 1e-4 < worst <= LEAF_GATE / 2, worst


def test_process_mesh_groups_and_collectives(tmp_path):
    """Four ranks over gloo as dp 2 × mp 2 (``torch_dp_worker.py mesh``):
    the rank layout, each axis's group, the row gather over dp, the hybrid
    mesh's node check, and the sequence split of an odd length with its
    backward."""
    _run_workers("mesh", None, tmp_path, n=4)


def test_qkv_pieces_hold_their_heads():
    """Rank r's qkv piece is the q, k and v rows of heads r·H/mp..; the
    pieces of every rank join back into the leaf."""
    h, dh, d = 4, 3, 5
    w = torch.arange(3 * h * dh * d, dtype=torch.float32).view(3 * h * dh, d)
    split = ptp.Split(0, 3)
    pieces = [ptp._shard(w, split, 2, r) for r in range(2)]
    heads = w.view(3, h, dh, d)
    for r, p in enumerate(pieces):
        assert torch.equal(p.view(3, 2, dh, d), heads[:, 2 * r: 2 * r + 2])
    assert torch.equal(ptp._unshard(pieces, split), w)


def test_tp2_follows_one_process(run_dirs, tmp_path, start, reference,
                                run_cache):
    """solver.tp = 2 at world 2 (dp 1 × mp 2): the towers' attention on
    H/2 heads a rank, Megatron's collectives, the one-process trajectory;
    the losses also the JAX trainer's at tp = 2 on its 8-device mesh (dp 4
    × mp 2) within ``test_train_matches_jax``'s rtol 1e-5."""
    raw = layout_config(run_dirs, tmp_path / "tp", tp=2)
    ranks = run_layout(raw, tmp_path, "tp", 2, start[0])
    assert_same_run(ranks, raw, layout_config(run_dirs, tmp_path / "probe"),
                    reference)
    want = jax_losses(layout_config(run_dirs, tmp_path / "jax", tp=2),
                      run_cache)
    np.testing.assert_allclose(ranks[0]["losses"], want, rtol=1e-5)


def test_tp2_fsdp_follows_one_process(run_dirs, tmp_path, start, reference):
    """solver.tp = 2 with solver.fsdp at world 4 (dp 2 × mp 2, the JAX
    package's Megatron-LM 2-D state layout): the one-process
    trajectory."""
    raw = layout_config(run_dirs, tmp_path / "tpf", tp=2, fsdp=True,
                        fsdp_min_size=128)
    ranks = run_layout(raw, tmp_path, "tpf", 4, start[0])
    assert_same_run(ranks, raw, layout_config(run_dirs, tmp_path / "probe"),
                    reference)


def test_tp_checkpoint_resumes_in_one_process(run_dirs, tmp_path, start,
                                              reference):
    """A tp = 2 run's checkpoint (epoch 0) holds the one-process leaves;
    one process resumes it and trains epoch 1 onto the one-process
    trajectory."""
    raw = layout_config(run_dirs, tmp_path / "resume", epochs=1, tp=2)
    run_layout(raw, tmp_path, "resume", 2, start[0])
    one = layout_config(run_dirs, tmp_path / "resume")
    one["save"]["resume"] = "latest"
    losses, params, _ = one_process(one)
    np.testing.assert_allclose(losses, reference.losses[1:], **LOSS_TOL)
    errs = update_errs(params, reference)
    bad = {k: e for k, e in errs.items() if not e <= UPDATE_GATE}
    assert not bad, bad


@pytest.mark.parametrize("fault", ["shard_left_as_it_started",
                                   "update_halved", "update_reversed"])
def test_update_gate_sees_planted_faults(reference, fault):
    """The final-parameter gate against faults planted in the one-process
    run's final parameters: one rank's fsdp shard of a leaf never updated
    (a lost write-back), a leaf's update halved (its second moment four
    times too large) or reversed (a sign); each reads far above
    ``UPDATE_GATE`` on that leaf and on it alone."""
    name = "visual.blocks.0.attn.qkv.weight"
    init, final = reference.init[name], reference.params[name]
    planted = dict(reference.params)
    if fault == "shard_left_as_it_started":
        half = final.shape[0] // 2
        planted[name] = torch.cat([final[:half], init[half:]])
    else:
        k = 0.5 if fault == "update_halved" else -1.0
        planted[name] = init + k * (final - init)
    errs = update_errs(planted, reference)
    assert errs[name] > 10 * UPDATE_GATE, errs[name]
    assert max(e for k, e in errs.items() if k != name) == 0.0


@pytest.mark.parametrize("solver,world,match", [
    ({"tp": 2, "pp": 2}, 8, "mutually exclusive"),
    ({"pp": 2, "fsdp": True}, 8, "mutually exclusive"),
    ({"sp": True}, 8, "requires solver.tp"),
    ({"tp": 2, "sp": True, "accum_freq": 2}, 8, "accum_freq > 1"),
    ({"tp": 3}, 8, "does not divide 8 devices"),
    ({"tp": 2}, 8, "not divisible"),
    ({"tp": 2, "moe": True}, 8, "MoE trunk"),
    ({"ep": 2}, 8, "requires model.vision.moe_experts"),
    ({"lora_rank": 2, "tp": 2}, 8, "composes with dp only"),
])
def test_config_errors_as_jax(run_dirs, tmp_path, solver, world, match):
    """The JAX trainer's layout errors, in its words, before anything runs;
    the tp batch check as ``test_train_tp_equivalence`` makes it (batch 6
    over dp = 4)."""
    raw = _run_config(run_dirs, tmp_path)
    solver = dict(solver)
    if solver.pop("moe", False):
        raw["keep"]["vision"]["moe_experts"] = 4
    raw["solver"].update(solver)
    raw["dataloader"].update(batch_size=6, caption_num=2)
    with pytest.raises(ValueError, match=match):
        tmain.check_supported(TrainRunConfig.from_dict(raw), world)


@pytest.mark.parametrize("solver", [{"pp": 2}, {"ep": 2, "moe": True}])
def test_pp_and_ep_still_refused(run_dirs, tmp_path, solver):
    """pp and ep are refused only where the JAX trainer refuses them: at
    world 8 the (dp 4, pp 2) and (dp 4, ep 2) layouts pass the checks; 3
    ranks raise its ValueError, in its words."""
    raw = _run_config(run_dirs, tmp_path)
    solver = dict(solver)
    if solver.pop("moe", False):
        raw["keep"]["vision"]["moe_experts"] = 4
    raw["solver"].update(solver)
    tmain.check_supported(TrainRunConfig.from_dict(raw), 8)
    which = "pp" if "pp" in solver else "ep"
    with pytest.raises(ValueError,
                       match=f"solver.{which}=2 does not divide 3 devices"):
        tmain.check_supported(TrainRunConfig.from_dict(raw), 3)


def test_dataclass_layout_matches_specs():
    """``tp_fsdp_shardings`` composes the tp split with FSDP's choice: a
    split leaf shards over dp on another axis, a replicated leaf as plain
    FSDP (``test_tp_fsdp_spec_composition``'s rule)."""
    model = _model()
    layout = ptp.tp_fsdp_shardings(model, 2, 2, min_size=128)
    split, ax = layout["visual.blocks.0.attn.qkv.weight"]
    assert split == ptp.Split(0, 3) and ax == 1
    split, ax = layout["visual.blocks.0.attn.proj.weight"]
    assert split == ptp.Split(1) and ax == 0
    assert layout["visual.pos_embed"] == (None, 2)
    assert dataclasses.astuple(ptp.Split(0)) == (0, 1)
