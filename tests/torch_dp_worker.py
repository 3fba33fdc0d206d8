"""Worker of the two-process data-parallel tests
(``tests/test_torch_multiprocess.py``), one process per rank over gloo on
the CPU:

    python tests/torch_dp_worker.py <objects|mesh|pipeline|train> <spec>

under the torchrun-style environment the test sets (MASTER_ADDR /
MASTER_PORT / RANK / WORLD_SIZE). ``objects`` checks the object
collectives and the training step's tensor collectives against their
definitions; ``mesh`` (four ranks) the dp × mp process mesh, its groups
and the sequence-parallel collectives; ``pipeline`` (four ranks)
``parallel.pp.pipeline_blocks`` and ``vit_forward_pp`` against a loop in
one process, writing its readings to ``<spec.out>.<rank>.json`` and the
ViT's features to ``<spec.out>.<rank>.vit.pt``; ``train`` runs
``keep_tpu_torch.train.main.train`` as the spec says and writes each
step's loss and the last record to ``<spec.out>.<rank>.json``, each step's
starting parameters and reduced gradients to
``<spec.out>.<rank>.grads.pt`` and the rank's own state after the last
step to ``<spec.out>.<rank>.final.pt``. Imports the port only.
"""

import contextlib
import json
import os
import sys


@contextlib.contextmanager
def record_losses(tmain, losses: list):
    """Appends each optimizer step's loss to ``losses`` while ``tmain``
    (``keep_tpu_torch.train.main``) trains."""
    made = (tmain.make_train_step, tmain.make_accum_train_step)

    def recording(make):
        def build(*args, **kw):
            step = make(*args, **kw)

            def run(*a, **k):
                state, metrics = step(*a, **k)
                losses.append(float(metrics["loss"]))
                return state, metrics
            return run
        return build

    tmain.make_train_step, tmain.make_accum_train_step = map(recording, made)
    try:
        yield losses
    finally:
        tmain.make_train_step, tmain.make_accum_train_step = made


@contextlib.contextmanager
def record_grads(grads: list, final: dict | None = None):
    """Appends, for each optimizer step, ``{"params": ..., "grads": ...}``
    to ``grads``: the trained parameters the step started from and the
    gradient dict as the optimizer gets it (summed over the ranks, before
    the freeze mask and clipping), as CPU tensors; under a parallel layout
    (the step's ``layout``) both as one-process leaves, gathered from every
    rank's pieces. ``final`` takes this rank's own state leaves after each
    step (the last step's when the block ends)."""
    from keep_tpu_torch.train import trainer

    apply = trainer._optimizer_apply

    def recording(state, g, *args, **kw):
        params = state.params
        layout = args[3] if len(args) > 3 else kw.get("layout")
        if layout is not None:  # every rank's pieces as one-process leaves
            params, g_full = layout.full(params), layout.full(g)
        else:
            g_full = g
        grads.append({key: {n: t.detach().cpu().clone()
                            for n, t in tree.items()}
                      for key, tree in (("params", params),
                                        ("grads", g_full))})
        out = apply(state, g, *args, **kw)
        if final is not None:
            final.update({n: t.detach().cpu().clone()
                          for n, t in state.params.items()})
        return out

    trainer._optimizer_apply = recording
    try:
        yield grads
    finally:
        trainer._optimizer_apply = apply


def check_objects() -> str:
    import torch

    from keep_tpu_torch.parallel import (all_reduce_grads, gather_rows,
                                         mean_over_ranks, multihost)

    assert multihost.init_from_env("cpu") is True
    rank, world = multihost.process_index(), multihost.process_count()
    assert world == 2, world
    # object broadcast: process 0's value everywhere
    obj = {"resume": "epoch_7.pt", "rank_saw": rank} if rank == 0 else None
    assert multihost.broadcast_object(obj) == {"resume": "epoch_7.pt",
                                               "rank_saw": 0}
    # object all-gather: one entry per process, in rank order
    got = multihost.all_gather_object({"rank": rank, "tag": "x" * (rank + 1)})
    assert [g["rank"] for g in got] == [0, 1] and got[1]["tag"] == "xx", got
    # the row gather: rank order forward, this rank's rows backward
    x = torch.arange(6.0).reshape(3, 2).add(10 * rank).requires_grad_()
    y = gather_rows(x)
    want = torch.cat([torch.arange(6.0).reshape(3, 2),
                      torch.arange(6.0).reshape(3, 2) + 10])
    assert torch.equal(y.detach(), want), y
    w = torch.arange(12.0).reshape(6, 2)
    (y * w).sum().backward()
    assert torch.equal(x.grad, w[3 * rank: 3 * rank + 3]), x.grad
    # the mean over ranks: the global statistic forward, 1/N backward
    s = torch.tensor([1.0 + rank, 4.0]).requires_grad_()
    m = mean_over_ranks(s)
    assert torch.equal(m.detach(), torch.tensor([1.5, 4.0])), m
    m.sum().backward()
    assert torch.equal(s.grad, torch.full((2,), 0.5)), s.grad
    # gradients summed over the ranks in buckets; logit_scale left whole
    grads = {"a": torch.full((3,), 1.0 + rank), "b": torch.ones(2, 2) * rank,
             "logit_scale": torch.tensor(5.0)}
    all_reduce_grads(grads)
    assert torch.equal(grads["a"], torch.full((3,), 3.0))
    assert torch.equal(grads["b"], torch.ones(2, 2))
    assert float(grads["logit_scale"]) == 5.0
    return f"OK rank={rank}"


def check_mesh() -> str:
    """Four ranks as a dp 2 × mp 2 mesh: rank r at (r // 2, r % 2), each
    axis's group summing over its own ranks, the row gather over dp; the
    hybrid mesh's node check; the sequence split of an odd length (pad,
    gather, reduce-scatter, and their backwards)."""
    import torch

    from keep_tpu_torch.parallel import gather_rows, mesh, multihost
    from keep_tpu_torch.parallel.sp import seq_sharding

    assert multihost.init_from_env("cpu") is True
    rank = multihost.process_index()
    m = mesh.make_mesh(axes=("dp", "mp"), shape=(2, 2))
    assert (m.rank("dp"), m.rank("mp")) == (rank // 2, rank % 2), m.index
    for axis, want in (("mp", [2 * (rank // 2), 2 * (rank // 2) + 1]),
                       ("dp", [rank % 2, rank % 2 + 2])):
        t = torch.tensor([float(rank)])
        mesh.all_reduce_(t, m.group(axis))
        assert t.item() == sum(want), (axis, t)
    with mesh.use_mesh(m):
        assert mesh.dp_rank_world() == (rank // 2, 2)
        x = torch.full((2, 3), float(rank // 2)).requires_grad_()
        y = gather_rows(x)
        assert torch.equal(y.detach()[:, 0], torch.tensor([0., 0., 1., 1.]))
    hybrid = mesh.make_hybrid_mesh((1, 2), (2, 1), ("dp", "mp"))
    assert hybrid.shape == (2, 2) and hybrid.index == m.index
    os.environ["LOCAL_WORLD_SIZE"] = "1"
    try:
        mesh.make_hybrid_mesh((1, 2), (2, 1), ("dp", "mp"))
    except ValueError as e:
        assert "inside a node" in str(e)
    else:
        raise AssertionError("an mp group across nodes was accepted")
    finally:
        os.environ["LOCAL_WORLD_SIZE"] = "4"
    # the sequence split over mp: 5 rows padded to 6, 3 a rank
    shard = seq_sharding(m).shard(5)
    full = torch.arange(10.0).view(1, 5, 2).requires_grad_()
    mine = shard.enter(full)
    assert mine.shape == (1, 3, 2)
    back = shard.gather(mine)
    assert torch.equal(back.detach(), full.detach())
    partial = back * (1.0 + m.rank("mp"))  # a rank's own weights
    summed = shard.reduce_scatter(partial)
    want = (full.detach() * 3.0)
    want = torch.nn.functional.pad(want, (0, 0, 0, 1))[:, 3 * m.rank("mp"):
                                                        3 * m.rank("mp") + 3]
    assert torch.equal(summed.detach(), want), (summed, want)
    out = shard.leave(summed)
    out.sum().backward()
    # every full row reaches the loss through both ranks' partial products
    assert torch.equal(full.grad, torch.full((1, 5, 2), 3.0)), full.grad
    return f"OK rank={rank}"


def _toy_blocks(depth: int, d: int, seed: int = 0) -> list:
    """``depth`` layers of tanh(h @ w + b), each a dict of tensors that
    take gradients."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    return [{"w": (torch.randn(d, d, generator=gen) / d).requires_grad_(),
             "b": torch.randn(d, generator=gen).requires_grad_()}
            for _ in range(depth)]


def _toy_step(lp, h):
    import torch

    return torch.tanh(h @ lp["w"] + lp["b"])


def check_pipeline(spec: dict) -> str:
    """Four ranks: ``pipeline_blocks`` over 4 stages (one dp index) and
    over 2 stages of a dp 2 × pp 2 mesh, each at two microbatch counts,
    with and without remat, against the loop over all layers in this
    process: the output on every rank, the gradients of the stage's
    layers (summed over dp) and of the input (max |Δ| of each, written to
    the readings); the shape errors; one stage; ``vit_forward_pp`` of the
    ViT in the spec over 4 stages, its blocks whole and staged
    (``HeldElsewhere``), the features written for the test to hold to the
    JAX package's."""
    import torch

    from keep_tpu_torch import configs
    from keep_tpu_torch.models.vit import VisionTransformer
    from keep_tpu_torch.parallel import mesh, multihost, pp

    assert multihost.init_from_env("cpu") is True
    rank = multihost.process_index()
    depth, d, b = 8, 16, 8
    blocks = _toy_blocks(depth, d)
    x0 = torch.randn(b, d, generator=torch.Generator().manual_seed(1))
    x = x0.clone().requires_grad_()
    h = x
    for lp in blocks:
        h = _toy_step(lp, h)
    want = h.detach()
    want_g = torch.autograd.grad(h.pow(2).sum(), [x] + [lp[k] for lp in blocks
                                                        for k in "wb"])
    readings: dict = {}
    meshes = {4: mesh.make_mesh(axes=("dp", "pp"), shape=(1, 4)),
              2: mesh.make_mesh(axes=("dp", "pp"), shape=(2, 2))}
    for n_stages, m, remat in ((4, 4, False), (4, 8, False), (2, 2, False),
                               (2, 4, False), (4, 4, True), (2, 2, True)):
        mm = meshes[n_stages]
        rows = mesh.batch_sharding(range(mm.size("dp")), b)[mm.rank("dp")]
        x = x0[rows].clone().requires_grad_()
        got = pp.pipeline_blocks(_toy_step, blocks, x, mm,
                                 num_microbatches=m, remat=remat)
        leaves = [lp[k] for lp in blocks for k in "wb"]
        g = torch.autograd.grad(got.pow(2).sum(), [x] + leaves,
                                allow_unused=True)
        # the stage's layers: their gradient summed over dp; the others
        # take none on this rank
        k = depth // n_stages
        mine = range(mm.rank("pp") * k * 2, (mm.rank("pp") + 1) * k * 2)
        err_p = 0.0
        for i, gi in enumerate(g[1:]):
            if i not in mine:
                assert gi is None, (n_stages, m, i)
                continue
            gi = mesh.all_reduce_(gi.clone(), mm.group("dp"))
            err_p = max(err_p, float((gi - want_g[1 + i]).abs().max()))
        readings[f"{n_stages}_{m}_{'remat' if remat else 'plain'}"] = {
            "out": float((got.detach() - want[rows]).abs().max()),
            "grad_params": err_p,
            "grad_input": float((g[0] - want_g[0][rows]).abs().max())}
    errors = []
    for depth_, rows_ in ((6, 4), (8, 3)):  # 6 layers over 4; B=3 over M=4
        try:
            pp.pipeline_blocks(_toy_step, _toy_blocks(depth_, d),
                               torch.zeros(rows_, d), meshes[4])
        except ValueError as e:
            errors.append(str(e))
    readings["shape_errors"] = errors
    one = pp.pipeline_blocks(_toy_step, blocks, x0, None)
    readings["one_stage_equal"] = bool(torch.equal(one, want))
    # the ViT: whole blocks, then staged ones
    cfg = configs.ViTConfig(**spec["vit_cfg"])
    vit = VisionTransformer(cfg)
    vit.load_state_dict(torch.load(spec["vit"], weights_only=True))
    px = torch.load(spec["pixels"], weights_only=True)
    feats = {"whole": pp.vit_forward_pp(vit, px, meshes[4],
                                        num_microbatches=4)}
    with torch.no_grad():
        for j in range(len(vit.blocks)):
            s = pp.stage_of(j, len(vit.blocks), 4)
            if s != meshes[4].rank("pp"):
                vit.blocks[j] = pp.HeldElsewhere(j, s)
    feats["staged"] = pp.vit_forward_pp(vit, px, meshes[4])
    torch.save({k: v.detach() for k, v in feats.items()},
               f"{spec['out']}.{rank}.vit.pt")
    with open(f"{spec['out']}.{rank}.json", "w") as f:
        json.dump(readings, f)
    return f"OK rank={rank}"


def run_train(spec: dict) -> str:
    import numpy as np
    import torch

    from keep_tpu_torch.parallel import multihost
    from keep_tpu_torch.train import main as tmain
    from keep_tpu_torch.train.config import TrainRunConfig

    cfg = TrainRunConfig.from_dict(spec["config"])
    kw = {}
    for key in ("params", "adapters"):
        if spec.get(key):
            kw[key] = torch.load(spec[key], weights_only=True)
    if spec.get("eval"):
        ev = np.load(spec["eval"])
        kw["eval_data"] = {"val": (ev["pixels"], list(ev["texts"]))}
    losses: list = []
    grads: list = []
    final: dict = {}
    with record_losses(tmain, losses), record_grads(grads, final):
        results = tmain.train(cfg, device="cpu", **kw)
    rank = multihost.process_index()
    torch.save(grads, f"{spec['out']}.{rank}.grads.pt")
    torch.save(final, f"{spec['out']}.{rank}.final.pt")
    with open(f"{spec['out']}.{rank}.json", "w") as f:
        json.dump({"rank": rank, "world": multihost.process_count(),
                   "losses": losses, "results": results}, f, default=float)
    return f"OK rank={rank}"


def main(mode: str, spec_path: str) -> None:
    if mode == "objects":
        print(check_objects(), flush=True)
    elif mode == "mesh":
        print(check_mesh(), flush=True)
    elif mode == "pipeline":
        with open(spec_path) as f:
            print(check_pipeline(json.load(f)), flush=True)
    else:
        with open(spec_path) as f:
            print(run_train(json.load(f)), flush=True)
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2] if len(sys.argv) > 2 else "")
