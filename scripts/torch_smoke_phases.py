"""``chip_smoke.py``'s phases 25 (``wide_shapes``), 26 (``dp2_layouts``),
27 (``pp_ep_layouts``) and 28 (``precision_policy``) alone on one card,
and the readings of their gradient gates on planted faults.

    python scripts/torch_smoke_phases.py [--wide] [--layouts] [--pp-ep]
        [--policy] [--plant [NAME ...]]

Builds the kernels from the checkout (``kernels._build.library``), then
with ``--wide`` (default: both phases) #1b and the bf16 → fp32 attention of
the int8 blocks at the widened shapes against their plain versions, an
int8 KEEP at 384² and 448² through the server core, and KEEP trained at
384²; with ``--layouts`` dp, fsdp, tp = 2 and tp = 2 + sp at world 2 and
tp = 2 + fsdp at world 4 over gloo on the card against one process; with
``--pp-ep`` pp = 2 and dp 2 × pp 2 on the dense KEEP, ep = 2 and dp 2 × ep
2 on the 8-expert MoE KEEP, the same way; with ``--policy`` the server's
``--precision-policy auto`` on a full-width KEEP (``keep.init``'s weights):
co-located, then at a relay's round trip through the real B=1 probe,
then the bf16 alt model built directly, and ptxas's record of every kernel
function (``utils.compile.kernel_resources``, one per ``.cu`` at least).
Prints the card and its power limit, then the phases' lines as
``chip_smoke.py`` does, each gate raising as there, and each phase's
seconds.

``--plant`` (alone: no phase) runs the phases' gradient comparisons on
faults planted at run time, with the gates off, and prints what each gate
reads beside its limit; NAME picks some (default: all):

- ``wide_none``: no fault (the sound reading of the same comparison);
- ``wide_tail_row``: every #1b result's last token row zeroed (a streamed
  body that drops the partial last tile: S = 577 is 9 × 64 + 1);
- ``wide_dk_one_block`` / ``wide_dv_one_block``: the dk / dv third of the
  first #1b result of each backward (one block a step) zeroed;
- ``dp2_mp_sum``: tp = 2 with the mp all-reduce of the first attention
  pair a rank runs (the ViT's block 0) dropped, its row product's partial
  sum taken as the whole;
- ``pp_hop_grad``: pp = 2 with the first gradient each pipeline backward
  sends (stage 1's input gradient of microbatch 0, to stage 0) zeroed;
- ``ep_gather_swap``: ep = 2 with the two ranks' slices of the first MoE
  block's gathered expert output swapped (each token takes the output of
  the expert E/2 places away).

Each wide plant takes 1 step of the 384² training (batch 32) beside its
plain-attention step; the layout plants run their layout alone
(``--plant-child NAME <spec>`` is its rank).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


@contextlib.contextmanager
def planted_bwd(torch, fault: str, blocks: int):
    """#1b's results altered as ``fault`` says while the block runs (the
    kernel still launches: its count is unchanged)."""
    ops = torch.ops.keep
    bwd = ops.attention_qkv_slab_bwd
    calls = [0]

    def planted(qkv, key_bias, dout, num_heads):
        dqkv = bwd(qkv, key_bias, dout, num_heads).clone()
        if fault == "tail_row":
            dqkv[:, -1] = 0
        elif fault != "none" and calls[0] % blocks == 0:
            # dk or dv of each backward's first call
            b, s, _ = dqkv.shape
            dqkv.view(b, s, 3, -1)[:, :, 1 if fault == "dk_one_block"
                                   else 2] = 0
        calls[0] += 1
        return dqkv

    ops.attention_qkv_slab_bwd = planted
    try:
        yield
    finally:
        ops.attention_qkv_slab_bwd = bwd


def plant_mp_sum() -> None:
    """Drops the mp all-reduce of the first attention pair this rank runs
    (and of its recomputes): the row product's partial sum plus the bias
    is taken as the pair's output, forward and backward."""
    from keep_tpu_torch.parallel import tp

    pair, region_out = tp.attention_pair, tp.region_out
    first: list = []

    def dropped(partial, bias, tp_, split, out_dtype, seq=None):
        return region_out(partial, bias, tp_, False, out_dtype, seq)

    def attention_pair(qkv, out, *args, **kw):
        if not first:
            first.append(out)
        if out is not first[0]:
            return pair(qkv, out, *args, **kw)
        tp.region_out = dropped
        try:
            return pair(qkv, out, *args, **kw)
        finally:
            tp.region_out = region_out

    tp.attention_pair = attention_pair


def plant_pp_hop_grad() -> None:
    """Zeroes the first gradient each pipeline backward sends (stage 1 →
    stage 0, microbatch 0)."""
    import torch

    from keep_tpu_torch.parallel import mesh, pp

    backward = pp._Pipeline.backward
    send = mesh.send

    def planted(ctx, grad):
        first = [True]

        def zeroed(t, dst, group):
            if first:
                first.pop()
                t = torch.zeros_like(t)
            send(t, dst, group)

        mesh.send = zeroed
        try:
            return backward(ctx, grad)
        finally:
            mesh.send = send

    pp._Pipeline.backward = staticmethod(planted)


def plant_ep_gather_swap() -> None:
    """Swaps the two ranks' slices of the first MoE block's gathered expert
    output (its recomputes too), forward only."""
    import torch

    from keep_tpu_torch.models import moe

    forward, mlp = moe._GatherExperts.forward, moe.moe_mlp
    first: list = []
    on = [False]

    def moe_mlp(p, x, **kw):
        if not first:
            first.append(p)
        on[0] = p is first[0]
        try:
            return mlp(p, x, **kw)
        finally:
            on[0] = False

    def swapped(ctx, out, group, rank):
        full = forward(ctx, out, group, rank)
        if not on[0]:
            return full
        k = ctx.k
        return torch.cat([full[:, k: 2 * k], full[:, :k], full[:, 2 * k:]],
                         dim=1)

    moe.moe_mlp = moe_mlp
    moe._GatherExperts.forward = staticmethod(swapped)


CHILD_PLANTS = {"dp2_mp_sum": plant_mp_sum, "pp_hop_grad": plant_pp_hop_grad,
                "ep_gather_swap": plant_ep_gather_swap}
PLANTS = ("wide_none", "wide_tail_row", "wide_dk_one_block",
          "wide_dv_one_block", *CHILD_PLANTS)


def run_plants(torch, cs, fa, names) -> None:
    """The gradient gates of phases 25 (c) and 26 on the planted faults
    ``names``."""
    from keep_tpu_torch.configs import KEEPConfig

    cfg = KEEPConfig()
    blocks = cfg.vision.depth + cfg.text.num_hidden_layers
    for fault in (n[len("wide_"):] for n in names if n.startswith("wide_")):
        with tempfile.TemporaryDirectory() as d, planted_bwd(torch, fault,
                                                             blocks):
            out = cs.drive_wide_train(torch, fa, d, steps=1, gate=False,
                                      name=f"plant_wide_{fault}")
        leaf = out["first_step_grad_leaf_norm_max_rel_diff"]
        glob = out["first_step_grad_global_norm_rel_diff"]
        cs.phase(f"plant_wide_{fault}_reading", leaf=leaf,
                 leaf_gate=cs.WIDE_GRAD_LEAF_GATE, global_norm=glob,
                 global_gate=cs.WIDE_GRAD_GLOBAL_GATE,
                 caught=not (leaf <= cs.WIDE_GRAD_LEAF_GATE
                             and glob <= cs.WIDE_GRAD_GLOBAL_GATE))
        torch.cuda.empty_cache()
    for name in (n for n in names if n in CHILD_PLANTS):
        child = [sys.executable, os.path.abspath(__file__), "--plant-child",
                 name]
        with tempfile.TemporaryDirectory() as d:
            if name == "dp2_mp_sum":
                tag = "tp2"
                out = cs.drive_dp2_layouts(
                    torch, fa, d, layouts={tag: cs.DP2_LAYOUTS[tag]},
                    child=child, gate=False, name=f"plant_{name}")
            else:
                tag = "pp2" if name.startswith("pp") else "ep2"
                which = {"pp_layouts": {}, "ep_layouts": {}}
                which[f"{tag[:2]}_layouts"] = {
                    tag: {**cs.PP_LAYOUTS, **cs.EP_LAYOUTS}[tag]}
                out = cs.drive_pp_ep_layouts(torch, fa, d, child=child,
                                             gate=False,
                                             name=f"plant_{name}", **which)
        row = out[tag]
        cs.phase(f"plant_{name}_reading",
                 loss=row["loss_max_rel_diff"], loss_rtol=1e-5,
                 leaf_norm=row["grad_leaf_norm_max_rel_diff"],
                 leaf_sum_over_l1=row["grad_leaf_sum_max_diff_over_l1"],
                 leaf_gate=cs.DP2_LEAF_GATE,
                 caught=not (row["loss_max_rel_diff"] <= 1e-5
                             and row["grad_leaf_norm_max_rel_diff"]
                             <= cs.DP2_LEAF_GATE
                             and row["grad_leaf_sum_max_diff_over_l1"]
                             <= cs.DP2_LEAF_GATE))
        torch.cuda.empty_cache()


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--plant-child":
        import chip_smoke as cs

        CHILD_PLANTS[sys.argv[2]]()
        cs.dp_child(sys.argv[3])
        return 0
    import torch

    import chip_smoke as cs
    from keep_tpu_torch import serve
    from keep_tpu_torch.configs import KEEPConfig
    from keep_tpu_torch.kernels import _build
    from keep_tpu_torch.kernels import flash_attention as fa

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--wide", action="store_true", help="phase 25")
    ap.add_argument("--layouts", action="store_true", help="phase 26")
    ap.add_argument("--pp-ep", action="store_true", help="phase 27")
    ap.add_argument("--policy", action="store_true",
                    help="phase 28 and the kernel_resources line")
    ap.add_argument("--plant", nargs="*", choices=PLANTS,
                    help="the gradient gates' readings on planted faults "
                         "(default: all)")
    args = ap.parse_args()
    every = not (args.wide or args.layouts or args.pp_ep or args.policy
                 or args.plant is not None)
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card(), flush=True)
    _build.library()
    if args.wide or every:
        t0 = time.perf_counter()
        cs.check_wide_kernels(fa, torch,
                              torch.Generator(device="cuda").manual_seed(0))
        with tempfile.TemporaryDirectory() as d:
            cs.drive_wide_int8(torch, fa, serve, d, KEEPConfig())
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as d:
            cs.drive_wide_train(torch, fa, d)
        torch.cuda.empty_cache()
        cs.phase("wide_shapes_time", seconds=time.perf_counter() - t0)
    if args.layouts or every:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as d:
            cs.drive_dp2_layouts(torch, fa, d)
        cs.phase("dp2_layouts_time", seconds=time.perf_counter() - t0)
    if args.pp_ep or every:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as d:
            cs.drive_pp_ep_layouts(torch, fa, d)
        torch.cuda.empty_cache()
        cs.phase("pp_ep_layouts_time", seconds=time.perf_counter() - t0)
    if args.policy or every:
        from keep_tpu_torch.utils.compile import kernel_resources

        t0 = time.perf_counter()
        cfg = KEEPConfig()
        with tempfile.TemporaryDirectory() as d:
            cs.write_model(d, torch, cfg, keep_init=True)
            cs.drive_precision_policy(torch, fa, serve, cfg, d)
        torch.cuda.empty_cache()
        records = kernel_resources()
        missing = ({p.name for p in _build.CSRC.glob("*.cu")}
                   - {r["source"] for r in records})
        if missing:
            raise AssertionError(f"no ptxas record for {sorted(missing)}")
        print(json.dumps({"kernel_resources": records}), flush=True)
        cs.phase("precision_policy_time", seconds=time.perf_counter() - t0)
    if args.plant is not None:
        t0 = time.perf_counter()
        run_plants(torch, cs, fa, args.plant or PLANTS)
        cs.phase("plants_time", seconds=time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
