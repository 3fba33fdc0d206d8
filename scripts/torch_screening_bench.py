#!/usr/bin/env python3
"""Where the time of the prompt screening (``zeroshot.classifier``'s
``prompt_select``) goes on one NVIDIA GPU, at the WSI sweep's sizes.

    PYTHONPATH=. python3 scripts/torch_screening_bench.py

Seeded features [100,000, 768] and a stack of 1,386 two-class classifiers
(the reference's screened pool) on the card. Prints the card's name and
power limit, then one JSON object of CUDA-event medians (ms): the whole
screening; its fp32 product [N, D] × [D, P·C] alone; the top two of each
row of the [P, N, C] logits through ``torch.topk`` and through the port's
``rank_cls_scores`` (a max, then a max with that entry masked), with the
largest difference between the two routes' scores; and the screening's
device time by kernel from ``torch.profiler``. Imports no JAX.
"""

from __future__ import annotations

import json

import torch

from chip_smoke import card, cuda_ms, kernel_ms
from keep_tpu_torch.ops.nn import ieee_fp32, l2_normalize
from keep_tpu_torch.zeroshot import classifier as zc


def topk_scores(logits: torch.Tensor) -> torch.Tensor:
    top2 = torch.topk(logits, 2, dim=-1).values
    return ((top2[..., 0] - top2[..., 1])
            - (top2[..., 0] + top2[..., 1] - 1.0).abs()).mean(-1)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    print(card(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    feats = torch.randn(100_000, 768, device="cuda", generator=gen)
    stack = torch.nn.functional.normalize(
        torch.randn(1386, 768, 2, device="cuda", generator=gen), dim=1)
    p, d, c = stack.shape
    f = l2_normalize(feats)
    w = stack.permute(1, 0, 2).reshape(d, p * c)
    with ieee_fp32():
        logits = (f @ w).view(-1, p, c).transpose(0, 1)  # [P, N, C]

    def product():
        with ieee_fp32():
            return f @ w

    out = {"screening_ms": cuda_ms(
               lambda: zc._prompt_select_jit(stack, feats, 50), runs=10),
           "product_ms": cuda_ms(product, runs=10),
           "top2_torch_topk_ms": cuda_ms(lambda: topk_scores(logits),
                                         runs=10),
           "top2_max_masked_max_ms": cuda_ms(
               lambda: zc.rank_cls_scores(logits), runs=10),
           "scores_max_abs_diff": (topk_scores(logits)
                                   - zc.rank_cls_scores(logits)
                                   ).abs().max().item()}
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        zc._prompt_select_jit(stack, feats, 50)
        torch.cuda.synchronize()
    out["screening_device_ms_by_kernel"] = sorted(
        kernel_ms(torch, prof).items(), key=lambda kv: -kv[1])[:6]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
