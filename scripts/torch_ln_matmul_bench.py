#!/usr/bin/env python3
"""Times the port's ``ln_matmul`` (the fused LayerNorm → matmul behind the
ViT's ``fuse_ln``) on one NVIDIA GPU, beside the routes that compute the
same function with PyTorch's own kernels.

    python3 scripts/torch_ln_matmul_bench.py [--batch 32 128] [--forward]

For each batch B and N in (3072, 4096) (ViT-L/16 qkv and fc1: M = 197·B
rows, K = 1024), in bf16: the kernel's time (CUDA events around one call,
median of ``--runs``; and its device time from ``torch.profiler``, split
into the statistics pass and the GEMM), the unfused route
(``F.layer_norm`` then ``F.linear``), the product alone in cuBLAS
(``F.linear`` on the normalised rows computed beforehand: the GEMM's
yardstick), and the bound: the larger of 2·M·K·N over 989 TFLOP/s and the
bytes (x, g, b, W, bias read once, the output written once) over 3.35
TB/s, with the kernel's share of it. With ``--forward``, the ViT-L/16
forward at B=128 (224², bf16, fused attention, tanh GELU, random weights
from a seed) with and without ``fuse_ln``: CUDA events and profiler
device ms. Prints the card's name and power limit, then one JSON line per
shape and one for the forward. Needs an NVIDIA GPU; imports no JAX and
nothing of the script's own directory, so the same file can time another
checkout of the package (run it from that checkout's root with
``PYTHONPATH=.``).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

PEAK_BF16 = 989e12
HBM_BYTES_PER_S = 3.35e12


def events_ms(fn, warmup: int = 3, runs: int = 25) -> float:
    """Median of ``runs`` single-call times from CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms_by_kernel(fn, runs: int = 20) -> dict[str, float]:
    """Device ms of one call of ``fn`` by kernel name: the profiler's
    kernel time summed over ``runs`` calls, host gaps left out."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        out[ev.key] = (out.get(ev.key, 0.0)
                       + ev.self_device_time_total / 1e3 / runs)
    return out


def bound_ms(m: int, k: int, n: int) -> tuple[float, str]:
    """The least time of one bf16 call: operations or bytes, the larger."""
    ops = 2 * m * k * n / PEAK_BF16 * 1e3
    moved = (m * k * 2 + 2 * k * 4 + n * k * 2 + n * 4 + m * n * 2)
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    return (ops, "operations") if ops >= t_bytes else (t_bytes, "bytes")


def measure(lm, x, g, b, w, bias, runs: int = 25) -> dict:
    """The timings of one bf16 shape (x [M, K], w [N, K] bf16; g, b, bias
    fp32): the kernel (events; device ms split into the statistics pass
    and the GEMM), the unfused route and the product alone in cuBLAS."""
    F = torch.nn.functional
    m, k = x.shape
    n = w.shape[0]
    call = lambda: lm.ln_matmul(x, g, b, w, bias, 1e-6, torch.bfloat16)  # noqa: E731
    by_kernel = device_ms_by_kernel(call)
    g16, b16, bias16 = g.bfloat16(), b.bfloat16(), bias.bfloat16()
    y = F.layer_norm(x, (k,), g16, b16, 1e-6)
    unfused = lambda: F.linear(F.layer_norm(x, (k,), g16, b16, 1e-6), w,  # noqa: E731
                               bias16)
    gemm = lambda: F.linear(y, w, bias16)  # noqa: E731
    bound, by = bound_ms(m, k, n)
    row = {"B": m // 197, "M": m, "K": k, "N": n,
           "ms": events_ms(call, runs=runs),
           "device_ms": sum(by_kernel.values()),
           "stats_ms": sum(v for kk, v in by_kernel.items()
                           if "ln_stats" in kk),
           "gemm_device_ms": sum(v for kk, v in by_kernel.items()
                                 if "ln_stats" not in kk),
           "unfused_ms": events_ms(unfused, runs=runs),
           "unfused_device_ms": sum(device_ms_by_kernel(unfused).values()),
           "gemm_library_ms": events_ms(gemm, runs=runs),
           "gemm_library_device_ms": sum(device_ms_by_kernel(gemm).values()),
           "bound_ms": bound, "bound_by": by}
    row["bound_fraction"] = bound / row["ms"]
    row["bound_fraction_device"] = bound / row["device_ms"]
    row["kernels"] = sorted(by_kernel)
    return row


def operands(m: int, n: int, gen: torch.Generator, k: int = 1024):
    """x [M, K] bf16, g, b fp32 [K], w [N, K] bf16, bias fp32 [N]: the
    draws of ``chip_smoke.check_ln_matmul``."""
    x = (torch.randn(m, k, device="cuda", generator=gen) * 2 + 0.5).bfloat16()
    g = 1 + 0.1 * torch.randn(k, device="cuda", generator=gen)
    b = 0.05 * torch.randn(k, device="cuda", generator=gen)
    w = (torch.randn(n, k, device="cuda", generator=gen) * k ** -0.5).bfloat16()
    bias = 0.02 * torch.randn(n, device="cuda", generator=gen)
    return x, g, b, w, bias


def forward(runs: int) -> dict:
    """The ViT-L/16 B=128 forward with and without ``fuse_ln``."""
    from keep_tpu_torch.compat.torch_loader import (load_keep_state_dict,
                                                    random_keep_state_dict)
    from keep_tpu_torch.configs import KEEPConfig
    from keep_tpu_torch.models.keep import KEEPModel

    cfg = KEEPConfig()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = KEEPModel(cfg, device="cuda", dtype=torch.bfloat16,
                      gelu_approx=True)
    model.load_state_dict(load_keep_state_dict(
        random_keep_state_dict(cfg, gen, device="cuda"), cfg), strict=True)
    model.eval()
    size = cfg.vision.img_size
    px = torch.randn(128, size, size, 3, device="cuda", generator=gen)
    kw = dict(dtype=torch.bfloat16, use_flash=True, gelu_approx=True)
    out = {"config": "ViT-L/16 224² bf16 B=128, random weights"}
    with torch.inference_mode():
        for tag, fuse in (("fused", True), ("unfused", False)):
            fn = lambda: model.visual(px, fuse_ln=fuse, **kw)  # noqa: E731
            out[f"{tag}_forward_ms"] = events_ms(fn, warmup=2, runs=runs)
            by_kernel = device_ms_by_kernel(fn, runs=3)
            out[f"{tag}_device_ms"] = sum(by_kernel.values())
            if fuse:
                out["fused_ln_matmul_device_ms"] = sum(
                    v for kk, v in by_kernel.items()
                    if "ln_matmul" in kk or "ln_stats" in kk)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[32, 128])
    ap.add_argument("--runs", type=int, default=25)
    ap.add_argument("--forward", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    from keep_tpu_torch.kernels import ln_matmul as lm

    gen = torch.Generator(device="cuda").manual_seed(0)
    for batch in args.batch:
        for n in (3072, 4096):
            row = measure(lm, *operands(197 * batch, n, gen), runs=args.runs)
            print(json.dumps(row), flush=True)
    if args.forward:
        print(json.dumps(forward(max(args.runs // 2, 5))), flush=True)


if __name__ == "__main__":
    main()
