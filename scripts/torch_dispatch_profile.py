#!/usr/bin/env python3
"""Device time of one serving dispatch of each tower of the PyTorch port
(``keep_tpu_torch``) on one NVIDIA GPU, by kernel family, bf16 and int8.

    python3 scripts/torch_dispatch_profile.py [--batch 128] [--runs 10]

Builds the published KEEP at full width and depth (ViT-L/16 224², BERT-base
at 256 tokens) with random weights drawn with the statistics of the JAX
package's ``keep.init`` (``KEEPModel.init``), as the serving code holds it
(bf16, fused attention), then its int8 W8A8 form (``quantize()``), and
times a bucket of ``--batch`` tiles and of ``--batch`` prompts of each:
CUDA events around one forward (median of ``--runs``), then one forward
under ``torch.profiler`` summed by kernel family (``family``). Prints the
card's name and power limit, then one JSON line per precision and tower.
Needs an NVIDIA GPU; imports no JAX and nothing of the script's own
directory, so the same file can time another checkout of the package (run
it from that checkout's root with ``PYTHONPATH=.``).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

# kernel families, first match wins: the port's own kernels by name, then
# cuBLAS's GEMMs, PyTorch's LayerNorm and its elementwise kernels
FAMILIES = (("attention", ("slab_attention",)),
            ("int8_gemm", ("int8_gemm",)),
            ("quant_rows", ("quant_rows",)),
            ("ln_rows", ("ln_rows",)),
            ("layer_norm", ("layer_norm",)),
            ("gemm", ("gemm", "xmma", "nvjet", "cutlass", "sm90_")),
            ("elementwise", ("elementwise", "vectorized", "unrolled",
                             "copy_kernel")))


def family(kernel: str) -> str:
    """The family of a device kernel, from its name."""
    k = kernel.lower()
    return next((f for f, keys in FAMILIES if any(s in k for s in keys)),
                "other")


def by_family(by_kernel: dict[str, float]) -> dict[str, float]:
    out: dict[str, float] = {}
    for k, v in by_kernel.items():
        out[family(k)] = out.get(family(k), 0.0) + v
    return out


def profile_kernels(fn) -> dict[str, float]:
    """Device ms by kernel name of one call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA:
            out[ev.key] = out.get(ev.key, 0.0) + ev.self_device_time_total / 1e3
    return out


def event_ms(fn, runs: int) -> float:
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--runs", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    from keep_tpu_torch.configs import KEEPConfig
    from keep_tpu_torch.models.keep import KEEPModel

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = KEEPConfig()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = KEEPModel.init(cfg, gen, device="cuda", dtype=torch.bfloat16,
                           use_flash=True).eval()
    px = torch.randn(args.batch, cfg.vision.img_size, cfg.vision.img_size, 3,
                     device="cuda", generator=gen)
    ids = torch.randint(1, cfg.text.vocab_size, (args.batch, 256),
                        device="cuda", generator=gen)
    mask = torch.ones_like(ids)
    for precision in ("bf16", "int8"):
        if precision == "int8":
            model = model.quantize()
        for tower, fn in (("image", lambda: model.encode_image(px)),
                          ("text", lambda: model.encode_text(ids, mask))):
            with torch.inference_mode():
                ms = event_ms(fn, args.runs)
                kernels = profile_kernels(fn)
            total = sum(kernels.values())
            print(json.dumps({
                "precision": precision, "tower": tower, "batch": args.batch,
                "event_ms": ms, "kernel_ms": total,
                "idle_share": 1 - total / ms,
                "ms_by_family": by_family(kernels),
                "top_kernels_ms": sorted(kernels.items(),
                                         key=lambda kv: -kv[1])[:8]}),
                flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
