#!/usr/bin/env python3
"""Times the port's fused attention (``attention_qkv_slab``, kernel #1) on
one NVIDIA GPU at the KEEP towers' and the OpenCLIP zoo's shapes, beside
the plain version and ``F.scaled_dot_product_attention`` on the same values.

    python3 scripts/torch_attention_shapes_bench.py [--runs 25]

Each shape is (name, B, S, H, Dh): ViT-L/16 at 224² (S = 197, Dh = 64) at
B = 32 and 128, the body PR 5 wrote; ViT-H-14 (Dh = 80), ViT-g-14 /
EVA01-g-14 (88), ViT-bigG-14 (104) and ViT-e-14 (112) at S = 257; ViT-L
at S = 577 (ViT-L-14-336, KEEP at 384²) and 785 (KEEP at 448²); and Dh =
64 at S = 512 and 513, the last length PR 5's body takes and the first the
streamed body does (one key apart, so the pair compares the two bodies).
For each, in bf16: the kernel's time (median of ``--runs`` single calls
between CUDA events), the plain version's, SDPA's and the bound: the larger
of the two products' 4·S²·Dh operations per head over 989 TFLOP/s and the
slab read once plus the output written once over 3.35 TB/s. A checkout
whose kernel refuses a shape prints ``"refused"`` with its error, so the
same file can time another checkout of the package in the same call (run
it from that checkout's root with ``PYTHONPATH=.``). Prints the card's name
and power limit, then one JSON line per shape. Needs an NVIDIA GPU;
imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

PEAK_BF16 = 989e12
HBM_BYTES_PER_S = 3.35e12
SHAPES = [("vit_l16", 32, 197, 16, 64), ("vit_l16", 128, 197, 16, 64),
          ("s512", 32, 512, 16, 64), ("s513", 32, 513, 16, 64),
          ("vit_h14", 64, 257, 16, 80), ("vit_g14", 64, 257, 16, 88),
          ("vit_bigg14", 32, 257, 16, 104), ("vit_e14", 32, 257, 16, 112),
          ("vit_l14_336", 32, 577, 16, 64), ("keep_448", 32, 785, 16, 64)]


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


def bound_ms(b: int, s: int, h: int, dh: int) -> tuple[float, str]:
    ops = 4 * b * h * s * s * dh / PEAK_BF16
    moved = 4 * b * s * h * dh * 2 / HBM_BYTES_PER_S  # q, k, v in; out
    return (ops * 1e3, "operations") if ops >= moved else (moved * 1e3,
                                                           "bytes")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=25)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    from keep_tpu_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, b, s, h, dh in SHAPES:
        qkv = torch.randn(b, s, 3 * h * dh, device="cuda", generator=gen)
        qkv = qkv.bfloat16()
        row = {"shape": name, "B": b, "S": s, "H": h, "Dh": dh,
               "dtype": "bfloat16"}
        try:
            got = fa.attention_qkv_slab(qkv, num_heads=h)
        except ValueError as e:
            print(json.dumps({**row, "refused": str(e)}), flush=True)
            continue
        ref = fa.attention_qkv_slab_reference(qkv, num_heads=h)
        q, k, v = qkv.view(b, s, 3, h, dh).permute(2, 0, 3, 1, 4)
        row.update(
            max_abs_err=(got.float() - ref.float()).abs().max().item(),
            ms=events_ms(lambda: fa.attention_qkv_slab(qkv, num_heads=h),
                         runs=args.runs),
            plain_ms=events_ms(lambda: fa.attention_qkv_slab_reference(
                qkv, num_heads=h), runs=args.runs),
            library_ms=events_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v), runs=args.runs))
        row["bound_ms"], row["bound_by"] = bound_ms(b, s, h, dh)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
