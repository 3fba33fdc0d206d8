#!/usr/bin/env python3
"""Where the bf16 attention backward's time goes on the card: its two
kernels (#1b: kernel A, statistics and dq; kernel B, dk and dv) built
with one part changed or taken out at a time, each timed by the profiler.

    python3 scripts/torch_attention_bwd_parts.py [--rounds 2]

Builds the port's kernel sources once as written and once per entry of
``PARTS`` (a text edit of one kernel's source), each into a temporary
directory, in parallel, then times kernel A and kernel B of each build
(profiler device ms over 10 calls, ``torch_attention_shapes_bench.
device_kernels``) at ViT-L/16 (B = 32 and 128), BERT-base (B = 128, a
ragged key mask), KEEP at 448² (S = 785) and ViT-e (Dh 112, S = 257), the
builds taking turns ``--rounds`` times. A build with a part taken out
computes wrong values; only its times are read. Prints the card's name
and power limit, then one JSON line per build and shape. Needs an NVIDIA
GPU and nvcc; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke as cs  # noqa: E402
import torch_attention_shapes_bench as bench  # noqa: E402
from keep_tpu_torch.kernels import _build  # noqa: E402
from keep_tpu_torch.kernels import flash_attention as fa  # noqa: E402

DQ = "attention_qkv_slab_bwd_dq.cu"
DKV = "attention_qkv_slab_bwd_dkv.cu"
NO_EXP = "__device__ __forceinline__ float no_exp(float x) { return x; }\n"
LOAD_BIAS = "    load_bias(bj, bias, t * kTileKeys, S, lane);\n"
# build name → (source, text, its replacement): what the build changes
PARTS = {
    # kernel A's key bias loaded after the scores' wait, in the
    # elementwise work, in both passes
    "a_bias_after_wait": (DQ, LOAD_BIAS + "    wgmma_wait<1>();",
                          "    wgmma_wait<1>();\n" + LOAD_BIAS),
    # kernel A without the key bias's loads (zeros; the last tile's keys
    # past S still load)
    "a_no_bias_loads": (DQ, "bj[i] = __ldg(bias + j0 + 8 * (i >> 1) + "
                        "(i & 1));", "bj[i] = 0.f;"),
    # kernel A without its exponentials (expf(x) replaced by x)
    "a_no_exp": (DQ, "expf(", "no_exp("),
    # kernel A without dq's product (ds . K: a loop of no steps)
    "a_no_dq": (DQ, "for (int c = 0; c < 4; ++c) {  // 16 keys",
                "for (int c = 0; c < 0; ++c) {  // 16 keys"),
    # kernel B without its exponentials
    "b_no_exp": (DKV, "expf(", "no_exp("),
    # kernel B with constant statistics in place of their shared loads
    "b_no_stats": (DKV, "const float4 sq = sts[qc];",
                   "const float4 sq = make_float4(0.f, 1.f, 0.f, 0.f);"),
}
SHAPES = [("vit_l16", 32, 197, 16, 64, False),
          ("vit_l16", 128, 197, 16, 64, False),
          ("bert_base", 128, 256, 12, 64, True),
          ("keep_448", 32, 785, 16, 64, False),
          ("vit_e14", 32, 257, 16, 112, False)]


def sources(tmp: Path, name: str, part) -> Path:
    """A copy of the kernel sources with ``part``'s edit (none for the
    sources as written)."""
    csrc = tmp / name / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    if part is not None:
        f, old, new = part
        text = csrc.joinpath(f).read_text()
        if old not in text:
            raise SystemExit(f"{name}: the text to edit is not in {f}")
        text = text.replace(old, new)
        if "no_exp(" in new:
            text = text.replace("namespace {\n", "namespace {\n" + NO_EXP, 1)
        csrc.joinpath(f).write_text(text)
    return csrc


def build_all(dirs: dict[str, Path]) -> None:
    """Builds each copy's library in a process of its own, all at once."""
    code = ("import sys; from pathlib import Path; "
            "from keep_tpu_torch.kernels import _build; "
            "_build.CSRC = Path(sys.argv[1]); "
            "_build.BUILD_DIR = Path(sys.argv[1]).parent / 'build'; "
            "_build.library()")
    procs = {name: subprocess.Popen([sys.executable, "-c", code, str(d)],
                                    cwd=ROOT, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
             for name, d in dirs.items()}
    for name, p in procs.items():
        out = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"{name}: the build failed\n{out[-4000:]}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(cs.card(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = []
    for shape, b, s, h, dh, padded in SHAPES:
        qkv = torch.randn(b, s, 3 * h * dh, device="cuda",
                          generator=gen).bfloat16()
        do = torch.randn(b, s, h * dh, device="cuda", generator=gen).bfloat16()
        kb = torch.zeros(b, s, device="cuda")
        if padded:
            lens = torch.randint(8, s + 1, (b,), device="cuda", generator=gen)
            kb = (torch.arange(s, device="cuda")[None] >= lens[:, None]
                  ).float() * -1e9
        inputs.append((shape, b, s, h, dh, qkv, kb, do))
    with tempfile.TemporaryDirectory() as tmp:
        dirs = {name: sources(Path(tmp), name, part) for name, part in
                [("as_written", None), *PARTS.items()]}
        build_all(dirs)
        times: dict[tuple, list] = {}
        for _ in range(args.rounds):
            for name, csrc in dirs.items():
                _build.CSRC, _build.BUILD_DIR = csrc, csrc.parent / "build"
                _build._lib = None
                _build.library()
                for shape, b, s, h, dh, qkv, kb, do in inputs:
                    _, source, by_kernel = bench.device_kernels(
                        lambda: fa.attention_qkv_slab_bwd(qkv, kb, do, h), 10,
                        per_launch=2)
                    a = [v for k, v in by_kernel.items() if "dq_kernel" in k]
                    bb = [v for k, v in by_kernel.items() if "dkv_kernel" in k]
                    times.setdefault((name, shape, b, s, dh), []).append(
                        {"kernel_a_ms": a[0] if a else None,
                         "kernel_b_ms": bb[0] if bb else None,
                         "source": source})
    for (name, shape, b, s, dh), rounds in times.items():
        print(json.dumps({"build": name, "shape": shape, "B": b, "S": s,
                          "Dh": dh, "rounds": rounds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
