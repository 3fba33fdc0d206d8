#!/usr/bin/env python3
"""The exponentials' share of the bf16 attention kernels' time on the card.

    python3 scripts/torch_attention_exp_share.py

Builds the port's kernel sources three ways into temporary directories:
as written (``expf``), with ``__expf``, and with no exponential at all
(``expf(x)`` replaced by ``x``), and times the bf16 forward
(``attention_qkv_slab``) and backward (``attention_qkv_slab_bwd``) of each
build at ``chip_smoke.py``'s attention shapes with CUDA events, the builds
taking turns. The third build's values are wrong; only its times are read.
Prints the card's name and power limit, then one JSON line per build.
Needs an NVIDIA GPU and nvcc; imports no JAX.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import statistics
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from keep_tpu_torch.kernels import _build  # noqa: E402
from keep_tpu_torch.kernels import flash_attention as fa  # noqa: E402

ATTENTION_SOURCES = ("attention_qkv_slab.cu", "attention_qkv_slab_wgmma.cu",
                     "attention_qkv_slab_wgmma_streamed.cu",
                     "attention_qkv_slab_bwd.cu", "attention_qkv_slab_bwd_dq.cu",
                     "attention_qkv_slab_bwd_dkv.cu", "slab_attention.cuh")
NO_EXP = "__device__ __forceinline__ float no_exp(float x) { return x; }\n"
# build name → what replaces "expf(" in the attention sources
BUILDS = {"expf": None, "__expf": "__expf(", "none": "no_exp("}
SOURCES = _build.CSRC  # every build starts from the sources as written
ROUNDS = 7


def build(tmp: str, name: str, repl: str | None) -> ctypes.CDLL:
    """The kernel library built from the sources with "expf(" replaced by
    ``repl`` in the attention sources (as written for None)."""
    csrc = Path(tmp, name, "csrc")
    shutil.copytree(SOURCES, csrc)
    for f in ATTENTION_SOURCES if repl else ():
        text = csrc.joinpath(f).read_text().replace("expf(", repl)
        if f.endswith(".cuh"):
            text = text.replace("namespace {\n", "namespace {\n" + NO_EXP, 1)
        csrc.joinpath(f).write_text(text)
    _build.CSRC, _build.BUILD_DIR = csrc, csrc.parent / "build"
    _build._lib = None
    return _build.library()


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(cs.card(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = []
    for shape, b, s, h, _ in cs.ATTENTION_SHAPES:
        qkv = torch.randn(b, s, 3 * h * 64, device="cuda",
                          generator=gen).bfloat16()
        do = torch.randn(b, s, h * 64, device="cuda", generator=gen).bfloat16()
        inputs.append((shape, b, h, qkv, do, torch.zeros(b, s, device="cuda")))
    with tempfile.TemporaryDirectory() as tmp:
        libs = {name: build(tmp, name, repl) for name, repl in BUILDS.items()}
        # the builds take turns, ROUNDS times, so that clock and power
        # drift reach all three alike; each time is the median of 25 calls
        times = {name: [] for name in BUILDS}
        for _ in range(ROUNDS):
            for name, lib in libs.items():
                _build._lib = lib
                times[name].append([
                    (cs.cuda_ms(lambda: fa.attention_qkv_slab(
                        qkv, kb, num_heads=h)),
                     cs.cuda_ms(lambda: fa.attention_qkv_slab_bwd(
                        qkv, kb, do, h)))
                    for _, _, h, qkv, do, kb in inputs])
    for name, rounds in times.items():
        rows = [{"shape": shape, "B": b,
                 "fwd_ms": statistics.median(r[i][0] for r in rounds),
                 "bwd_ms": statistics.median(r[i][1] for r in rounds)}
                for i, (shape, b, *_) in enumerate(inputs)]
        print(json.dumps({"build": name, "rounds": ROUNDS, "rows": rows}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
