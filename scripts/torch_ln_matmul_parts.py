#!/usr/bin/env python3
"""Where the time of the port's bf16 ``ln_matmul`` kernel goes, on one
NVIDIA GPU: the kernel as built, and copies of it with a part taken out.

    python3 scripts/torch_ln_matmul_parts.py [--batch 32 128]

Builds ``keep_tpu_torch/kernels/csrc/ln_matmul.cu`` four times into a
temporary directory (one ``nvcc`` each, all started together): as it is;
without the normalisation (the A fragments go to the tensor cores as
``ldmatrix`` read them, raw x); without the epilogue (no output is written); and
without both, which leaves the TMA ring and the products. The copies are
made by replacing two statements of the source text, so the script fails
loudly if the source no longer has them; their outputs are wrong by
design and only the full build is checked against the plain version. For
each batch B and N in (3072, 4096) (ViT-L/16 qkv and fc1: M = 197·B, K =
1024, the operands of ``torch_ln_matmul_bench.py``) it prints one JSON
line: each build's device ms from ``torch.profiler`` (the statistics pass
and the GEMM apart), beside the bound. Prints the card's name and power
limit first. Needs an NVIDIA GPU and nvcc; imports no JAX. Run it from the
repository's root with ``PYTHONPATH=.``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import tempfile
from pathlib import Path

import torch

from scripts.torch_ln_matmul_bench import (bound_ms, device_ms_by_kernel,
                                           operands)

# the statement each part's copy replaces, and what replaces it
NO_NORM = ("float2 g, float2 b) {\n", "float2 g, float2 b) {\n  return v;\n")
NO_EPILOGUE = ("for (int pass = 0; pass < BN / kBoxCols; ++pass) {",
               "for (int pass = 0; pass < 0; ++pass) {")
BUILDS = {"full": [], "no_normalisation": [NO_NORM],
          "no_epilogue": [NO_EPILOGUE],
          "products_only": [NO_NORM, NO_EPILOGUE]}


def build_all(work: Path) -> dict[str, ctypes.CDLL]:
    from keep_tpu_torch.kernels import _build

    source = (_build.CSRC / "ln_matmul.cu").read_text()
    nvcc = _build._nvcc()
    procs = {}
    for name, patches in BUILDS.items():
        text = source
        for old, new in patches:
            if text.count(old) != 1:
                raise RuntimeError(f"ln_matmul.cu no longer has one '{old}'")
            text = text.replace(old, new)
        src = work / f"ln_matmul_{name}.cu"
        src.write_text(text)
        lib = work / f"ln_matmul_{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared",
             "-o", str(lib), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        libs[name] = ctypes.CDLL(str(lib))
        fn = libs[name].keep_ln_matmul
        fn.argtypes = _build.SIGNATURES["keep_ln_matmul"]
        fn.restype = ctypes.c_int
    return libs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[32, 128])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    from keep_tpu_torch.kernels import _kops
    from keep_tpu_torch.kernels import ln_matmul as lm

    gen = torch.Generator(device="cuda").manual_seed(0)
    with tempfile.TemporaryDirectory() as d:
        libs = build_all(Path(d))
        for batch in args.batch:
            for n in (3072, 4096):
                m, k = 197 * batch, 1024
                x, g, b, w, bias = operands(m, n, gen, k)
                stats = torch.empty(m, 2, device="cuda")
                out = torch.empty(m, n, device="cuda", dtype=torch.bfloat16)
                row = {"B": batch, "M": m, "K": k, "N": n,
                       "bound_ms": bound_ms(m, k, n)[0]}
                for name, lib in libs.items():
                    def call(lib=lib):
                        _kops._raise_on(lib.keep_ln_matmul(
                            x.data_ptr(), g.data_ptr(), b.data_ptr(), 1e-6,
                            w.data_ptr(), bias.data_ptr(), stats.data_ptr(),
                            out.data_ptr(), 1, 1, m, n, k, _kops._stream(x)),
                            name)
                    by_kernel = device_ms_by_kernel(call)
                    row[f"{name}_gemm_ms"] = sum(
                        v for kk, v in by_kernel.items() if "ln_stats" not in kk)
                    row[f"{name}_stats_ms"] = sum(
                        v for kk, v in by_kernel.items() if "ln_stats" in kk)
                    if name == "full":
                        ref = lm.ln_matmul_reference(x, g, b, w, bias, 1e-6)
                        call()
                        torch.cuda.synchronize()
                        if not torch.allclose(out.float(), ref.float(),
                                              atol=1e-2, rtol=2 ** -7):
                            raise AssertionError("ln_matmul vs plain")
                print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
