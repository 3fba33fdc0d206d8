"""Host time of the int8 matmul wrappers (#8 ``quantized_matmul_bsd``, #9
``quantized_matmul``) and the served bf16 / int8 throughput at bucket 128,
for holding two checkouts of the port against each other on one card.

    PYTHONPATH=<checkout root> python <this file> [--label NAME]

Everything it runs comes from the checkout on ``PYTHONPATH`` (its
``keep_tpu_torch`` and its ``chip_smoke.py``), so one call on the card can
time a parent and a change in turns (parent, change, change, parent). It
prints one JSON line: the card and its power limit, each wrapper's host
µs a call (the mean enqueue time of 200 calls, the card left to run
behind them) and its CUDA-event ms, and ``chip_smoke.throughput``'s
tiles/s and prompts/s for a full-width random-weight KEEP served in bf16
and with ``--int8``.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time

import numpy as np
import torch


def host_us(fn, calls: int = 200) -> float:
    """Mean host time of one call, after a warm-up and a synchronise: what
    the wrapper costs the thread that enqueues it."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    import chip_smoke as cs
    from keep_tpu_torch import serve
    from keep_tpu_torch.configs import KEEPConfig
    from keep_tpu_torch.kernels import _build, qmatmul

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.library()
    g = torch.Generator(device="cuda").manual_seed(0)

    def r(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g, device="cuda").to(dtype)

    def i8(n, k):
        return torch.randint(-127, 128, (n, k), generator=g, device="cuda",
                             dtype=torch.int8)

    x8, w8, s8, b8 = (r(32, 196, 768, dtype=torch.bfloat16), i8(1024, 768),
                      r(1024).abs(), r(1024))
    x9, w9, s9, b9 = (r(32, 1024, dtype=torch.bfloat16), i8(768, 1024),
                      r(768).abs(), r(768))
    calls = {
        "quantized_matmul_bsd [32,196,768]->1024":
            lambda: qmatmul.quantized_matmul_bsd(x8, w8, s8, b8),
        "quantized_matmul [32,1024]->768":
            lambda: qmatmul.quantized_matmul(x9, w9, s9, b9)}
    wrappers = {name: {"host_us": host_us(fn), "event_ms": cs.cuda_ms(fn)}
                for name, fn in calls.items()}
    cfg = KEEPConfig()
    served = {}
    with tempfile.TemporaryDirectory() as d:
        cs.write_model(d, torch, cfg)
        for tag, extra in (("bf16", []), ("int8", ["--int8"])):
            core, httpd = serve.build_server(
                ["--model-dir", d, "--port", "0"] + extra)
            httpd.server_close()
            try:
                t = cs.throughput(torch, core, np.random.default_rng(1),
                                  int8=bool(extra))
            finally:
                core.stop()
            served[tag] = {k: t[k] for k in (
                "image_tiles_per_s_bucket128",
                "text_prompts_per_s_bucket128x256")}
            del core
            torch.cuda.empty_cache()
    print(json.dumps({"label": args.label, "card": cs.card(),
                      "torch": torch.__version__, "wrappers": wrappers,
                      "served": served}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
