"""The world-1 NCCL training step against the one-process step on one card:
``chip_smoke.py``'s phase 24a alone (and, with ``--gloo``, 24b: phase
26's dp case, two gloo ranks on the card).

    python scripts/torch_dp_step_bench.py [--steps 7] [--turns 2] [--gloo]
        [--host-lines]

``train.main`` at ``keep_train.yml``'s values (full width and depth,
batch 128, amp_bf16, both towers open) runs ``--turns`` times in one
process and ``--turns`` times under a torchrun-style world-1 NCCL group,
in turns, ``--steps`` steps each. It prints the card and its power limit,
then ``chip_smoke``'s ``dp_train_nccl_world1`` line: ms a step (the first
of each run left out), the NCCL step's ms less the one-process step's,
step for step, the two runs' losses and parameters bit for bit, the
gradient all-reduce's CUDA-event ms, and, for the second step of the
last turn traced with torch.profiler, each one's device ms and the
kernels whose time differs most between the two. With ``--host-lines`` each step also gets a line ``dp_step_host``:
the host ms until the step returned (before it is waited for), the host
ms in the gradient all-reduce, the CUDA memory segments it allocated and
freed, the allocator's retries, and the ms the Python garbage collector
ran.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


@contextlib.contextmanager
def step_host_lines(torch, tmain):
    """Prints one ``dp_step_host`` line per training step of the block."""
    from keep_tpu_torch.parallel import multihost
    from keep_tpu_torch.train import trainer

    reduce, make = trainer.all_reduce_grads, tmain.make_train_step
    cur = {"reduce_ms": 0.0, "gc_ms": 0.0}
    gc_t0 = [0.0]

    def timed_reduce(*a, **k):
        t0 = time.perf_counter()
        try:
            return reduce(*a, **k)
        finally:
            cur["reduce_ms"] += (time.perf_counter() - t0) * 1e3

    def on_gc(phase, info):
        if phase == "start":
            gc_t0[0] = time.perf_counter()
        else:
            cur["gc_ms"] += (time.perf_counter() - gc_t0[0]) * 1e3

    def build(*a, **k):
        step = make(*a, **k)
        index = [0]

        def run(*sa, **sk):
            cur.update(reduce_ms=0.0, gc_ms=0.0)
            m0 = torch.cuda.memory_stats()
            t0 = time.perf_counter()
            out = step(*sa, **sk)
            host_ms = (time.perf_counter() - t0) * 1e3
            m1 = torch.cuda.memory_stats()
            print(json.dumps({
                "phase": "dp_step_host",
                "world": multihost.process_count(),
                "nccl": torch.distributed.is_initialized(),
                "step": index[0], "host_ms_to_return": host_ms,
                "allreduce_host_ms": cur["reduce_ms"],
                "gc_ms": cur["gc_ms"],
                "segments_allocated": m1.get("segment.all.allocated", 0)
                - m0.get("segment.all.allocated", 0),
                "segments_freed": m1.get("segment.all.freed", 0)
                - m0.get("segment.all.freed", 0),
                "alloc_retries": m1.get("num_alloc_retries", 0)
                - m0.get("num_alloc_retries", 0)}), flush=True)
            index[0] += 1
            return out
        return run

    trainer.all_reduce_grads = timed_reduce
    tmain.make_train_step = build
    gc.callbacks.append(on_gc)
    try:
        yield
    finally:
        gc.callbacks.remove(on_gc)
        trainer.all_reduce_grads, tmain.make_train_step = reduce, make


def main() -> int:
    import torch

    import chip_smoke as cs
    from keep_tpu_torch.configs import KEEPConfig
    from keep_tpu_torch.kernels import _build
    from keep_tpu_torch.kernels import flash_attention as fa
    from keep_tpu_torch.train import main as tmain

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=cs.DP_STEPS)
    ap.add_argument("--turns", type=int, default=cs.DP_TURNS)
    ap.add_argument("--gloo", action="store_true",
                    help="also run 24b (two gloo ranks on the card)")
    ap.add_argument("--host-lines", action="store_true",
                    help="print a dp_step_host line for every step")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs.card(), flush=True)
    _build.library()
    cfg = KEEPConfig()
    blocks = cfg.vision.depth + cfg.text.num_hidden_layers
    lines = (step_host_lines(torch, tmain) if args.host_lines
             else contextlib.nullcontext())
    with tempfile.TemporaryDirectory() as d, lines:
        cs.drive_dp_train(torch, fa, d, blocks, steps=args.steps,
                          turns=args.turns)
    if args.gloo:
        with tempfile.TemporaryDirectory() as d:
            cs.drive_dp2_layouts(torch, fa, d, layouts={"dp": ({}, 2)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
