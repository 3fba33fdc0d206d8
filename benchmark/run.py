"""Runs one cell of the benchmark once on the card and prints its result as
the last line of standard output.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics, read from a profiled window.
Without a CUDA device, with fewer devices than the cell asks for, or on a
card that does not answer a short probe, the run fails at once: it never
falls back to the CPU.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

PROBE_SECONDS = 60.0


def fail(code: int, why: str):
    print(f"benchmark: {why}", file=sys.stderr, flush=True)
    sys.exit(code)


def probe_card(torch) -> None:
    """A small product on the card, waited for with a deadline: a card that
    does not answer fails the run instead of hanging it."""
    done = threading.Event()

    def work():
        x = torch.ones(256, 256, device="cuda")
        (x @ x).sum().item()
        done.set()

    threading.Thread(target=work, daemon=True).start()
    if not done.wait(PROBE_SECONDS):
        print(f"benchmark: the card did not answer a probe within "
              f"{PROBE_SECONDS:.0f} s", file=sys.stderr, flush=True)
        os._exit(3)


def cache_dirs() -> None:
    """Kernel caches inside the checkout, at fixed paths, so that only the
    first run in a checkout builds (the program's own nvcc build already
    lands in ``keep_tpu_torch/kernels/build/``)."""
    cache = ROOT / "benchmark" / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def check_traced_launches(outcome) -> None:
    """The trace must hold every launch the program counted over the window
    (the profiler has been seen to drop a call's kernels)."""
    from benchmark.program import TRACE_NAMES

    for name, counted in outcome.launches.items():
        seen = outcome.trace.count(*TRACE_NAMES[name])
        if counted and seen < counted:
            fail(5, f"the trace holds {seen} {name} kernels, the program "
                    f"counted {counted} launches over the window")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import harness

    bench = harness.load_benchmark(ROOT)
    cell = harness.make_cell(bench, args.workload,
                             seed=args.seed % (1 << 63), seconds=args.seconds,
                             trace=bool(args.trace), t_start=T_START)
    cache_dirs()
    import torch

    chips = cell.workload["chips"]
    if not torch.cuda.is_available():
        fail(2, "no CUDA device: the benchmark measures the card only")
    if torch.cuda.device_count() < chips:
        fail(2, f"the cell asks for {chips} devices, "
                f"{torch.cuda.device_count()} present")
    probe_card(torch)

    outcome = harness.Outcome()
    harness.driver(cell).run(cell, outcome)

    found = harness.forbidden_modules()
    if found:
        fail(4, f"modules of JAX or the JAX package loaded: {found}")
    if cell.trace:
        check_traced_launches(outcome)
        metrics = harness.read_per_layer(bench, cell, outcome)
    else:
        units = {m["name"]: m["unit"]
                 for m in harness.cell_end_to_end(bench, cell)}
        metrics = {k: {"value": v, "unit": units[k]}
                   for k, v in outcome.e2e.items() if k in units}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": outcome.memory_peak_bytes}
    result = {"correct": outcome.correct, "attempted": outcome.attempted,
              "failed": outcome.failed, "metrics": metrics, "device": device}
    if cell.trace:
        device["busy_s"] = outcome.trace.busy_s()
        device["window_s"] = outcome.trace.window_s
        result["breakdown"] = {"device_ops": outcome.trace.top_ops(),
                               "idle_gaps": outcome.trace.idle_gaps()}
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in outcome.checks}
    for c in outcome.checks:
        print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
