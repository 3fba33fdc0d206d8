"""Readings that set a cell's output limits, on the card at the cell's own
size: the program's numbers over many seeds (the lower readings), its
control's over a few (one precision below the configuration's: see each
driver's ``control_reading``), and each fault a driver can plant in the
program (its ``FAULTS``).

    python3 benchmark/control.py --workload <cell> --seeds 1 2 ... \
        [--control-seeds 1 2 3] [--fault-seeds 1 2 3] [--seconds 2]

Each reading is printed as one JSON line. The benchmark's own runs do not
run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    bench = harness.load_benchmark(ROOT)

    def cell(seed):
        return harness.make_cell(bench, args.workload, seed=seed,
                                 seconds=args.seconds, trace=False)

    drv = harness.driver(cell(0))
    jobs = ([("program", s, drv.program_reading) for s in args.seeds]
            + [("control", s, drv.control_reading)
               for s in args.control_seeds]
            + [(f"fault:{f}", s, lambda c, f=f: drv.fault_reading(c, f))
               for f in drv.FAULTS for s in args.fault_seeds])
    for kind, seed, fn in jobs:
        t0 = time.perf_counter()
        got = fn(cell(seed))
        print(json.dumps({"workload": args.workload, "kind": kind,
                          "seed": seed, **got,
                          "s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
