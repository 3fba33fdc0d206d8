"""The knee of a serving cell, found once by a sweep on the card when the
cell is defined (its rate is then fixed in the cell's traffic file):

    python3 benchmark/sweep.py --workload <cell> --seed <n> --seconds <s> \
        --rates 50 100 150 ...

One server, one window a rate; one JSON line a rate. The benchmark's own
runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    bench = harness.load_benchmark(ROOT)
    cell = harness.make_cell(bench, args.workload, seed=args.seed,
                             seconds=args.seconds, trace=False)
    for row in harness.driver(cell).sweep(cell, args.rates):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
