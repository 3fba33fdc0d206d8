"""Small cells for the benchmark's CPU tests: the real files of a cell with
the model cut to a few narrow layers and the traffic to a few tiles, run on
the CPU through the same driver (the program's kernels take their plain
versions on CPU tensors)."""

from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402


def shrink(cell, *, width: int = 128, depth: int = 2, heads: int = 2):
    m = cell.config["model"]
    m["vision"].update(embed_dim=width, depth=depth, num_heads=heads)
    m["text"].update(hidden_size=32, num_hidden_layers=1,
                     num_attention_heads=1, intermediate_size=128,
                     vocab_size=1000, max_position_embeddings=64)
    m["projection_dim"] = 32
    m["max_text_length"] = 64
    cell.traffic.update(pool=8, batch_size=4, rows_per_block=4,
                        trace_seconds=0.3)
    return cell


def small_cell(workload: str, seed: int = 7, seconds: float = 0.3,
               trace: bool = False, root: Path = ROOT, **kw):
    """A cell of ``BENCHMARK.json``, or one that its files make up by name
    (``<config>.<traffic>``, with ``limits/<name>.json``) though
    ``BENCHMARK.json`` does not list it yet."""
    bench = harness.load_json(root / "BENCHMARK.json")
    if workload not in {w["name"] for w in bench["workloads"]}:
        config, traffic = workload.split(".", 1)
        bench = dict(bench, workloads=[{"name": workload, "config": config,
                                        "traffic": traffic, "chips": 1}],
                     configs=bench["configs"])
    cell = harness.make_cell(bench, workload, seed=seed, seconds=seconds,
                             trace=trace, device="cpu",
                             t_start=time.perf_counter())
    return bench, shrink(cell, **kw)


def run(cell):
    out = harness.Outcome()
    harness.driver(cell).run(cell, out)
    return out
