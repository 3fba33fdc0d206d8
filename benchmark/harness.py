"""The general part of the benchmark: it finds a cell's configuration, traffic
mix, limits, driver and per-layer readers by name (``run.py`` runs them and
prints the result line). Nothing in it names a cell.

Layout, all under this folder:

- ``configs/<config>.json``: the model as it is run (``model``), its
  precision path and its source.
- ``traffic/<traffic>.json``: one traffic mix's parameters; its ``driver``
  names the generator in ``drivers/<driver>.py`` that reads them.
- ``limits/<workload>.json``: each number the cell's output check compares,
  with its limit and the readings it was set from.
- ``metrics/<metric>.py``: one reader per per-layer metric, ``read(cell,
  outcome)`` → a number, or None when the run has nothing to read.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "keep_tpu")


@dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    t_start: float = 0.0  # the process's start, perf_counter seconds

    @property
    def name(self) -> str:
        return self.workload["name"]


@dataclass
class Outcome:
    """What a driver hands back: its end-to-end readings, the work it did,
    the output check, and (traced) the device timeline and the launch
    counts over the window."""

    e2e: dict = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    work: dict = field(default_factory=dict)
    checks: list = field(default_factory=list)  # dicts: name, value, limit
    memory_peak_bytes: int = 0
    window_s: float = 0.0
    trace: object = None
    launches: dict = field(default_factory=dict)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c["value"] <= c["limit"]
                                         for c in self.checks)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path) -> dict:
    return load_json(root / "BENCHMARK.json")


def make_cell(bench: dict, workload: str, *, seed: int, seconds: float,
              trace: bool, device: str = "cuda",
              t_start: float = 0.0) -> Cell:
    by_name = {w["name"]: w for w in bench["workloads"]}
    if workload not in by_name:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has "
                         f"{sorted(by_name)}")
    w = by_name[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(workload=w, config=load_json(HERE.parent / conf["file"]),
                traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(HERE / "limits" / f"{workload}.json"),
                seed=seed, seconds=seconds, trace=trace, device=device,
                t_start=t_start)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(cell: Cell):
    return load_module(HERE / "drivers" / f"{cell.traffic['driver']}.py",
                       f"bench_driver_{cell.traffic['driver']}")


def per_layer_metrics(bench: dict, cell: Cell) -> list[dict]:
    """The per-layer metrics this cell reports: those that list it, and
    those without a list that move an end-to-end metric it reports."""
    mine = {m["name"] for m in cell_end_to_end(bench, cell)}
    return [m for m in bench["per_layer"]
            if (cell.name in m["workloads"] if "workloads" in m
                else m["moves"] in mine)]


def cell_end_to_end(bench: dict, cell: Cell) -> list[dict]:
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell.name in m["workloads"]]


def read_per_layer(bench: dict, cell: Cell, outcome: Outcome) -> dict:
    out = {}
    for m in per_layer_metrics(bench, cell):
        mod = load_module(HERE / "metrics" / f"{m['name']}.py",
                          "bench_metric_" + m["name"].replace(".", "_"))
        v = mod.read(cell, outcome)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (``keep_tpu_torch`` is not ``keep_tpu``)."""
    return sorted({n.split(".")[0] for n in list(sys.modules)
                   if n.split(".")[0] in FORBIDDEN})
