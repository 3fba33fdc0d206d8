"""The traced run's device timeline: ``torch.profiler`` over the window, read
back from its Chrome trace.

``Trace.kernels`` holds every device operation (kernels, copies, sets) as
(name, start, end) in seconds; ``Trace.spans`` the benchmark's own host
spans (``span``: ``record_function`` around its calls into each layer of
the program) as (name, start, end). The two share the profiler's clock.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch

SPAN_PREFIX = "bench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def span(name: str):
    """A host span of the benchmark, named ``bench.<name>`` in the trace;
    costs a few microseconds, and nothing reads it in an untraced run."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


@dataclass
class Trace:
    window_s: float = 0.0
    kernels: list = field(default_factory=list)  # (name, start_s, end_s)
    spans: list = field(default_factory=list)    # (name, start_s, end_s)

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device: the union of
        the device intervals."""
        return sum(e - s for s, e in merged(self.kernels))

    def device_s(self, *needles: str) -> float:
        """Summed device seconds of the operations whose name holds any of
        ``needles``."""
        return sum(e - s for n, s, e in self.kernels
                   if any(k in n for k in needles))

    def count(self, *needles: str) -> int:
        return sum(1 for n, _, _ in self.kernels
                   if any(k in n for k in needles))

    def top_ops(self, n: int = 10) -> list:
        by: dict[str, float] = {}
        for name, s, e in self.kernels:
            by[name[:120]] = by.get(name[:120], 0.0) + (e - s)
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """The ``n`` longest gaps between device operations, each named by
        the innermost benchmark span open at the gap's middle."""
        ivs = merged(self.kernels)
        gaps = [(ivs[i][1], ivs[i + 1][0]) for i in range(len(ivs) - 1)]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:n]:
            mid = 0.5 * (s + e)
            open_ = [sp for sp in self.spans if sp[1] <= mid <= sp[2]]
            name = (min(open_, key=lambda sp: sp[2] - sp[1])[0] if open_
                    else "outside the benchmark's spans")
            out.append([name, e - s])
        return out


def merged(kernels: list) -> list:
    ivs = sorted((s, e) for _, s, e in kernels)
    out: list = []
    for s, e in ivs:
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def read_chrome_trace(path: str) -> Trace:
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    t = Trace()
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        s = float(ev["ts"]) * 1e-6
        e = s + float(ev["dur"]) * 1e-6
        cat, name = ev.get("cat", ""), ev.get("name", "")
        if cat in DEVICE_CATS:
            t.kernels.append((name, s, e))
        elif name.startswith(SPAN_PREFIX) and cat == "user_annotation":
            t.spans.append((name[len(SPAN_PREFIX):], s, e))
    return t


@contextmanager
def traced(enabled: bool):
    """Profiles the block when ``enabled`` and yields the ``Trace`` it fills
    when the block ends (an empty one otherwise). The Chrome trace is
    written under the run's temporary directory and removed once read."""
    out = Trace()
    if not enabled:
        yield out
        return
    from torch.profiler import ProfilerActivity, profile

    tmp = tempfile.mkdtemp(prefix="bench_trace_")
    try:
        cuda = torch.cuda.is_available()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        with profile(activities=acts) as prof:
            yield out
            if cuda:
                torch.cuda.synchronize()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        got = read_chrome_trace(path)
        out.kernels, out.spans = got.kernels, got.spans
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
