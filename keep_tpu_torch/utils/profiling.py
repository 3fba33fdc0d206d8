"""Profiling / tracing hooks (counterpart of ``keep_tpu/utils/profiling.py``).

``trace(log_dir)`` captures a host + device profile with ``torch.profiler``
(CPU activity, plus CUDA on the card) and writes it to ``log_dir`` as a
Chrome trace (open it in Perfetto or ``chrome://tracing``); the kernels it
names are the hand-written ones (``keep_attention``, ``int8_gemm``, ...) and
the library's. ``ThroughputMeter`` gives samples/s over a sliding window,
as the reference's samples/s logs (train_hierarchy.py:216-223).

The JAX module's ``enable_hlo_dump`` sets an XLA flag; the port has no XLA
compiler to ask, and its counterpart (what the card's compiler made of a
kernel) waits with ``utils/compile.py`` (ROADMAP queue 1, item 12).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator["torch.profiler.profile"]:
    """Profile the block into ``log_dir/trace.json`` (a Chrome trace):
    host activity, and the card's kernels where a card is present. Yields
    the profiler, whose ``key_averages()`` sums the time by name."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


class ThroughputMeter:
    """samples/s and samples/s/device over a sliding window."""

    def __init__(self, window: int = 50):
        self.window = window
        self._events: list[tuple[float, int]] = []

    def update(self, n_samples: int) -> None:
        # monotonic: immune to NTP steps/slew over multi-day runs
        self._events.append((time.monotonic(), n_samples))
        if len(self._events) > self.window:
            self._events.pop(0)

    @property
    def samples_per_sec(self) -> float:
        if len(self._events) < 2:
            return 0.0
        dt = self._events[-1][0] - self._events[0][0]
        n = sum(c for _, c in self._events[1:])
        return n / dt if dt > 0 else 0.0

    def per_device(self, n_devices: Optional[int] = None) -> float:
        """``samples_per_sec`` over ``n_devices`` (default: the CUDA
        devices this process sees, at least one)."""
        if n_devices is None:
            n_devices = torch.cuda.device_count()
        return self.samples_per_sec / max(n_devices, 1)
