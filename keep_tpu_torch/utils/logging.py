"""Logging setup, a running-average meter and the results.jsonl history
(counterpart of ``keep_tpu/utils/logging.py``)."""

from __future__ import annotations

import json
import logging
import os
import sys


def setup_logging(log_file: str | None = None,
                  level: int = logging.INFO) -> None:
    """Root logger to stderr and, with ``log_file``, to that file; handlers
    of an earlier call are closed and replaced."""
    formatter = logging.Formatter("%(asctime)s | %(levelname)s | %(message)s",
                                  datefmt="%Y-%m-%d,%H:%M:%S")
    root = logging.getLogger()
    root.setLevel(level)
    for h in list(root.handlers):
        root.removeHandler(h)
        h.close()
    stream = logging.StreamHandler(sys.stderr)
    stream.setFormatter(formatter)
    root.addHandler(stream)
    if log_file:
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(formatter)
        root.addHandler(fh)


class AverageMeter:
    """Running average."""

    def __init__(self):
        self.val = self.avg = self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


def append_results(path: str, record: dict) -> None:
    """Appends one record to a JSONL file."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(record, default=float) + "\n")
