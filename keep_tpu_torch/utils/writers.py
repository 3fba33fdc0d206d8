"""Metric writer: results to ``metrics.jsonl`` (counterpart of
``keep_tpu/utils/writers.py`` without its TensorBoard and wandb fan-out,
which are not ported: a ``wandb_project`` is logged and ignored)."""

from __future__ import annotations

import logging
import os

from keep_tpu_torch.utils.logging import append_results


class MetricWriter:
    def __init__(self, out_dir: str, jsonl_name: str = "metrics.jsonl",
                 wandb_project: str | None = None):
        self._jsonl = os.path.join(out_dir, jsonl_name)
        if wandb_project:
            logging.warning("wandb_project=%r: wandb is not ported; metrics "
                            "go to %s only", wandb_project, self._jsonl)

    def write(self, step: int, metrics: dict) -> None:
        append_results(self._jsonl, {"step": step, **metrics})

    def close(self) -> None:
        pass
