"""``mfu.train``: the window's samples times the forward and backward
operations of a sample (three times the forward of both towers, remat's
recompute not counted) over the window's host seconds, at the bf16 peak
(989 TFLOP/s)."""

from benchmark import flops


def read(cell, outcome):
    samples = outcome.work.get("samples", 0)
    if not samples or outcome.window_s <= 0:
        return None
    ops = flops.train_flops(cell.config["model"], samples)
    return 100.0 * ops / flops.PEAK["bf16"] / outcome.window_s
