"""``mfu.extract``: the share of the card's peak that the window's returned
tiles needed, each GEMM and attention product timed at its own route's
published peak (bf16 989 TFLOP/s; the int8 configuration's GEMMs at 1,979
TOP/s), over the window's host seconds. The device resize and the
elementwise work are not counted."""

from benchmark import flops


def read(cell, outcome):
    tiles = outcome.work.get("tiles", 0)
    if not tiles or outcome.window_s <= 0:
        return None
    int8 = cell.config["precision"] == "int8"
    ideal = flops.image_ideal_s(cell.config["model"], tiles, int8)
    return 100.0 * ideal / outcome.window_s
