"""``idle.extract``: the share of the traced window in which no operation
ran on the device (1 − the union of the device intervals over the window)."""


def read(cell, outcome):
    trace = outcome.trace
    if not trace or not trace.kernels or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
