"""``int8_gemm_roofline.extract``: ``int8_gemm`` as a share of its roofline:
the summed bound of the window's int8 GEMMs, operations at 1,979 TOP/s or
bytes at 3.35 TB/s, whichever is larger for each (``flops.int8_gemm_bound_s``
over the image tower's and the head's shapes), over the device seconds of
``int8_gemm_kernel`` in the trace."""

from benchmark import flops
from benchmark.program import TRACE_NAMES


def read(cell, outcome):
    trace = outcome.trace
    dev_s = trace.device_s(*TRACE_NAMES["int8_gemm"]) if trace else 0.0
    batches = outcome.work.get("batches", 0)
    if dev_s <= 0 or not batches:
        return None
    gemms = flops.image_gemms(cell.config["model"], cell.traffic["batch_size"])
    bound = batches * sum(flops.int8_gemm_bound_s(g) for g in gemms)
    return 100.0 * bound / dev_s
