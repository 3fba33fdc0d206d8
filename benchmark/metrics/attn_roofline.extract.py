"""``attn_roofline.extract``: the image tower's attention (#1, and the
attention inside #4 on the int8 path: bf16 in, fp32 out) as a share of its
roofline: the summed bound of the window's calls (``flops.attention_bound_s``)
over the device seconds of the attention kernels in the trace."""

from benchmark import flops
from benchmark.program import TRACE_NAMES


def read(cell, outcome):
    trace = outcome.trace
    dev_s = trace.device_s(*TRACE_NAMES["attention"]) if trace else 0.0
    batches = outcome.work.get("batches", 0)
    if dev_s <= 0 or not batches:
        return None
    out_bytes = 4 if cell.config["precision"] == "int8" else 2
    calls = flops.image_attention_calls(cell.config["model"],
                                        cell.traffic["batch_size"])
    bound = batches * sum(flops.attention_bound_s(
        c["b"], c["s"], c["h"], c["dh"], 2, out_bytes) for c in calls)
    return 100.0 * bound / dev_s
