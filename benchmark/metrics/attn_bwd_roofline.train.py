"""``attn_bwd_roofline.train``: #1b as a share of its roofline: the summed
bound of the window's backward attention calls (four S²·Dh products a
head; q, k, v and dout read, dq, dk, dv written; ``flops.attention_bound_s``)
over the device seconds of #1b's kernels in the trace."""

from benchmark import flops

NAMES = ("slab_attention_bwd",)


def read(cell, outcome):
    trace = outcome.trace
    dev_s = trace.device_s(*NAMES) if trace else 0.0
    steps = outcome.work.get("steps", 0)
    if dev_s <= 0 or not steps:
        return None
    calls = flops.train_attention_bwd_calls(cell.config["model"],
                                            cell.traffic["batch_size"])
    bound = steps * sum(flops.attention_bound_s(
        c["b"], c["s"], c["h"], c["dh"], 2, key_bias=c["key_bias"],
        backward=True) for c in calls)
    return 100.0 * bound / dev_s
