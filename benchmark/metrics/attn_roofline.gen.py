"""The least time of every transformer attention of the traced request
(q/k/v projections, heads and out-projection; ``flops.attention_bound``)
over the device time of the kernels launched inside the benchmark's ranges
around those attention calls."""


def read(record):
    t = record.get("trace_host")
    bound = record.get("attention_bound_s")
    spent = t and t["ranges"].get("attn")
    if not spent or bound is None:
        return None
    return 100.0 * bound / spent
