"""`moe_route` (csrc/moe_route.cu, the DeepSeek-V3 router): the router's
weight and the rows' bytes (and the ids, weights and log it writes) over
its device time in the traced window, against 3.35 TB/s."""

from port_bench.lib import costs

KERNEL = {"module": "turbo_whisper_workspace_tpu_torch.ops.moe_ops",
          "wrapper": "moe_route", "trace": "moe_route_kernel"}


def cost(h, w, bias, shared, top_k, *_, **__):
    rows, d = h.shape
    e = w.shape[0]
    out = rows * (top_k + shared.shape[0])
    ops = 2.0 * rows * d * e
    nbytes = 2.0 * (e * d + rows * d) + 4.0 * e + 12.0 * out + 4.0 * rows * top_k
    return ops, nbytes, costs.bound_s(ops, nbytes)


def read(run):
    return run.roofline(KERNEL)
