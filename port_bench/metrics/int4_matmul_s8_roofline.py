"""`int4_matmul_s8` (csrc/int4_matmul_s8.cu, the W4A8 decode step's
projections): int4 weight, scale and activation bytes over its device
time in the traced window, against 3.35 TB/s."""

from port_bench.lib import costs

KERNEL = {"module": "turbo_whisper_workspace_tpu_torch.ops.quant",
          "wrapper": "int4_matmul_s8", "trace": "int4_matmul_s8_kernel"}


def cost(xq, xs, w_q4, scale4, *_, **__):
    m, k = xq.shape
    n = w_q4.shape[1]
    groups = scale4.shape[0]
    ops = 2.0 * m * k * n
    nbytes = (k // 2) * n + 4.0 * groups * n + m * k + 4.0 * m * groups + 2.0 * m * n
    return ops, nbytes, costs.bound_s(ops, nbytes, costs.PEAK_INT8_OPS)


def read(run):
    return run.roofline(KERNEL)
