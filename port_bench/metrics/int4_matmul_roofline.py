"""`int4_matmul` (csrc/int4_matmul.cu, the prefill's projections):
2·M·K·N operations and its bytes over its device time in the traced
window, against the bf16 peak."""

from port_bench.lib import costs

KERNEL = {"module": "turbo_whisper_workspace_tpu_torch.ops.quant",
          "wrapper": "int4_matmul", "trace": "int4_matmul_kernel"}


def cost(x, w_q4, scale, *_, **__):
    m, k = x.shape
    n = w_q4.shape[1]
    flops = 2.0 * m * k * n
    nbytes = 2.0 * m * k + (k // 2) * n + 4.0 * scale.shape[0] * n + 2.0 * m * n
    return flops, nbytes, costs.bound_s(flops, nbytes)


def read(run):
    return run.roofline(KERNEL)
