"""`int4_group_matmul` (csrc/int4_group_matmul.cu, the DeepSeek-V3
prefill's experts): 2·R·K·N operations against the bf16 peak, or the
bytes where they bound it (the packed weights and scales of the experts
that have rows, the rows in and out), over its device time in the
traced window."""

from port_bench.lib import costs

KERNEL = {"module": "turbo_whisper_workspace_tpu_torch.ops.quant",
          "wrapper": "int4_group_matmul", "trace": "int4_group_matmul_kernel"}


def cost(x, w_q4, scale4, counts, *_, **__):
    rows, k = x.shape
    n, groups = w_q4.shape[-1], scale4.shape[-2]
    experts = sum(1 for c in counts if c)
    ops = 2.0 * rows * k * n
    nbytes = experts * ((k // 2) * n + 4.0 * groups * n) + 2.0 * rows * (k + n)
    return ops, nbytes, costs.bound_s(ops, nbytes)


def read(run):
    return run.roofline(KERNEL)
