"""`int4_moe_s8` (csrc/int4_moe_s8.cu, the DeepSeek-V3 decode step's
experts): the chosen experts' int4 weight and scale bytes, the
activations, ids and output over its device time in the traced window,
against 3.35 TB/s. A row's expert is read once: at the cell's batch 1 no
two rows of a step share one."""

from port_bench.lib import costs

KERNEL = {"module": "turbo_whisper_workspace_tpu_torch.ops.quant",
          "wrapper": "int4_moe_s8", "trace": "int4_moe_s8_kernel"}


def cost(xq, xs, w_q4, scale4, ids, *_, **__):
    rows, k = ids.shape[0], xq.shape[1]
    n, groups = w_q4.shape[-1], scale4.shape[-2]
    ops = 2.0 * rows * k * n
    nbytes = (rows * ((k // 2) * n + 4.0 * groups * n) + xq.numel() + 4.0 * xs.numel()
              + 8.0 * rows + 2.0 * rows * n)
    return ops, nbytes, costs.bound_s(ops, nbytes, costs.PEAK_INT8_OPS)


def read(run):
    return run.roofline(KERNEL)
