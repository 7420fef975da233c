"""`flash_attention` (csrc/flash_attention.cu, the encoder's attention):
4·B·H·T²·D operations and its bytes, bound by operations, over its device
time in the traced window."""

from port_bench.lib import costs

KERNEL = {"module": "turbo_whisper_workspace_tpu_torch.ops.attention",
          "wrapper": "flash_attention", "trace": "flash_attention_kernel"}


def cost(q, k, v, *_, **__):
    b, h, t, d = q.shape
    tk = k.shape[2]
    flops = 4.0 * b * h * t * tk * d
    nbytes = 2.0 * b * h * d * (2 * t + 2 * tk)          # q, out; k, v (bf16)
    return flops, nbytes, costs.bound_s(flops, nbytes)


def read(run):
    return run.roofline(KERNEL)
