"""`mla_attention` (csrc/mla_attention.cu, the DeepSeek-V3 decode step's
latent attention): the latent cache's and the queries' bytes (and the
row it writes, the output) over its device time in the traced window,
against 3.35 TB/s, or its operations against the bf16 peak where they
bound it. A graphed step reads its position on the card, so a launch's
cost counts every row of the cache it is sized by (S = prompt +
max_len), not the pos + 1 it reads: at the cell's sizes (prompts of
1200-1800, 200-256 new) about 4-9% more bytes than read, an upper bound
of the share."""

from port_bench.lib import costs

KERNEL = {"module": "turbo_whisper_workspace_tpu_torch.ops.mla_ops",
          "wrapper": "mla_attention", "trace": "mla_attention_kernel"}


def cost(q_lat, q_pe, c_kv, k_pe, cos, sin, cache, *_, **__):
    b, t, h, lat = q_lat.shape
    s_len, row = cache.shape[1], cache.shape[2]
    ops = 2.0 * b * t * h * s_len * (row + lat)
    nbytes = 2.0 * (b * s_len * row + q_lat.numel() + q_pe.numel() + c_kv.numel()
                    + k_pe.numel() + b * t * row + b * t * h * lat)
    return ops, nbytes, costs.bound_s(ops, nbytes)


def read(run):
    return run.roofline(KERNEL)
