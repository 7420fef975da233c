"""`cross_attention_int8` (csrc/cross_attention_int8.cu, the decoder's
cross-attention over the int8 K/V): its bytes (int8 K and V over the
valid keys, per-head scales, bf16 q and out) over its device time in the
traced window, against 3.35 TB/s."""

from port_bench.lib import costs

KERNEL = {"module": "turbo_whisper_workspace_tpu_torch.ops.attention",
          "wrapper": "cross_attention_int8", "trace": "cross_attention_int8_kernel"}


def cost(q, kq, vq, k_scale, v_scale, seq_len=None, **__):
    b, h, tq, d = q.shape
    keys = seq_len if seq_len is not None else kq.shape[-1]
    flops = 4.0 * b * h * tq * keys * d
    nbytes = (2.0 * b * h * keys * d                     # int8 K and V
              + 2 * 4.0 * b * h                          # f32 scales
              + 2 * 2.0 * b * h * tq * d)                # bf16 q and out
    return flops, nbytes, costs.bound_s(flops, nbytes)


def read(run):
    return run.roofline(KERNEL)
