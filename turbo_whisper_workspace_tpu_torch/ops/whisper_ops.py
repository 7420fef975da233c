"""The Whisper decoder step's work beside its projections, as CUDA kernels.

The JAX package has no module of this name. It runs the decode loop as
one compiled program (turbo_whisper_workspace_tpu/decode/greedy.py:173,
decode/beam.py:282: `lax.while_loop` under jit, the t = 1 decoder layers
unrolled at models/whisper.py:671-676), in which XLA fuses what this
module's three kernels compute:

* `whisper_norm`: the residual add and layer_norm (models/whisper.py:
  182-189, the adds of :614, :662 and `_mlp_block` :283-290); its entry
  mode the token and position embeddings' gather and add (:465-467)
  before the first norm; csrc/whisper_norm.cu. The encoder's blocks and
  `ln_post` take the same kernel over B·1500 rows;
* `whisper_kv_rows`: `_quantize_kv_rows` (:420-430) and the cache's
  dynamic_update_slice writes (:518-580, :604-605) into the bf16, the
  int8 or the beam-lane cache; csrc/whisper_kv_rows.cu;
* `whisper_logit_rules`: `DecodeRules.apply` (decode/rules.py:87-135)
  with the argmax, log_softmax and the sampled token's log-probability of
  greedy's body (decode/greedy.py:118-143), or beam's `alive_scores +
  log_softmax` (decode/beam.py:154-178); csrc/whisper_logit_rules.cu.

The decoder's self-attention over its bf16 cache is `llama_ops.
llama_attention` at group 1.

Each has a wrapper and a plain PyTorch version beside it, the port's
arithmetic as it was before the kernels (so the decoder, greedy and beam
on the CPU are unchanged bit for bit). For CUDA tensors a wrapper checks
them, allocates its outputs, launches its kernel on the current stream
and counts the launch in `launch_counts`; for CPU tensors it runs the
plain version; anything else raises. The kernels take bf16 activations
and f32 logits. `pos` is a host int or a 0-dim int64 tensor on the
tensors' device, read there and clamped into [0, S − t] as
dynamic_update_slice clamps (a decode step a CUDA graph replays).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import build
from .attention import _div
from .build import _check_cuda, _stream, count_launch
from .llama_ops import _device_pos

# kernel name → launches since the last reset_launch_counts()
launch_counts = {name: 0 for name in ("whisper_norm", "whisper_kv_rows",
                                      "whisper_logit_rules")}

NORM_MAX_D = 4096    # csrc/whisper_norm.cu: 16 chunks of 8 values a lane
KV_MAX_DH = 128      # csrc/whisper_kv_rows.cu: 4 values a lane of a warp a row


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


# ---------------------------------------------------------------------------
# Plain versions


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """f32 statistics and affine whatever x's dtype, one rounding back."""
    return F.layer_norm(x.float(), x.shape[-1:], weight.float(), bias.float(),
                        eps).to(x.dtype)


def whisper_norm_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                           eps: float, delta: torch.Tensor | None = None):
    """(x', h): x' = x + delta in x's dtype (x itself without delta),
    h = layer_norm(x')."""
    if delta is not None:
        x = x + delta
    return x, layer_norm(x, weight, bias, eps)


def embed_rows(tokens: torch.Tensor, token_emb: torch.Tensor, pos_emb: torch.Tensor,
               pos) -> torch.Tensor:
    """token_emb[tokens] + pos_emb rows pos..pos+t-1: (B, t, D)."""
    t = tokens.shape[1]
    if torch.is_tensor(pos):
        rows = pos_emb.index_select(0, pos.view(1) + torch.arange(t, device=pos.device))
    else:
        rows = pos_emb[pos:pos + t]
    return token_emb[tokens] + rows


def whisper_embed_norm_reference(tokens: torch.Tensor, token_emb: torch.Tensor,
                                 pos_emb: torch.Tensor, pos, weight: torch.Tensor,
                                 bias: torch.Tensor, eps: float):
    """(x, h): x = the embedded tokens (B, t, D) at positions pos..pos+t-1,
    h = layer_norm(x): the decoder's entry and its first norm."""
    x = embed_rows(tokens, token_emb, pos_emb, pos)
    return x, layer_norm(x, weight, bias, eps)


def quantize_kv_rows(x: torch.Tensor, n_head: int):
    """(B, T, D) → head-major int8 payload (B, H, T, Dh) and per-(B, H, T)
    bf16 scales, both dense: divide by the f32 scale amax/127 (IEEE
    divisions, clamped at 1e-8), round half to even, and only then store
    the scale as bf16, as the JAX function does."""
    b, t, d = x.shape
    xh = x.reshape(b, t, n_head, d // n_head).transpose(1, 2).float().contiguous()
    s = _div(xh.abs().amax(dim=-1), 127.0).clamp_min(1e-8)
    xq = torch.clamp(torch.round(xh / s[..., None]), -127, 127).to(torch.int8)
    return xq, s.to(torch.bfloat16)


def write_rows(dst: torch.Tensor, dim: int, pos, rows: torch.Tensor) -> None:
    """rows into dst IN PLACE at positions [pos, pos + rows.shape[dim])
    along `dim`: a slice at an int pos, `index_copy_` at a 0-dim tensor
    pos (no host read: the step a CUDA graph replays)."""
    if torch.is_tensor(pos):
        n = rows.shape[dim]
        dst.index_copy_(dim, pos.view(1) + torch.arange(n, device=pos.device), rows)
    else:
        dst.narrow(dim, pos, rows.shape[dim]).copy_(rows)


def whisper_kv_rows_reference(k: torch.Tensor, v: torch.Tensor, cache: dict, layer: int,
                              pos, n_head: int, beam: int = 1) -> None:
    """This call's K and V rows (B, t, D) into layer `layer` of the cache
    IN PLACE at positions pos..pos+t-1. bf16 {"k", "v"} (L, B, S, D): the
    rows as they are (in the cache's dtype); int8 {"k_q", "v_q", "k_s",
    "v_s"}: quantize_kv_rows, head-major; lanes {"k_p", "v_p", "k_ps",
    "v_ps"} (t = 1): beam row b·K+k quantized into lane k of batch item
    b (models/whisper.py:beam_lane_cache's layouts)."""
    b, t, d = k.shape
    if "k_p" in cache:
        br = b // beam
        kq, ks = quantize_kv_rows(k, n_head)              # (B·K, H, 1, Dh), (B·K, H, 1)
        vq, vs = quantize_kv_rows(v, n_head)
        write_rows(cache["k_p"][layer], 3, pos,
                   kq[:, :, 0].reshape(br, beam, d).transpose(1, 2)[..., None])
        write_rows(cache["v_p"][layer], 2, pos, vq[:, :, 0].reshape(br, beam, 1, d))
        write_rows(cache["k_ps"][layer], 3, pos,
                   ks[:, :, 0].reshape(br, beam, n_head).transpose(1, 2)[..., None])
        write_rows(cache["v_ps"][layer], 3, pos,
                   vs[:, :, 0].reshape(br, beam, n_head).transpose(1, 2)[..., None])
    elif "k_q" in cache:
        kq, ks = quantize_kv_rows(k, n_head)              # (B, H, T, Dh), (B, H, T)
        vq, vs = quantize_kv_rows(v, n_head)
        for name, rows in (("k_q", kq), ("k_s", ks), ("v_q", vq), ("v_s", vs)):
            write_rows(cache[name][layer], 2, pos, rows)
    else:
        write_rows(cache["k"][layer], 1, pos, k.to(cache["k"].dtype))
        write_rows(cache["v"][layer], 1, pos, v.to(cache["v"].dtype))


def whisper_logit_rules_reference(logits: torch.Tensor, rules, is_begin: bool,
                                  last_tok: torch.Tensor, penult_tok: torch.Tensor,
                                  ts_floor: torch.Tensor, static_mask: torch.Tensor,
                                  begin_mask: torch.Tensor, noise: torch.Tensor | None = None,
                                  temperature: float = 0.0, add: torch.Tensor | None = None):
    """(next_tok, tok_logp, cand) of (rows, V) f32 logits under `rules`
    (decode/rules.py:DecodeRules): next_tok (rows,) int64 the argmax of
    the masked row, or of masked + temperature · noise when noise (rows,
    V) is given; tok_logp (rows,) its log-probability under
    log_softmax(masked); cand (rows, V) = add[:, None] + log_softmax(masked)
    when add (rows,) is given, else None."""
    masked = rules.apply(logits, is_begin, last_tok, penult_tok, ts_floor, static_mask,
                         begin_mask)
    if noise is not None:
        next_tok = torch.argmax(masked + temperature * noise, dim=-1)
    else:
        next_tok = torch.argmax(masked, dim=-1)
    logp = torch.log_softmax(masked, dim=-1)
    tok_logp = logp.gather(-1, next_tok[:, None])[:, 0]
    cand = None if add is None else add[:, None] + logp
    return next_tok, tok_logp, cand


# ---------------------------------------------------------------------------
# Kernel wrappers


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _norm_shape(name: str, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> int:
    d = x.shape[-1]
    if weight.shape != (d,) or bias.shape != (d,) or d % 8 or d > NORM_MAX_D:
        raise ValueError(f"{name}: x {tuple(x.shape)}, weight {tuple(weight.shape)}, bias "
                         f"{tuple(bias.shape)}: d a multiple of 8 up to {NORM_MAX_D}")
    return d


def _records(*tensors) -> bool:
    """Whether autograd records a call on these tensors (a training step)."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def _recompute_grads(plain, inputs: tuple, grads: tuple) -> tuple:
    """The gradients of plain(*inputs) with respect to its tensor inputs
    that need one, the forward recomputed in the plain version's torch
    ops (None for the others)."""
    wants = [torch.is_tensor(t) and t.requires_grad for t in inputs]
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() if w else t for t, w in zip(inputs, wants)]
        outs = plain(*leaves)
        needed = [t for t, w in zip(leaves, wants) if w]
        got = iter(torch.autograd.grad(outs, needed, grads, allow_unused=True))
    return tuple(next(got) if w else None for w in wants)


def whisper_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
                 delta: torch.Tensor | None = None):
    """See whisper_norm_reference; x (..., d), delta, weight and bias bf16.

    CUDA: csrc/whisper_norm.cu, one launch: mode 1 (the residual add and
    the norm) with delta, mode 0 (the norm) without; x' is x itself then.
    d a multiple of 8 up to NORM_MAX_D. When autograd records (a training
    step), the launch goes behind WhisperNorm, whose backward recomputes
    the plain version's torch ops. CPU: the plain version."""
    if x.device.type == "cpu":
        return whisper_norm_reference(x, weight, bias, eps, delta)
    if _records(x, weight, bias, delta):
        if delta is None:
            return x, WhisperNorm.apply(x, weight, bias, eps, None)
        return WhisperNorm.apply(x, weight, bias, eps, delta)
    return _whisper_norm_launch(x, weight, bias, eps, delta)


class WhisperNorm(torch.autograd.Function):
    """whisper_norm with a gradient: the forward launches the kernel and
    returns (x', h), or h alone without delta (x' is x then); the
    backward is autograd of whisper_norm_reference on the saved inputs."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, delta):
        ctx.eps = eps
        ctx.save_for_backward(x, weight, bias, delta)
        x_out, h = _whisper_norm_launch(x, weight, bias, eps, delta)
        return h if delta is None else (x_out, h)

    @staticmethod
    def backward(ctx, *grads):
        x, weight, bias, delta = ctx.saved_tensors
        eps = ctx.eps

        def plain(x, weight, bias, delta):
            x_out, h = whisper_norm_reference(x, weight, bias, eps, delta)
            return (h,) if delta is None else (x_out, h)

        gx, gw, gb, gd = _recompute_grads(plain, (x, weight, bias, delta), grads)
        return gx, gw, gb, None, gd


def _whisper_norm_launch(x, weight, bias, eps, delta):
    tensors = {"x": x, "weight": weight, "bias": bias,
               **({"delta": delta} if delta is not None else {})}
    _check_cuda("whisper_norm", tensors, dict.fromkeys(tensors, torch.bfloat16), align=16)
    d = _norm_shape("whisper_norm", x, weight, bias)
    if delta is not None and delta.shape != x.shape:
        raise ValueError(f"whisper_norm: delta {tuple(delta.shape)} for x {tuple(x.shape)}")
    m = x.numel() // d
    x_out = torch.empty_like(x) if delta is not None else x
    h = torch.empty_like(x)
    build.launch("whisper_norm", x.data_ptr(), _ptr(delta), None, None, None, None, 0, 0,
                 weight.data_ptr(), bias.data_ptr(), x_out.data_ptr(), h.data_ptr(), m, d, 1,
                 1 if delta is not None else 0, eps, _stream(x.device))
    count_launch(launch_counts, "whisper_norm")
    return x_out, h


def whisper_embed_norm(tokens: torch.Tensor, token_emb: torch.Tensor, pos_emb: torch.Tensor,
                       pos, weight: torch.Tensor, bias: torch.Tensor, eps: float):
    """See whisper_embed_norm_reference; tokens (B, t) int64, the tables
    (V, D) and (n_ctx, D) and the norm's weight and bias bf16.

    CUDA: csrc/whisper_norm.cu's entry mode (2), one launch counted as
    whisper_norm; the positions pos..pos+t-1 with pos clamped into
    [0, n_ctx − t]. When autograd records, the launch goes behind
    WhisperEmbedNorm (its backward as WhisperNorm's). CPU: the plain
    version."""
    if tokens.device.type == "cpu":
        return whisper_embed_norm_reference(tokens, token_emb, pos_emb, pos, weight, bias, eps)
    if _records(token_emb, pos_emb, weight, bias):
        return WhisperEmbedNorm.apply(tokens, token_emb, pos_emb, pos, weight, bias, eps)
    return _whisper_embed_norm_launch(tokens, token_emb, pos_emb, pos, weight, bias, eps)


class WhisperEmbedNorm(torch.autograd.Function):
    """whisper_embed_norm with a gradient: the forward launches the
    kernel's entry mode, the backward is autograd of
    whisper_embed_norm_reference on the saved inputs."""

    @staticmethod
    def forward(ctx, tokens, token_emb, pos_emb, pos, weight, bias, eps):
        ctx.eps = eps
        ctx.pos = pos if not torch.is_tensor(pos) else None
        ctx.save_for_backward(tokens, token_emb, pos_emb, weight, bias,
                              pos if torch.is_tensor(pos) else None)
        return _whisper_embed_norm_launch(tokens, token_emb, pos_emb, pos, weight, bias, eps)

    @staticmethod
    def backward(ctx, gx, gh):
        tokens, token_emb, pos_emb, weight, bias, pos_t = ctx.saved_tensors
        pos = pos_t if pos_t is not None else ctx.pos
        eps = ctx.eps

        def plain(token_emb, pos_emb, weight, bias):
            return whisper_embed_norm_reference(tokens, token_emb, pos_emb, pos, weight, bias,
                                                eps)

        grads = _recompute_grads(plain, (token_emb, pos_emb, weight, bias), (gx, gh))
        return None, grads[0], grads[1], None, grads[2], grads[3], None


def _whisper_embed_norm_launch(tokens, token_emb, pos_emb, pos, weight, bias, eps):
    bf16 = torch.bfloat16
    _check_cuda("whisper_embed_norm", {"tokens": tokens, "token_emb": token_emb,
                                       "pos_emb": pos_emb, "weight": weight, "bias": bias},
                {"tokens": torch.int64, "token_emb": bf16, "pos_emb": bf16, "weight": bf16,
                 "bias": bf16}, align=16)
    b, t = tokens.shape
    d = _norm_shape("whisper_embed_norm", token_emb, weight, bias)
    n_ctx = pos_emb.shape[0]
    if pos_emb.shape != (n_ctx, d) or t > n_ctx:
        raise ValueError(f"whisper_embed_norm: tables {tuple(token_emb.shape)}, "
                         f"{tuple(pos_emb.shape)}, tokens {tuple(tokens.shape)}")
    pos_at, pos_i = _device_pos(pos, t, n_ctx, tokens.device)
    x = torch.empty((b, t, d), dtype=bf16, device=tokens.device)
    h = torch.empty_like(x)
    build.launch("whisper_norm", None, None, tokens.data_ptr(), token_emb.data_ptr(),
                 pos_emb.data_ptr(), pos_at, pos_i, n_ctx, weight.data_ptr(), bias.data_ptr(),
                 x.data_ptr(), h.data_ptr(), b * t, d, t, 2, eps, _stream(tokens.device))
    count_launch(launch_counts, "whisper_norm")
    return x, h


def whisper_kv_rows(k: torch.Tensor, v: torch.Tensor, cache: dict, layer: int, pos,
                    n_head: int, beam: int = 1) -> None:
    """See whisper_kv_rows_reference; k, v (B, t, D) bf16.

    CUDA: csrc/whisper_kv_rows.cu, one launch for K and V: mode 0 the
    bf16 cache (bf16), mode 1 the int8 cache, mode 2 the lanes (t = 1,
    beam equal to the cache's lanes). Head dim at most KV_MAX_DH. CPU:
    the plain version."""
    if k.device.type == "cpu":
        return whisper_kv_rows_reference(k, v, cache, layer, pos, n_head, beam)
    mode = 2 if "k_p" in cache else (1 if "k_q" in cache else 0)
    b, t, d = k.shape
    dh = d // n_head
    bf16, i8 = torch.bfloat16, torch.int8
    names = {0: ("k", "v"), 1: ("k_q", "v_q", "k_s", "v_s"),
             2: ("k_p", "v_p", "k_ps", "v_ps")}[mode]
    layers = {name: cache[name][layer] for name in names}
    dtypes = {"k": bf16, "v": bf16, "k_q": i8, "v_q": i8, "k_p": i8, "v_p": i8}
    _check_cuda("whisper_kv_rows", {"k_rows": k, "v_rows": v, **layers},
                {"k_rows": bf16, "v_rows": bf16, **{n: dtypes.get(n, bf16) for n in layers}},
                align=4)
    if mode == 0:
        s_len = layers["k"].shape[1]
        ok = layers["k"].shape == layers["v"].shape == (b, s_len, d)
    elif mode == 1:
        s_len = layers["k_q"].shape[2]
        ok = (layers["k_q"].shape == layers["v_q"].shape == (b, n_head, s_len, dh)
              and layers["k_s"].shape == layers["v_s"].shape == (b, n_head, s_len))
    else:
        s_len = layers["k_p"].shape[-1]
        br = b // max(beam, 1)
        ok = (t == 1 and br * beam == b and layers["k_p"].shape == (br, d, beam, s_len)
              and layers["v_p"].shape == (br, beam, s_len, d)
              and layers["k_ps"].shape == layers["v_ps"].shape == (br, n_head, beam, s_len))
    if (not ok or v.shape != k.shape or d % n_head or dh > KV_MAX_DH
            or t > s_len):
        raise ValueError(f"whisper_kv_rows: rows {tuple(k.shape)} of {n_head} heads, beam "
                         f"{beam}, into {({n: tuple(x.shape) for n, x in layers.items()})}")
    pos_at, pos_i = _device_pos(pos, t, s_len, k.device)
    dk, dv, dks, dvs = [layers[n].data_ptr() for n in names] + [None] * (4 - len(names))
    build.launch("whisper_kv_rows", k.data_ptr(), v.data_ptr(), dk, dv, dks, dvs, mode, b, t,
                 n_head, dh, s_len, beam, pos_at, pos_i, _stream(k.device))
    count_launch(launch_counts, "whisper_kv_rows")


def whisper_logit_rules(logits: torch.Tensor, rules, is_begin: bool, last_tok: torch.Tensor,
                        penult_tok: torch.Tensor, ts_floor: torch.Tensor,
                        static_mask: torch.Tensor, begin_mask: torch.Tensor,
                        noise: torch.Tensor | None = None, temperature: float = 0.0,
                        add: torch.Tensor | None = None):
    """See whisper_logit_rules_reference; logits, noise (rows, V), the
    masks (V,) and add (rows,) f32; the tokens and ts_floor (rows,) int64.

    CUDA: csrc/whisper_logit_rules.cu, one launch, a cluster of 8 blocks
    a row; the outputs in new tensors. CPU: the plain version."""
    if logits.device.type == "cpu":
        return whisper_logit_rules_reference(logits, rules, is_begin, last_tok, penult_tok,
                                             ts_floor, static_mask, begin_mask, noise,
                                             temperature, add)
    f32, i64 = torch.float32, torch.int64
    tensors = {"logits": logits, "last_tok": last_tok, "penult_tok": penult_tok,
               "ts_floor": ts_floor, "static_mask": static_mask,
               **({"begin_mask": begin_mask} if is_begin else {}),
               **({"noise": noise} if noise is not None else {}),
               **({"add": add} if add is not None else {})}
    _check_cuda("whisper_logit_rules", tensors,
                {n: i64 if n in ("last_tok", "penult_tok", "ts_floor") else f32
                 for n in tensors}, align=4)
    rows, vocab = logits.shape
    sp = rules.specials
    if (vocab != sp.n_vocab or static_mask.shape != (vocab,)
            or (is_begin and begin_mask.shape != (vocab,))
            or any(x.shape != (rows,) for x in (last_tok, penult_tok, ts_floor))
            or (noise is not None and noise.shape != logits.shape)
            or (add is not None and add.shape != (rows,))
            or not 0 < sp.timestamp_begin <= vocab or not 0 <= sp.eot < vocab):
        raise ValueError(f"whisper_logit_rules: logits {tuple(logits.shape)} for a vocabulary "
                         f"of {sp.n_vocab}; masks, tokens, noise and add must match")
    next_tok = torch.empty(rows, dtype=i64, device=logits.device)
    tok_logp = torch.empty(rows, dtype=f32, device=logits.device)
    cand = None if add is None else torch.empty_like(logits)
    build.launch("whisper_logit_rules", logits.data_ptr(), static_mask.data_ptr(),
                 begin_mask.data_ptr() if is_begin else None, last_tok.data_ptr(),
                 penult_tok.data_ptr(), ts_floor.data_ptr(), _ptr(noise), temperature,
                 _ptr(add), next_tok.data_ptr(), tok_logp.data_ptr(), _ptr(cand), rows, vocab,
                 sp.eot, sp.timestamp_begin, int(rules.timestamps), int(is_begin),
                 _stream(logits.device))
    count_launch(launch_counts, "whisper_logit_rules")
    return next_tok, tok_logp, cand
