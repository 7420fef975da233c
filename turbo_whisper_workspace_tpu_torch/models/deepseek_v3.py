"""DeepSeek-V3-architecture decoder-only LM (Moonlight-16B-A3B) on plain
tensors: multi-head latent attention over a latent cache and sigmoid-
routed experts.

No JAX counterpart: the JAX package runs Llama alone. The equations are
the published ones (DeepSeek-V2, arXiv:2405.04434, §2.1, MLA; DeepSeek-V3,
arXiv:2412.19437, §2.1.2, routing; Moonlight, arXiv:2502.16982), held to
`tests/ref_deepseek_v3.py`. A layer: x += W_o · MLA(RMSNorm(x)), then x +=
FFN(RMSNorm(x)), where FFN is a SwiGLU for the first `first_dense` layers
and the experts' sum for the rest.

MLA with no query LoRA: q = x W_q (per head 128 "nope" and 64 rope
dims), [c_kv, k_pe] = x W_kv_a, c_kv = RMSNorm(c_kv). The cache keeps one
576-wide bf16 row a position and layer, [c_kv, rotated k_pe]
(`init_kv_cache`: (L, B, S, 576), 31 KB a token over Moonlight's 27
layers). Scores use the scale (nope + rope)^-1/2.

* A decode step (t = 1) runs the absorbed form: q_lat = q_nope · W_UK per
  head (a batched bf16 matmul), then `ops/mla_ops.mla_attention`, one
  kernel that rotates q_pe and k_pe, writes the new row at the device
  position and attends over the latent rows; the output latent goes
  through W_UV per head, then W_o. W_UK and W_UV are kv_b_proj's halves,
  kept in bf16.
* A prefill (t > 1) runs the expanded form, the modeling code's own:
  the rotated rows written to the cache with torch ops, k_nope and v
  formed from the cache's latents, and the library's
  `scaled_dot_product_attention` over qk 192 / v 128 (v zero-padded to
  192, so that its flash backend takes one head width; its cuDNN backend is left
  out: it builds a plan on the host for each new prompt length, ~0.4 s
  a prefill on the H100). The prefill is eager and its attention is a
  large product, which the library computes on tensor cores; the
  absorbed form there would do 576-wide dots for every (query, key)
  pair.

Experts (layers ≥ first_dense): s = sigmoid(x W_g) in f32, the top_k of s
+ bias chosen (the bias selects only), weights s[chosen] / (Σ + 1e-20) ·
routed_scale; y = Σ wᵢ Eᵢ(x) + Shared(x), summed in f32. The shared
SwiGLU of width n_shared · moe_d_ff is held as n_shared more experts of
width moe_d_ff (ids n_experts … n_experts + n_shared − 1, weight 1: the
same function, its intermediate cut in equal parts), stacked (E', K, N)
after the routed ones, so every token's rows are top_k + n_shared
experts. `route` is one kernel (`ops/moe_ops.moe_route`; its plain
version is about ten library launches a layer).

* Decode (at most 8 tokens, int4 experts): the rows' gate|up as one
  `quant.int4_moe_s8` launch over the token's quantized input, SwiGLU
  with the down projection's quantizer (`llama_swiglu_quant`), the
  rows' down as another; the ids stay on the device.
* Otherwise (the prefill): the rows gathered in expert order and the
  counts read on the host, under the span `moe.experts`: with fused
  int4 experts, their gate|up as one `quant.int4_group_matmul` launch
  over every expert's rows (in bf16, as `int4_matmul` computes a
  prefill's projections), SwiGLU, their down as another; else (dense or
  int8 experts, on the CPU alone) a matmul a projection of each expert
  that has rows. On CUDA the experts must be fused int4 (`quantize_tree`
  at bits 4, then `fuse_siblings`), and `moe` refuses others: their
  decode would read the counts on the host, which a graphed step cannot.
  While the profiler records, the rows routed to each (layer, routed
  expert) add into the tracer's counter `moe.routed_tokens` (a device
  buffer, no host read).

Parameters are a plain dict {"token_emb", "blocks", "norm", "lm_head"}; a
block holds attn_norm, q, kv_a, kv_norm, kv_b {"w_uk" (H, nope, L),
"w_uv" (H, L, v)}, out, mlp_norm, and gate, up, down (dense layers) or
router {"w" (E, d), "bias" (E,) f32, "shared" (n_shared,) ids} and
experts {gate, up, down} of 3-D weights. Projections are {"w"} (in,
out), int8 or int4 dicts (`quant.quantize_tree` with QUANT_KEYS). The
int4 siblings join as in models/llama.py (`fuse_siblings`): q|kv_a, the
dense gate|up and the experts' gate|up. `params_from_hf_state_dict` loads
a transformers DeepseekV3ForCausalLM state dict; its rope columns of
q_proj and kv_a_proj_with_mqa are permuted once from the modeling code's
interleaved pairs to the half-split layout the port rotates (the
modeling code regroups the pairs the same way before it rotates, so the
scores are the same).

`forward` has models/llama.forward's contract: `pos` a host int or a
0-dim int64 tensor on the tokens' device, the cache written in place,
logits for every position.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from ..ops import llama_ops, mla_ops, moe_ops, quant
from ..utils import profiling
from .llama import head_logits, held, project_siblings, rope_table

# projections quantize_tree quantizes; kv_b (absorbed per head) and the
# router stay as they are
QUANT_KEYS = ("q", "kv_a", "out", "gate", "up", "down", "lm_head")
# a fused projection's name → the sibling projections it joins, in column order
SIBLINGS = {"q_kv_a": ("q", "kv_a"), "gate_up": ("gate", "up")}
ROUTED_COUNTER = "moe.routed_tokens"
# the prefill attention's library backends: all but cuDNN's (see the module doc)
SDPA_BACKENDS = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH]


@dataclass(frozen=True)
class DeepseekV3Dims:
    n_vocab: int
    d_model: int
    n_layer: int
    n_head: int
    kv_lora_rank: int
    qk_nope_dim: int
    qk_rope_dim: int
    v_head_dim: int
    d_ff: int                 # the dense layers' SwiGLU width
    moe_d_ff: int             # an expert's width
    n_experts: int            # routed experts
    n_shared: int             # shared experts, each moe_d_ff wide
    top_k: int
    first_dense: int          # first_k_dense_replace
    routed_scale: float
    rope_theta: float
    norm_eps: float = 1e-6
    max_ctx: int = 4096
    norm_topk_prob: bool = True

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_dim + self.qk_rope_dim

    @property
    def cache_dim(self) -> int:
        return self.kv_lora_rank + self.qk_rope_dim

    @property
    def rows_a_token(self) -> int:
        return self.top_k + self.n_shared


DEEPSEEK_V3_CONFIGS: dict[str, DeepseekV3Dims] = {
    # moonshotai/Moonlight-16B-A3B (config.json: model_type deepseek_v3)
    "moonlight-16b-a3b": DeepseekV3Dims(
        n_vocab=163840, d_model=2048, n_layer=27, n_head=16, kv_lora_rank=512,
        qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128, d_ff=11264, moe_d_ff=1408,
        n_experts=64, n_shared=2, top_k=6, first_dense=1, routed_scale=2.446,
        rope_theta=50000.0, norm_eps=1e-5, max_ctx=8192,
    ),
    "test-tiny": DeepseekV3Dims(
        n_vocab=512, d_model=64, n_layer=3, n_head=4, kv_lora_rank=32, qk_nope_dim=16,
        qk_rope_dim=16, v_head_dim=16, d_ff=128, moe_d_ff=32, n_experts=8, n_shared=1,
        top_k=2, first_dense=1, routed_scale=2.5, rope_theta=10000.0, norm_eps=1e-5,
        max_ctx=512,
    ),
}


def dims_from_hf_config(c: dict) -> DeepseekV3Dims:
    """A transformers DeepseekV3 config.json → dims."""
    if c.get("q_lora_rank") is not None or c.get("n_group", 1) != 1 or c.get("rope_scaling"):
        raise ValueError("deepseek_v3: query LoRA, group-limited routing and rope scaling "
                         "are not supported")
    return DeepseekV3Dims(
        n_vocab=c["vocab_size"], d_model=c["hidden_size"], n_layer=c["num_hidden_layers"],
        n_head=c["num_attention_heads"], kv_lora_rank=c["kv_lora_rank"],
        qk_nope_dim=c["qk_nope_head_dim"], qk_rope_dim=c["qk_rope_head_dim"],
        v_head_dim=c["v_head_dim"], d_ff=c["intermediate_size"],
        moe_d_ff=c["moe_intermediate_size"], n_experts=c["n_routed_experts"],
        n_shared=c["n_shared_experts"], top_k=c["num_experts_per_tok"],
        first_dense=c["first_k_dense_replace"], routed_scale=c["routed_scaling_factor"],
        rope_theta=float(c["rope_theta"]), norm_eps=c["rms_norm_eps"],
        max_ctx=c["max_position_embeddings"], norm_topk_prob=c["norm_topk_prob"])


def init_kv_cache(dims: DeepseekV3Dims, batch: int, max_len: int,
                  dtype: torch.dtype = torch.bfloat16,
                  device: torch.device | str = "cpu") -> dict:
    """{"latent": (L, B, S, kv_lora_rank + qk_rope_dim)}: [c_kv, rotated
    k_pe] a row (models/llama.py's name, so that llm/generate.py calls
    either family's)."""
    return {"latent": torch.zeros((dims.n_layer, batch, max_len, dims.cache_dim), dtype=dtype,
                                  device=device)}


def init_params(dims: DeepseekV3Dims, generator: torch.Generator,
                dtype: torch.dtype = torch.float32, bias_std: float = 0.0,
                device: torch.device | str = "cpu") -> dict:
    """Random weights: projections N(0, 1)·d_in^-1/2, embedding N(0, 1)·0.02,
    norm scales 1, the router's selection bias N(0, bias_std²) (kept f32),
    drawn in f32 and cast to `dtype`. `quant.quantize_tree(params,
    keys=QUANT_KEYS, bits=...)` quantizes them afterwards."""
    d, h = dims.d_model, dims.n_head

    def randn(*shape, std):
        return torch.randn(*shape, generator=generator, device=device) * std

    def lin(*shape):
        return {"w": randn(*shape, std=shape[-2] ** -0.5).to(dtype)}

    def ones(n):
        return {"scale": torch.ones(n, dtype=dtype, device=device)}

    e_all = dims.n_experts + dims.n_shared
    blocks = []
    for li in range(dims.n_layer):
        block = {
            "attn_norm": ones(d), "q": lin(d, h * dims.qk_head_dim),
            "kv_a": lin(d, dims.cache_dim), "kv_norm": ones(dims.kv_lora_rank),
            "kv_b": {"w_uk": randn(h, dims.qk_nope_dim, dims.kv_lora_rank,
                                   std=dims.kv_lora_rank ** -0.5).to(dtype),
                     "w_uv": randn(h, dims.kv_lora_rank, dims.v_head_dim,
                                   std=dims.kv_lora_rank ** -0.5).to(dtype)},
            "out": lin(h * dims.v_head_dim, d), "mlp_norm": ones(d),
        }
        if li < dims.first_dense:
            block.update(gate=lin(d, dims.d_ff), up=lin(d, dims.d_ff), down=lin(dims.d_ff, d))
        else:
            block["router"] = {
                "w": randn(dims.n_experts, d, std=d ** -0.5).to(dtype),
                "bias": randn(dims.n_experts, std=bias_std),
                "shared": torch.arange(dims.n_experts, e_all, device=device)}
            block["experts"] = {"gate": lin(e_all, d, dims.moe_d_ff),
                                "up": lin(e_all, d, dims.moe_d_ff),
                                "down": lin(e_all, dims.moe_d_ff, d)}
        blocks.append(block)
    return {"token_emb": randn(dims.n_vocab, d, std=0.02).to(dtype), "blocks": blocks,
            "norm": ones(d), "lm_head": lin(d, dims.n_vocab)}


def fuse_siblings(params: dict) -> dict:
    """models/llama.fuse_siblings for this family: each block's int4 q and
    kv_a into q_kv_a, the dense layers' gate and up and the experts' into
    gate_up, in place, a block at a time (`quant.join_int4`). Returns
    params."""
    for block in params["blocks"]:
        quant.join_int4(block, SIBLINGS)
        if "experts" in block:
            quant.join_int4(block["experts"], SIBLINGS)
    return params


def route(h: torch.Tensor, router: dict, dims: DeepseekV3Dims,
          log: torch.Tensor | None = None, pos=0):
    """h (T, d) → (ids (T, top_k + n_shared) int64, weights f32): the
    top_k of sigmoid(h W_g) + bias, their sigmoid scores normalized and
    scaled, then the shared experts at weight 1 (`ops/moe_ops.moe_route`;
    given a `log` (B, S, top_k), the chosen ids also into it at the rows'
    positions from `pos`, for a caller that keeps the served choices)."""
    return moe_ops.moe_route(h, router["w"], router["bias"], router["shared"], dims.top_k,
                             dims.routed_scale, dims.norm_topk_prob, log, pos)


def _swiglu_rows(gate: torch.Tensor, up: torch.Tensor, groups: int):
    """SwiGLU's product and the down projection's input quantizer (column
    views of a fused gate|up copied dense, as models/llama.py does)."""
    return llama_ops.llama_swiglu_quant(gate.contiguous(), up.contiguous(), groups)


def _expert(experts: dict, name: str, e: int) -> dict:
    return {k: v[e] for k, v in experts[name].items()}


def _starts(counts: list[int]) -> list[int]:
    """Where each expert's rows begin, the rows grouped by expert."""
    out, at = [], 0
    for n in counts:
        out.append(at)
        at += n
    return out


def _expert_swiglu(x: torch.Tensor, experts: dict, e: int) -> torch.Tensor:
    """Expert e's SwiGLU of its rows x, a matmul a projection (dense,
    int8, or int4 not fused)."""
    if "gate_up" in experts:
        gate, up = quant.matmul_any(x, _expert(experts, "gate_up", e)).chunk(2, -1)
    else:
        gate = quant.matmul_any(x, _expert(experts, "gate", e))
        up = quant.matmul_any(x, _expert(experts, "up", e))
    down = _expert(experts, "down", e)
    prod, act = _swiglu_rows(gate, up, quant.w4a8_groups(experts, ("down",), x.shape[0]))
    return quant.matmul_any(prod, down, act=act)


def moe(h: torch.Tensor, act, block: dict, dims: DeepseekV3Dims, layer: int) -> torch.Tensor:
    """The experts' sum for h (T, d) (act: h's (xq, xs) in the gate|up
    weight's groups at decode rows, or None) → (T, d) in h's dtype."""
    t = h.shape[0]
    a = dims.rows_a_token
    experts = block["experts"]
    down = experts["down"]
    int4 = "gate_up" in experts and "w_q4" in down
    if h.is_cuda and not int4:
        raise ValueError("deepseek_v3 on CUDA takes fused int4 experts alone (quantize_tree at "
                         "bits 4, then fuse_siblings): the others read their rows' counts on "
                         "the host, which a graphed decode step cannot")
    ids, weights = route(h, block["router"], dims)
    if act is not None and int4:
        gu = experts["gate_up"]
        gate, up = (p.to(h.dtype) for p in quant.int4_moe_s8(
            act[0], act[1], gu["w_q4"], gu["scale4"], ids.view(-1), x_div=a, split=True))
        prod, act2 = llama_ops.llama_swiglu_quant(gate, up, down["scale4"].shape[-2])
        y = quant.int4_moe_s8(act2[0], act2[1], down["w_q4"], down["scale4"],
                              ids.view(-1)).to(h.dtype)
    else:
        flat = ids.view(-1)
        order = flat.argsort(stable=True)
        counts = torch.bincount(flat, minlength=dims.n_experts + dims.n_shared)
        routed = profiling.counter(ROUTED_COUNTER, (dims.n_layer, dims.n_experts), h.device)
        if routed is not None:
            routed[layer].add_(counts[:dims.n_experts])
        counts = counts.tolist()
        with profiling.span("moe.experts"):
            xs = h.index_select(0, order // a)          # the rows, grouped by expert
            if int4:
                gu = experts["gate_up"]
                gate, up = quant.int4_group_matmul(xs, gu["w_q4"], gu["scale4"], counts,
                                                   split=True)
                prod, _ = llama_ops.llama_swiglu_quant(gate, up)
                ys = quant.int4_group_matmul(prod, down["w_q4"], down["scale4"], counts)
            else:
                ys = torch.cat([_expert_swiglu(xs[start:start + n], experts, e)
                                for e, (start, n) in enumerate(zip(_starts(counts), counts))
                                if n])
            y = torch.empty((t * a, dims.d_model), dtype=h.dtype, device=h.device)
            y.index_copy_(0, order, ys.to(h.dtype))
    out = torch.bmm(weights.view(t, 1, a), y.view(t, a, -1).float())
    return out.view(t, -1).to(h.dtype)


def _attend_expanded(q_nope, q_pe, latent, kv_b, dims, pos, t):
    """The prefill's attention, the modeling code's form: keys [c W_UK,
    k_pe] and values c W_UV of the cache rows up to the last query's
    position, the library's attention under the causal mask → (B, t, H,
    v)."""
    b = q_nope.shape[0]
    lat = dims.kv_lora_rank
    if torch.is_tensor(pos):
        rows, mask = latent, (torch.arange(latent.shape[1], device=latent.device)[None, :]
                              <= (pos + torch.arange(t, device=latent.device))[:, None])
    else:
        rows = latent[:, :pos + t]
        mask = None if pos == 0 else (torch.arange(pos + t, device=latent.device)[None, :]
                                      <= pos + torch.arange(t, device=latent.device)[:, None])
    c, k_pe = rows[..., :lat], rows[..., lat:]
    k_nope = torch.einsum("bsc,hnc->bhsn", c, kv_b["w_uk"])
    v = torch.einsum("bsc,hcv->bhsv", c, kv_b["w_uv"])
    k = torch.cat([k_nope, k_pe[:, None].expand(b, dims.n_head, -1, -1)], -1)
    q = torch.cat([q_nope, q_pe], -1).transpose(1, 2)
    width = max(dims.qk_head_dim, dims.v_head_dim)      # zeros add nothing to a dot product
    q, k, v = (F.pad(x, (0, width - x.shape[-1])) for x in (q, k, v))
    with sdpa_kernel(SDPA_BACKENDS):
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask, is_causal=mask is None,
                                           scale=dims.qk_head_dim ** -0.5)
    return o[..., :dims.v_head_dim].transpose(1, 2)


def forward(params: dict, dims: DeepseekV3Dims, tokens: torch.Tensor,
            cache: dict | None = None, pos: int | torch.Tensor = 0):
    """tokens (B, T) → (logits (B, T, vocab) f32, cache). With no cache a
    fresh one of length T is used and None is returned in its place.
    `pos` is an int or a 0-dim int64 tensor on the tokens' device;
    positions past max_ctx raise."""
    b, t = tokens.shape
    dtype = params["token_emb"].dtype
    h, nope, rope, lat = dims.n_head, dims.qk_nope_dim, dims.qk_rope_dim, dims.kv_lora_rank
    device = tokens.device
    x = params["token_emb"][tokens].to(dtype)
    use_cache = cache is not None
    if not use_cache:
        cache = init_kv_cache(dims, b, max_len=t, dtype=dtype, device=device)
        pos = 0
    if not torch.is_tensor(pos) and pos + t > dims.max_ctx:
        raise ValueError(f"positions up to {pos + t} exceed max_ctx {dims.max_ctx}")
    cos, sin = rope_table(rope // 2, dims.rope_theta, dims.max_ctx, device)
    eps, m = dims.norm_eps, b * t
    scale = dims.qk_head_dim ** -0.5
    widths = {"q": h * dims.qk_head_dim, "kv_a": dims.cache_dim, "gate": dims.d_ff,
              "up": dims.d_ff}

    delta = None                 # the last layer's output, added before the next norm
    for li, block in enumerate(params["blocks"]):
        latent = cache["latent"][li]                                    # (B, S, L + R)
        x, hn, act = llama_ops.llama_norm_quant(
            x, block["attn_norm"]["scale"], eps, delta,
            quant.w4a8_groups(block, held(block, "q_kv_a", SIBLINGS), m))
        q, kv = project_siblings(hn, block, "q_kv_a", SIBLINGS, widths, act)
        q = q.view(b, t, h, dims.qk_head_dim)
        q_nope, q_pe = q[..., :nope], q[..., nope:]
        c_kv = llama_ops.llama_norm_quant(kv[..., :lat].contiguous(),
                                          block["kv_norm"]["scale"], eps)[1]
        k_pe = kv[..., lat:]
        kv_b = block["kv_b"]
        if t == 1:
            q_lat = torch.bmm(q_nope.reshape(b, h, nope).transpose(0, 1), kv_b["w_uk"])
            o_lat = mla_ops.mla_attention(q_lat.transpose(0, 1).reshape(b, 1, h, lat), q_pe,
                                          c_kv, k_pe, cos, sin, latent, pos, scale)
            o = torch.bmm(o_lat.view(b, h, lat).transpose(0, 1), kv_b["w_uv"]).transpose(0, 1)
        else:
            positions = pos + torch.arange(t, device=device)
            rows = tuple(tab.index_select(0, positions)[None, :, None, :] for tab in (cos, sin))
            q_pe = llama_ops.apply_rope(q_pe, *rows)
            k_rot = llama_ops.apply_rope(k_pe.reshape(b, t, 1, rope), *rows)
            latent.index_copy_(1, positions, torch.cat([c_kv, k_rot.view(b, t, rope)], -1))
            o = _attend_expanded(q_nope, q_pe, latent, kv_b, dims, pos, t)
        o = o.reshape(b, t, h * dims.v_head_dim)
        act, groups = None, quant.w4a8_groups(block, ("out",), m)
        if groups:
            act = llama_ops.llama_norm_quant(o.contiguous(), None, eps, None, groups,
                                             norm=False)[2]
        delta = quant.matmul_any(o, block["out"], act=act)

        experts = block.get("experts")
        ffn = experts if experts is not None else block
        x, hn, act = llama_ops.llama_norm_quant(
            x, block["mlp_norm"]["scale"], eps, delta,
            quant.w4a8_groups(ffn, held(ffn, "gate_up", SIBLINGS), m))
        if experts is not None:
            delta = moe(hn.view(m, -1), act, block, dims, li).view(b, t, -1)
        else:
            gate, up = project_siblings(hn, block, "gate_up", SIBLINGS, widths, act)
            prod, act = _swiglu_rows(gate, up, quant.w4a8_groups(block, ("down",), m))
            delta = quant.matmul_any(prod, block["down"], act=act)

    return head_logits(params, x, delta, eps), (cache if use_cache else None)


def _rope_permutation(rope: int) -> torch.Tensor:
    """The modeling code's interleaved pairs (x0, x1), (x2, x3), … → the
    half-split layout (x0, x2, …, x1, x3, …)."""
    return torch.cat([torch.arange(0, rope, 2), torch.arange(1, rope, 2)])


def block_from_hf(sd: dict, dims: DeepseekV3Dims, i: int,
                  dtype: torch.dtype = torch.float32,
                  device: torch.device | str = "cpu") -> dict:
    """Layer i's block from a transformers DeepseekV3ForCausalLM state
    dict (on any device; only layer i's tensors are read): weights to
    f32, (out, in) transposed to (in, out), the rope output columns of
    q_proj and kv_a_proj_with_mqa permuted to the half-split layout
    (`_rope_permutation`), kv_b_proj cut into W_UK and W_UV per head, the
    experts stacked, the shared experts cut into n_shared experts of
    moe_d_ff after them, then cast to `dtype` (the router's weight in its
    own (E, d) layout; its bias f32)."""
    h, nope, lat = dims.n_head, dims.qk_nope_dim, dims.kv_lora_rank
    perm = _rope_permutation(dims.qk_rope_dim)
    p = f"model.layers.{i}"

    def raw(name):
        return sd[f"{p}.{name}"].detach().to(torch.float32)

    def put(x):
        return x.contiguous().to(device=device, dtype=dtype)

    q = raw("self_attn.q_proj.weight").view(h, dims.qk_head_dim, -1)
    q = torch.cat([q[:, :nope], q[:, nope:][:, perm]], 1).reshape(h * dims.qk_head_dim, -1)
    kva = raw("self_attn.kv_a_proj_with_mqa.weight")
    kva = torch.cat([kva[:lat], kva[lat:][perm]])
    kvb = raw("self_attn.kv_b_proj.weight").view(h, nope + dims.v_head_dim, lat)
    block = {
        "attn_norm": {"scale": put(raw("input_layernorm.weight"))},
        "q": {"w": put(q.T)}, "kv_a": {"w": put(kva.T)},
        "kv_norm": {"scale": put(raw("self_attn.kv_a_layernorm.weight"))},
        "kv_b": {"w_uk": put(kvb[:, :nope]), "w_uv": put(kvb[:, nope:].transpose(1, 2))},
        "out": {"w": put(raw("self_attn.o_proj.weight").T)},
        "mlp_norm": {"scale": put(raw("post_attention_layernorm.weight"))},
    }
    if i < dims.first_dense:
        block.update({n: {"w": put(raw(f"mlp.{n}_proj.weight").T)} for n in ("gate", "up", "down")})
        return block
    f, e = dims.moe_d_ff, dims.n_experts
    experts = {}
    for n, cut in (("gate", 0), ("up", 0), ("down", 1)):
        mats = [raw(f"mlp.experts.{j}.{n}_proj.weight").T for j in range(e)]
        mats += [part.T for part in raw(f"mlp.shared_experts.{n}_proj.weight").split(f, cut)]
        experts[n] = {"w": put(torch.stack(mats))}
        del mats
    block["router"] = {"w": put(raw("mlp.gate.weight")),
                       "bias": raw("mlp.gate.e_score_correction_bias").to(device),
                       "shared": torch.arange(e, e + dims.n_shared, device=device)}
    block["experts"] = experts
    return block


def params_from_hf_state_dict(sd: dict, dims: DeepseekV3Dims,
                              dtype: torch.dtype = torch.float32,
                              device: torch.device | str = "cpu") -> dict:
    """The port's parameter dict from a transformers DeepseekV3ForCausalLM
    state dict: `block_from_hf` for each layer, the embedding and the
    untied head."""
    def put(name, transpose=False):
        x = sd[name].detach().to(torch.float32)
        return (x.T if transpose else x).contiguous().to(device=device, dtype=dtype)

    return {"token_emb": put("model.embed_tokens.weight"),
            "blocks": [block_from_hf(sd, dims, i, dtype, device) for i in range(dims.n_layer)],
            "norm": {"scale": put("model.norm.weight")},
            "lm_head": {"w": put("lm_head.weight", True)}}
