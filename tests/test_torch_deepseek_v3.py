"""The port's DeepSeek-V3 decoder (models/deepseek_v3.py, Moonlight-16B-A3B's
architecture) against the plain float32 reference (tests/ref_deepseek_v3.py),
and the reference against transformers' DeepseekV3ForCausalLM, at a tiny
size on the CPU: 64 wide, 4 heads, a 32-wide latent, 16 rope dims, 8
routed experts (top 2) and a shared one, 3 layers with the first dense.

The JAX package has no such model, so the reference here is the plain
one. Tolerances, each with its reason:

* f32 weights and activations, the port against the reference: 1e-4 of
  the logits' scale. Both compute in f32; they part only in the order of
  their sums (absorbed against expanded attention, batched against
  per-head products), ~1e-6 measured;
* the Q4 path: the expert rows' W4A8 product against the chosen experts
  run one by one is exact (one rounding path); the int4 prefill against
  the dequantized weights in f32 within 2% (bf16 roundings of the int4
  kernels' inputs and weights, 0.8-0.9% measured), a layer at a time: a
  rounding ahead of a router can move a token's experts.
The CUDA kernels (int4_moe_s8, mla_attention) are held to their plain
versions on the card (`cuda`-marked tests here, and chip_smoke.py phase 17).
"""

import copy
import dataclasses
import importlib.util
import json
import pathlib

import pytest
import torch

from turbo_whisper_workspace_tpu_torch.config import LLMConfig, PipelineConfig
from turbo_whisper_workspace_tpu_torch.llm import generate
from turbo_whisper_workspace_tpu_torch.llm import llm_helper as lh
from turbo_whisper_workspace_tpu_torch.models import deepseek_v3 as ds
from turbo_whisper_workspace_tpu_torch.ops import mla_ops, moe_ops, quant
from turbo_whisper_workspace_tpu_torch.pipeline.audio_pipeline import AudioProcessingPipeline
from turbo_whisper_workspace_tpu_torch.utils import profiling

# the plain reference beside this file, by path: another package named
# `tests` on the path (the card's machine has one) must not shadow it
_spec = importlib.util.spec_from_file_location(
    "ref_deepseek_v3", pathlib.Path(__file__).with_name("ref_deepseek_v3.py"))
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)

CFG = {"model_type": "deepseek_v3", "vocab_size": 512, "hidden_size": 64,
       "num_hidden_layers": 3, "num_attention_heads": 4, "num_key_value_heads": 4,
       "kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 16, "v_head_dim": 16,
       "intermediate_size": 128, "moe_intermediate_size": 32, "n_routed_experts": 8,
       "n_shared_experts": 1, "num_experts_per_tok": 2, "first_k_dense_replace": 1,
       "routed_scaling_factor": 2.5, "rope_theta": 10000.0, "rms_norm_eps": 1e-5,
       "max_position_embeddings": 512, "norm_topk_prob": True, "n_group": 1, "topk_group": 1,
       "q_lora_rank": None, "tie_word_embeddings": False, "attention_bias": False}
# an expert width whose down projection takes int4 groups of 64 (K = 384:
# 128-row groups do not tile its halves), as Moonlight's K = 1408 does
Q4_CFG = {**CFG, "moe_intermediate_size": 384}
BIAS_STD = 0.05
F32_TOL = 1e-4


def state(cfg=CFG, seed=0):
    return ref.random_state_dict(cfg, torch.Generator().manual_seed(seed), bias_std=BIAS_STD)


@pytest.fixture(scope="module")
def model():
    sd = state()
    dims = ds.dims_from_hf_config(CFG)
    tokens = torch.randint(0, CFG["vocab_size"], (1, 20),
                           generator=torch.Generator().manual_seed(1))
    return sd, dims, ds.params_from_hf_state_dict(sd, dims), tokens, ref.forward(sd, CFG, tokens[0])


def close(got, want, tol=F32_TOL):
    assert (got - want).abs().max().item() <= tol * want.abs().max().item()


def rope_table(dims, device):
    """The (cos, sin) tables the forward rotates the rope dims by."""
    return ds.rope_table(dims.qk_rope_dim // 2, dims.rope_theta, dims.max_ctx, device)


def test_the_configs_hold_moonlights_published_widths():
    d = ds.DEEPSEEK_V3_CONFIGS["moonlight-16b-a3b"]
    assert (d.d_model, d.n_layer, d.n_head, d.kv_lora_rank, d.qk_head_dim, d.v_head_dim) == (
        2048, 27, 16, 512, 192, 128)
    assert (d.n_experts, d.top_k, d.n_shared, d.moe_d_ff, d.d_ff, d.first_dense) == (
        64, 6, 2, 1408, 11264, 1)
    assert d.cache_dim == mla_ops.LATENT + mla_ops.ROPE and d.n_vocab == 163840


def test_the_reference_is_transformers_deepseek_v3():
    transformers = pytest.importorskip("transformers")
    sd = state()
    hf = transformers.DeepseekV3ForCausalLM(transformers.DeepseekV3Config(**CFG)).eval()
    assert hf.load_state_dict(sd, strict=True)
    tokens = torch.arange(3, 23)
    with torch.no_grad():
        want = hf(tokens[None]).logits[0].float()
    # f32 both; the modeling code sums its experts in another order
    close(ref.forward(sd, CFG, tokens), want, 1e-4)


def test_forward_matches_the_reference(model):
    _, dims, params, tokens, want = model
    got, cache = ds.forward(params, dims, tokens)
    assert cache is None
    close(got[0], want)


def test_prefill_then_cached_decode_at_a_device_pos_matches_the_full_forward(model,
                                                                           monkeypatch):
    sd, dims, params, tokens, want = model
    cache = ds.init_kv_cache(dims, 1, 24, dtype=torch.float32)
    assert set(cache) == {"latent"} and cache["latent"].shape == (3, 1, 24, 48)
    # route's log, given as a caller that keeps the served choices gives it:
    # the ids of each expert layer's rows at their positions
    log, at = torch.zeros((2, 1, 24, 2), dtype=torch.int32), {"layer": -1}
    route = ds.route

    def logged(h, router, dims):
        at["layer"] += 1
        return route(h, router, dims, log[at["layer"] % 2], at["pos"])

    monkeypatch.setattr(ds, "route", logged)
    at["pos"] = 0
    logits, same = ds.forward(params, dims, tokens[:, :12], cache, 0)
    assert same is cache
    rows = [logits[0]]
    for i in range(12, 20):
        at["pos"] = torch.tensor(i)
        step, _ = ds.forward(params, dims, tokens[:, i:i + 1], cache, at["pos"])
        rows.append(step[0])
    close(torch.cat(rows), want)
    # rows past the last position stay unwritten
    assert not cache["latent"][:, :, 20:].any()
    # the router chose, prefill and decode, the experts the reference chooses
    chosen = ref.routing(sd, CFG, tokens[0])
    assert torch.equal(log[:, 0, :20].sort(-1).values, torch.stack(chosen).int())
    assert not log[:, :, 20:].any()


def test_absorbed_attention_equals_the_expanded_form():
    """The decode step's form (q_nope · W_UK over the latent rows, the
    output latent through W_UV) against the prefill's (k_nope and v formed
    per head), on the same rows and queries."""
    dims = ds.dims_from_hf_config(CFG)
    g = torch.Generator().manual_seed(3)
    h, nope, rope, lat, s_len = 4, 16, 16, 32, 10
    kv_b = {"w_uk": torch.randn(h, nope, lat, generator=g),
            "w_uv": torch.randn(h, lat, 16, generator=g)}
    latent = torch.randn(1, s_len, lat + rope, generator=g)
    q_nope = torch.randn(1, 1, h, nope, generator=g)
    q_pe = torch.randn(1, 1, h, rope, generator=g)
    cos, sin = rope_table(dims, "cpu")
    k_pe = torch.randn(1, 1, rope, generator=g)
    c_kv = torch.randn(1, 1, lat, generator=g)
    pos = s_len - 1
    absorbed_cache = latent.clone()
    q_lat = torch.einsum("bthn,hnc->bthc", q_nope, kv_b["w_uk"])
    o_lat = mla_ops.mla_attention_reference(q_lat, q_pe, c_kv, k_pe, cos, sin, absorbed_cache,
                                            pos, dims.qk_head_dim ** -0.5)
    absorbed = torch.einsum("bthc,hcv->bthv", o_lat, kv_b["w_uv"])
    expanded_cache = latent.clone()
    rows = tuple(t[pos:pos + 1][None, :, None, :] for t in (cos, sin))
    k_rot = ds.llama_ops.apply_rope(k_pe[:, :, None], *rows)[:, :, 0]
    expanded_cache[:, pos] = torch.cat([c_kv, k_rot], -1)[:, 0]
    expanded = ds._attend_expanded(q_nope, ds.llama_ops.apply_rope(q_pe, *rows), expanded_cache,
                                   kv_b, dims, pos, 1)
    assert torch.equal(absorbed_cache, expanded_cache)
    close(absorbed, expanded, 1e-5)


def test_mla_plan_holds_the_cells_slices_resident():
    """mla_attention's plan (ops/mla_ops.ranks, the kernel's mirror) at
    moonlight-enrich's caches, S = prompt + new tokens from 1208 + 200 to
    1798 + 256: a cluster of 16 ranks where the card holds one, and every
    position's largest slice resident (one pass); 8 ranks where it holds
    none; at S = 4096 the last positions' slices take a second round."""
    def slice_rows(pos, ranks):          # the largest of the pos + 1 visible rows' slices
        return -(-(pos + 1) // ranks)

    for s_len in range(1208 + 200, 1798 + 256 + 1):
        assert mla_ops.ranks(s_len, 1, 1) == mla_ops.WIDE_RANKS
        assert mla_ops.ranks(s_len, 1, 0) == mla_ops.PORTABLE_RANKS
        for pos in (0, 1207, s_len - 1):
            assert slice_rows(pos, mla_ops.WIDE_RANKS) <= mla_ops.RESIDENT_ROWS
    assert mla_ops.ranks(4096, 1, 1) == 16
    assert slice_rows(2559, 16) == mla_ops.RESIDENT_ROWS < slice_rows(2560, 16)
    assert slice_rows(4095, 16) == 256
    # more clusters than the card holds at 16 (or than one wave) take fewer ranks
    assert mla_ops.ranks(2048, 8, 7) == 8 and mla_ops.ranks(2048, 9, 9) == 8
    assert mla_ops.ranks(64, 1, 1) == 1 and mla_ops.ranks(100, 1, 1) == 2


def mla_cluster_mirror(q_lat, q_pe, c_kv, k_pe, cos, sin, cache, pos: int, scale: float,
                       ranks: int, resident: int = mla_ops.RESIDENT_ROWS):
    """csrc/mla_attention.cu's arithmetic in its order, in torch: the new
    row written and the queries rotated as the plain version does, the
    pos + 1 visible rows in `ranks` even slices, each slice in rounds of
    `resident` rows: f32 scores (log2 e folded into the scale), the
    round's exact max against the running one, weights exp2(s − m)
    rounded to bf16 and summed as rounded, f32 P·V rescaled between
    rounds; then each rank's share exp2(m_r − M) / Σ_r exp2(m_r − M) l_r
    of the f32 combine, one rounding."""
    b, _, h, lat = q_lat.shape
    rows = tuple(t[pos:pos + 1][None, :, None, :] for t in (cos, sin))
    q_rot = ds.llama_ops.apply_rope(q_pe, *rows)
    k_rot = ds.llama_ops.apply_rope(k_pe[:, :, None], *rows)[:, :, 0]
    cache[:, pos] = torch.cat([c_kv, k_rot], -1)[:, 0].to(cache.dtype)
    q = torch.cat([q_lat, q_rot], -1)[:, 0].float()                          # (B, H, 576)
    n = pos + 1
    width = -(-n // ranks)
    parts, maxes, sums = [], [], []
    for lo in range(0, ranks * width, width):
        m = torch.full((b, h, 1), -1e30)
        l = torch.zeros(b, h, 1)
        o = torch.zeros(b, h, lat)
        for r0 in range(lo, min(lo + width, n), resident):
            rows_r = cache[:, r0:min(r0 + resident, lo + width, n)].float()
            s = torch.einsum("bhd,bsd->bhs", q, rows_r) * (scale * 1.4426950408889634)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            w = torch.exp2(s - m_new).to(torch.bfloat16).float()
            alpha = torch.exp2(m - m_new)
            l = l * alpha + w.sum(-1, keepdim=True)
            o = o * alpha + torch.einsum("bhs,bsd->bhd", w, rows_r[..., :lat])
            m = m_new
        parts.append(o)
        maxes.append(m)
        sums.append(l)
    big = torch.stack(maxes).amax(0)
    f = [torch.exp2(m - big) for m in maxes]
    total = sum(fr * lr for fr, lr in zip(f, sums))
    out = sum((fr / total) * pr for fr, pr in zip(f, parts))
    return out[:, None].to(q_lat.dtype)


@pytest.mark.parametrize("ranks", [1, 8, 16])
def test_mla_cluster_arithmetic_holds_to_the_plain_version(ranks):
    """The kernel's split, per-slice exact softmax with bf16 weights and
    f32 combine (mla_cluster_mirror) at Moonlight's widths, at positions
    on and off the slices' edges and through a second round, within the
    card test's 5e-3 of the plain version; the cache row bit-equal. (The
    kernel itself is held to the plain version at these positions and
    ranks by the card's test_mla_attention_kernel_is_its_plain_version.)"""
    dims = ds.DEEPSEEK_V3_CONFIGS["moonlight-16b-a3b"]
    cos, sin = rope_table(dims, "cpu")
    bf = torch.bfloat16
    for s_len, pos in ((2048, 1023), (2048, 1024), (4096, 2560), (4096, 4095)):
        g = torch.Generator().manual_seed(ranks * 7 + pos)
        q_lat = torch.randn(1, 1, 16, 512, generator=g).to(bf)
        q_pe = torch.randn(1, 1, 16, 64, generator=g).to(bf)
        kv = torch.randn(1, 1, 576, generator=g).to(bf)
        cache = torch.randn(1, s_len, 576, generator=g).to(bf)
        args = (q_lat, q_pe, kv[..., :512], kv[..., 512:], cos, sin)
        c_got, c_want = cache.clone(), cache.clone()
        got = mla_cluster_mirror(*args, c_got, pos, dims.qk_head_dim ** -0.5, ranks)
        want = mla_ops.mla_attention_reference(*args, c_want, pos, dims.qk_head_dim ** -0.5)
        assert torch.equal(c_got, c_want), (s_len, pos)
        rel = ((got.float() - want.float()).norm() / want.float().norm()).item()
        assert rel <= 5e-3, (s_len, pos, rel)


def test_routing_matches_the_reference_and_the_bias_changes_the_choice(model):
    sd, dims, params, tokens, _ = model
    h = torch.randn(64, 64, generator=torch.Generator().manual_seed(5))
    p = "model.layers.1.mlp"
    chosen, w = ref.route(h, sd[f"{p}.gate.weight"], sd[f"{p}.gate.e_score_correction_bias"], CFG)
    ids, weights = ds.route(h, params["blocks"][1]["router"], dims)
    assert torch.equal(ids[:, :2].sort(-1).values, chosen.sort(-1).values)
    assert torch.equal(ids[:, 2:], torch.full((64, 1), 8))                 # the shared expert
    close(weights[:, :2].sort(-1).values, w.sort(-1).values, 1e-6)
    assert torch.equal(weights[:, 2:], torch.ones(64, 1))
    no_bias = dict(params["blocks"][1]["router"], bias=torch.zeros(8))
    unbiased = ds.route(h, no_bias, dims)[0][:, :2].sort(-1).values
    changed = (unbiased != ids[:, :2].sort(-1).values).any(-1).float().mean().item()
    assert 0.1 <= changed < 1.0, changed                # the bias selects for many tokens
    # it selects only: the weights stay the chosen experts' unbiased scores
    s = torch.sigmoid(h @ params["blocks"][1]["router"]["w"].T)
    picked = s.gather(-1, ids[:, :2])
    close(weights[:, :2], picked / picked.sum(-1, keepdim=True) * 2.5, 1e-6)


def test_the_loader_turns_interleaved_rope_into_the_half_split_layout(model):
    """Rotating the loader's permuted rope columns half-split gives the
    dot products of the modeling code's interleaved rotation; the columns
    loaded as they are would not."""
    g = torch.Generator().manual_seed(6)
    q, k = torch.randn(7, 1, 16, generator=g), torch.randn(7, 1, 16, generator=g)
    at = {"q": torch.arange(3, 10), "k": torch.arange(0, 7)}          # a query 3 after its key
    want = (ref.rope_interleaved(q, at["q"], 1e4) * ref.rope_interleaved(k, at["k"], 1e4)).sum(-1)
    perm = ds._rope_permutation(16)
    cos, sin = rope_table(ds.dims_from_hf_config(CFG), "cpu")

    def rotated(x, positions, permute):
        rows = tuple(t[positions][None, :, None, :] for t in (cos, sin))
        return ds.llama_ops.apply_rope((x[..., perm] if permute else x)[None], *rows)[0]

    dots = (rotated(q, at["q"], True) * rotated(k, at["k"], True)).sum(-1)
    close(dots, want, 1e-5)
    wrong = (rotated(q, at["q"], False) * rotated(k, at["k"], False)).sum(-1)
    assert (wrong - want).abs().max() > 1e-2
    # and the whole model loaded without the permutation parts from the reference
    sd, dims, params, tokens, want_logits = model
    flat = dataclasses.replace(dims)
    orig = ds._rope_permutation
    ds._rope_permutation = lambda r: torch.arange(r)
    try:
        wrong = ds.forward(ds.params_from_hf_state_dict(sd, flat), flat, tokens)[0][0]
    finally:
        ds._rope_permutation = orig
    assert (wrong - want_logits).abs().max() > 100 * F32_TOL * want_logits.abs().max()


@pytest.fixture(scope="module")
def q4():
    """The Q4 point on the group-64 config: q, kv_a, out, the dense SwiGLU
    and every expert int4, the head int8, kv_b and the router as they are;
    then the siblings fused as TorchLlama fuses them."""
    dims = ds.dims_from_hf_config(Q4_CFG)
    params = ds.params_from_hf_state_dict(state(Q4_CFG, 2), dims)
    return dims, params, quant.quantize_tree(copy.deepcopy(params), keys=ds.QUANT_KEYS, bits=4)


def dequantized(node):
    """Every int4 / int8 projection of a parameter tree back in f32."""
    if isinstance(node, list):
        return [dequantized(v) for v in node]
    if not isinstance(node, dict):
        return node
    if "w_q4" in node:
        lo, hi = quant._unpack_int4(node["w_q4"])
        w = torch.cat([lo, hi], -2).float()
        ng = node["scale4"].shape[-2]
        grouped = w.reshape(*w.shape[:-2], ng, w.shape[-2] // ng, w.shape[-1])
        return {"w": (grouped * node["scale4"].unsqueeze(-2)).reshape(w.shape)}
    if "w_q" in node:
        return {"w": node["w_q"].float() * node["scale"]}
    return {k: dequantized(v) for k, v in node.items()}


def test_the_q4_point_takes_group_64_for_the_experts_down(q4):
    dims, _, qp = q4
    experts = qp["blocks"][1]["experts"]
    assert experts["down"]["w_q4"].shape == (9, 192, 64)
    assert experts["down"]["scale4"].shape == (9, 384 // 64, 64)        # group 64
    assert experts["gate"]["scale4"].shape == (9, 2, 384)              # K = 64: group 32
    assert "w_q" in qp["lm_head"] and "w_uk" in qp["blocks"][0]["kv_b"]
    assert qp["blocks"][1]["router"]["w"].shape == (8, 64)          # not quantized
    fused = ds.fuse_siblings(copy.deepcopy(qp))
    assert set(fused["blocks"][1]) >= {"q_kv_a", "router", "kv_b"}
    assert set(fused["blocks"][1]["experts"]) == {"gate_up", "down"}
    assert fused["blocks"][1]["experts"]["gate_up"]["w_q4"].shape == (9, 32, 768)
    assert set(fused["blocks"][0]) >= {"q_kv_a", "gate_up", "down"}


def test_the_w4a8_expert_rows_equal_the_experts_run_one_by_one(q4):
    """At decode rows (their quantized input given), the experts' rows
    as two int4_moe_s8 products equal each chosen expert run alone at
    W4A8 and summed with the router's weights."""
    dims, _, qp = q4
    block = ds.fuse_siblings(copy.deepcopy(qp))["blocks"][1]
    h = torch.randn(2, 64, generator=torch.Generator().manual_seed(7))
    groups = block["experts"]["gate_up"]["scale4"].shape[-2]
    rows = ds.moe(h, quant.quant_act_grouped(h, groups), block, dims, 1)
    ids, weights = ds.route(h, block["router"], dims)
    alone = torch.stack([torch.cat([ds._expert_swiglu(h[t:t + 1], block["experts"], int(e))
                                    for e in ids[t]]) for t in range(2)])
    want = torch.bmm(weights[:, None], alone.float())[:, 0].to(h.dtype)
    assert torch.equal(rows, want)


def test_the_int4_prefill_is_the_dequantized_model(q4):
    """The dense layer's forward, and an expert layer's sum over prefill
    rows on the same routing (the router reads h itself: a rounding of
    the hidden state ahead of it can move a token's choice, and then the
    logits by far more than the rounding)."""
    dims, _, qp = q4
    dq = dequantized(qp)
    tokens = torch.arange(5, 25)[None]
    one = dataclasses.replace(dims, n_layer=1)
    got = ds.forward(dict(qp, blocks=qp["blocks"][:1]), one, tokens)[0]
    want = ds.forward(dict(dq, blocks=dq["blocks"][:1]), one, tokens)[0]
    assert ((got - want).norm() / want.norm()).item() <= 2e-2
    h = torch.randn(20, 64, generator=torch.Generator().manual_seed(11))
    grouped = ds.fuse_siblings(copy.deepcopy(qp))["blocks"][1]        # int4_group_matmul
    want = ds.moe(h, None, dq["blocks"][1], dims, 1)
    for block in (grouped, qp["blocks"][1]):                  # and one matmul an expert
        got = ds.moe(h, None, block, dims, 1)
        assert ((got - want).norm() / want.norm()).item() <= 2e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [1, 4])
def test_fused_siblings_forward_equals_separate(dtype, batch):
    """A test-tiny model of dense layers at Q4: the prefill and a decode
    step at m = 1 and m = 4 give the same logits and latent cache, bit
    for bit, with q|kv_a and gate|up fused (the experts' fusion changes
    their kernels' route; the test above holds those)."""
    dims = dataclasses.replace(ds.DEEPSEEK_V3_CONFIGS["test-tiny"], first_dense=3)
    params = quant.quantize_tree(ds.init_params(dims, torch.Generator().manual_seed(0), dtype),
                                 keys=ds.QUANT_KEYS, bits=4)
    fused = ds.fuse_siblings(copy.deepcopy(params))
    assert all({"q_kv_a", "gate_up"} <= set(b) and "q" not in b for b in fused["blocks"])
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, dims.n_vocab, (batch, 12), generator=gen)
    step = torch.randint(0, dims.n_vocab, (batch, 1), generator=gen)
    runs = []
    for p in (fused, params):
        cache = ds.init_kv_cache(dims, batch, 16, dtype=dtype)
        prefill, _ = ds.forward(p, dims, tokens, cache, pos=0)
        logits, _ = ds.forward(p, dims, step, cache, pos=12)
        runs.append((prefill, logits, cache["latent"]))
    assert all(torch.equal(got, ref) for got, ref in zip(*runs))


def test_int4_group_matmul_tiles_and_plain_version():
    assert quant.group_tiles([70, 0, 3]) == [(0, 0, 64), (0, 64, 6), (2, 70, 3)]
    g = torch.Generator().manual_seed(12)
    w = quant.quantize_int4(torch.randn(3, 128, 32, generator=g), group=32)
    x = torch.randn(9, 128, generator=g)
    gate, up = quant.int4_group_matmul(x, w["w_q4"], w["scale4"], [4, 0, 5], split=True)
    for e, rows in ((0, slice(0, 4)), (2, slice(4, 9))):
        want = quant.int4_matmul_reference(x[rows], w["w_q4"][e], w["scale4"][e])
        assert torch.equal(torch.cat([gate[rows], up[rows]], -1), want)


def test_int4_moe_s8_plain_version_is_int4_matmul_s8_row_by_row():
    g = torch.Generator().manual_seed(8)
    w = quant.quantize_int4(torch.randn(5, 128, 24, generator=g), group=32)
    xq, xs = quant.quant_act_grouped(torch.randn(2, 128, generator=g), 4)
    ids = torch.tensor([4, 0, 9, 2])                     # 9 reads the last expert
    got = quant.int4_moe_s8(xq, xs, w["w_q4"], w["scale4"], ids, x_div=2)
    for r, e in enumerate((4, 0, 4, 2)):
        want = quant.int4_matmul_s8_reference(xq[r // 2:r // 2 + 1], xs[r // 2:r // 2 + 1],
                                              w["w_q4"][e], w["scale4"][e])
        assert torch.equal(got[r:r + 1], want)
    gate, up = quant.int4_moe_s8(xq, xs, w["w_q4"], w["scale4"], ids, x_div=2, split=True)
    assert torch.equal(torch.cat([gate, up], -1), got)


def test_generate_tokens_runs_the_family_and_matches_greedy_full_forwards(model):
    sd, dims, params, tokens, _ = model
    prompt = tokens[:, :8]
    res = generate.generate_tokens(params, dims, prompt, max_len=6, graphed=False)
    seq = prompt[0].tolist()
    for _ in range(6):
        seq.append(int(ref.forward(sd, CFG, torch.tensor(seq))[-1].argmax()))
    assert res.tokens[0].tolist() == seq and int(res.lengths[0]) == 6


def test_the_stage_methods_reach_the_model_from_a_checkpoint(tmp_path, monkeypatch):
    """A transformers DeepseekV3 checkpoint on disk: get_llm dispatches on
    its model_type, quantizes it at the Q4 point with this family's keys,
    and the pipeline's three stage methods generate through it."""
    transformers = pytest.importorskip("transformers")
    path = tmp_path / "ckpt"
    hf = transformers.DeepseekV3ForCausalLM(transformers.DeepseekV3Config(**CFG))
    hf.load_state_dict(state())
    hf.save_pretrained(path)
    assert json.loads((path / "config.json").read_text())["model_type"] == "deepseek_v3"
    monkeypatch.setenv("LLM_MODEL_PATH", str(path))
    monkeypatch.chdir(tmp_path)
    lh.set_llm(None)
    calls = []
    original = generate.generate_tokens

    def tap(params, dims, prompt, **kw):
        calls.append(type(dims))
        return original(params, dims, prompt, **kw)

    monkeypatch.setattr(generate, "generate_tokens", tap)
    try:
        llm = lh.get_llm(LLMConfig(model="none"), device="cpu")
        assert isinstance(llm, lh.TorchLlama) and isinstance(llm.dims, ds.DeepseekV3Dims)
        assert "w_q4" in llm.params["blocks"][1]["experts"]["gate_up"]
        assert "w_q4" in llm.params["blocks"][0]["q_kv_a"] and "w_q" in llm.params["lm_head"]
        pipe = AudioProcessingPipeline(PipelineConfig(llm=LLMConfig(
            max_tokens_names=3, max_tokens_summary=3, max_tokens_topics=3)), device="cpu")
        segments = [{"speaker": f"Speaker {i % 2}", "text": "hello there", "start": i,
                     "end": i + 1} for i in range(4)]
        pipe.identify_speaker_names(segments)
        pipe.generate_summary(segments)
        pipe.extract_topics(segments)
    finally:
        lh.set_llm(None)
    assert calls == [ds.DeepseekV3Dims] * 3


def test_the_prefill_counts_routed_tokens_and_spans_the_experts_under_the_profiler(q4):
    dims, _, qp = q4
    tokens = torch.arange(20)[None]
    assert profiling.counter(ds.ROUTED_COUNTER, (3, 8), "cpu") is None     # profiler off
    profiling.clear_spans()
    with torch.profiler.profile():
        ds.forward(qp, dims, tokens)
    counts = profiling.counters()[ds.ROUTED_COUNTER]
    assert counts.shape == (3, 8) and not counts[0].any()                 # layer 0 is dense
    assert counts[1:].sum(-1).tolist() == [20 * 2, 20 * 2]               # top 2 of each token
    assert [s.name for s in profiling.spans()].count("moe.experts") == 2
    profiling.clear_spans()
    assert not profiling.counters()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs these checks on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_int4_moe_s8_kernel_is_its_plain_version(cuda_device):
    g = torch.Generator(cuda_device).manual_seed(9)
    for rows, x_div, k, n, group, split in ((8, 8, 2048, 2816, 128, True),
                                            (8, 1, 1408, 2048, 64, False),
                                            (1, 1, 1408, 2048, 64, False)):
        w = quant.quantize_int4(torch.randn(66, k, n, generator=g, device=cuda_device), group=group)
        xq, xs = quant.quant_act_grouped(
            torch.randn(rows // x_div, k, generator=g, device=cuda_device), k // group)
        ids = torch.randperm(66, generator=g, device=cuda_device)[:rows]
        args = (xq, xs, w["w_q4"], w["scale4"], ids)
        got = quant.int4_moe_s8(*args, x_div=x_div, split=split)
        want = quant.int4_moe_s8_reference(*args, x_div=x_div, split=split)
        for a, b in zip(got if split else (got,), want if split else (want,)):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_takes_fused_int4_experts_alone(cuda_device):
    """int8 (or dense) experts read their rows' counts on the host, which
    the graphed decode step cannot: the expert layer refuses them on the
    card, at the prefill's rows as at a step's, with the reason."""
    dims = ds.DEEPSEEK_V3_CONFIGS["test-tiny"]
    params = ds.init_params(dims, torch.Generator(cuda_device).manual_seed(0),
                            dtype=torch.bfloat16, device=cuda_device)
    for bits in (None, 8):
        held = params if bits is None else quant.quantize_tree(params, keys=ds.QUANT_KEYS,
                                                               bits=bits)
        block = ds.fuse_siblings(copy.deepcopy(held))["blocks"][1]
        for rows in (1, 5):
            h = torch.zeros(rows, dims.d_model, dtype=torch.bfloat16, device=cuda_device)
            with pytest.raises(ValueError, match="fused int4 experts alone"):
                ds.moe(h, None, block, dims, 1)


@pytest.mark.cuda
def test_mla_attention_kernel_is_its_plain_version(cuda_device):
    """At S = 2048, 2056 (the cell's longest) and 4096 (slices past the
    resident rows: a second round), at position 0, a slices' edge and S −
    1; at S = 64 (one rank) and 100 (two); at 8 batch rows (more clusters
    than the card holds at 16 ranks: the portable 8); the ranks the
    library launches with are its mirror's; one launch captured in a
    graph at one position and replayed at another."""
    g = torch.Generator(cuda_device).manual_seed(10)
    dims = ds.DEEPSEEK_V3_CONFIGS["moonlight-16b-a3b"]
    cos, sin = rope_table(dims, cuda_device)
    bf = torch.bfloat16
    scale = 192 ** -0.5

    def inputs(s_len, b=1):
        q_lat = torch.randn(b, 1, 16, 512, generator=g, device=cuda_device).to(bf)
        q = torch.randn(b, 1, 16, 192, generator=g, device=cuda_device).to(bf)
        kv = torch.randn(b, 1, 576, generator=g, device=cuda_device).to(bf)
        cache = torch.randn(b, s_len, 576, generator=g, device=cuda_device).to(bf)
        return (q_lat, q[..., 128:], kv[..., :512].contiguous(), kv[..., 512:], cos, sin), cache

    def check(got, want, c_got, c_want, what):
        assert torch.equal(c_got, c_want), what
        # the kernel rounds the softmax weights to bf16 for P·V
        rel = ((got.float() - want.float()).norm() / want.float().norm()).item()
        assert rel <= 5e-3, (what, rel)

    wide = mla_ops.kernel_wide_clusters()
    assert mla_ops.ranks(64, 1, wide) == 1 and mla_ops.ranks(100, 1, wide) == 2
    if wide < 8:
        assert mla_ops.ranks(2048, 8, wide) == mla_ops.PORTABLE_RANKS
    for b, s_len, positions in ((1, 2048, (0, 700, 1023, 2047)), (1, 2056, (0, 1279, 2055)),
                                (1, 4096, (0, 2559, 2560, 4095)), (1, 64, (63,)),
                                (1, 100, (70,)), (8, 2048, (1500,))):
        assert mla_ops.kernel_ranks(s_len, b) == mla_ops.ranks(s_len, b, wide)
        for pos in positions:
            args, cache = inputs(s_len, b)
            c_got, c_want = cache.clone(), cache.clone()
            got = mla_ops.mla_attention(*args, c_got, torch.tensor(pos, device=cuda_device),
                                        scale)
            want = mla_ops.mla_attention_reference(*args, c_want, pos, scale)
            check(got, want, c_got, c_want, (b, s_len, pos))
    args, cache = inputs(2056)
    at = torch.tensor(10, device=cuda_device)
    c_got, c_want = cache.clone(), cache.clone()
    mla_ops.mla_attention(*args, cache.clone(), at, scale)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = mla_ops.mla_attention(*args, c_got, at, scale)
    at.fill_(2000)
    graph.replay()
    want = mla_ops.mla_attention_reference(*args, c_want, 2000, scale)
    check(got, want, c_got, c_want, "graph")


@pytest.mark.cuda
def test_moe_route_kernel_is_its_plain_version(cuda_device):
    from turbo_whisper_workspace_tpu_torch.ops import moe_ops

    g = torch.Generator(cuda_device).manual_seed(11)
    h = torch.randn(64, 2048, generator=g, device=cuda_device).bfloat16()
    w = (torch.randn(64, 2048, generator=g, device=cuda_device) * 2048 ** -0.5).bfloat16()
    bias = torch.randn(64, generator=g, device=cuda_device) * 0.01
    args = (h, w, bias, torch.arange(64, 66, device=cuda_device), 6, 2.446)
    ids, wt = moe_ops.moe_route(*args)
    want_ids, want_wt = moe_ops.moe_route_reference(*args)
    choice = (torch.sigmoid(h.float() @ w.float().T) + bias).sort(-1, descending=True).values
    # a choice between scores that tie to an ulp may differ (f32 sums in another order)
    same = (ids == want_ids).all(-1)
    assert bool((same | ((choice[:, 5] - choice[:, 6]) < 1e-5)).all())
    torch.testing.assert_close(wt[same], want_wt[same], rtol=1e-6, atol=0)
    # the log: 2 batch rows of 32 written at a device position
    log = torch.full((2, 40, 6), -1, dtype=torch.int32, device=cuda_device)
    at = torch.tensor(5, device=cuda_device)
    assert torch.equal(moe_ops.moe_route(*args, log=log, pos=at)[0], ids)
    assert torch.equal(log[:, 5:37], ids[:, :6].view(2, 32, 6).int())
    assert (log[:, :5] == -1).all() and (log[:, 37:] == -1).all()


@pytest.mark.cuda
def test_int4_group_matmul_kernel_is_its_plain_version(cuda_device):
    g = torch.Generator(cuda_device).manual_seed(13)
    counts = [100, 0, 1, 64, 200, 7]
    for k, n, group, split in ((2048, 2816, 128, True), (1408, 2048, 64, False)):
        w = quant.quantize_int4(torch.randn(6, k, n, generator=g, device=cuda_device), group=group)
        x = torch.randn(sum(counts), k, generator=g, device=cuda_device).bfloat16()
        got = quant.int4_group_matmul(x, w["w_q4"], w["scale4"], counts, split=split)
        want = quant.int4_group_matmul_reference(x, w["w_q4"], w["scale4"], counts, split=split)
        for a, b in zip(got if split else (got,), want if split else (want,)):
            # f32 sums in another order: a bf16 rounding apart at most
            rel = ((a.float() - b.float()).norm() / b.float().norm()).item()
            assert rel <= 2e-3, rel


@pytest.mark.parametrize("module", [mla_ops, moe_ops], ids=lambda m: m.__name__.split(".")[-1])
def test_new_wrappers_pass_their_c_signature_and_count_only_launches(module):
    """Each wrapper passes as many arguments as its C signature declares,
    and on the CPU (its plain version) counts no launch."""
    import ast

    from turbo_whisper_workspace_tpu_torch.ops import build

    tree = ast.parse(pathlib.Path(module.__file__).read_text())
    calls = {c.args[0].value: len(c.args) - 1 for c in ast.walk(tree)
             if isinstance(c, ast.Call) and getattr(c.func, "attr", "") == "launch"}
    assert calls == {n: len(build.SIGNATURES[n]) for n in module.launch_counts}
    module.reset_launch_counts()
    dims = ds.DEEPSEEK_V3_CONFIGS["test-tiny"]
    ds.forward(ds.init_params(dims, torch.Generator().manual_seed(0)), dims,
               torch.arange(3)[None], ds.init_kv_cache(dims, 1, 4, torch.float32), 0)
    assert module.launch_counts == dict.fromkeys(module.launch_counts, 0)
