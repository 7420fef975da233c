"""Port Llama (turbo_whisper_workspace_tpu_torch/models/llama.py and the
Llama half of models/convert.py) against the JAX package.

Both packages run the same test-tiny weights (the JAX init, carried over
by `llama_from_jax_params`) on the same numpy tokens in f32. The port
routes quantized projections as the JAX package does on the TPU
(`ops/quant.matmul_any`), so for int8 and int4 weights the JAX forward
runs with its `matmul_any` replaced by that route, Pallas kernels in
interpret mode; the JAX CPU route differs (int4 always through its XLA
twin, int8 always through the Pallas kernel).

Tolerances, relative L2: dense and int4 weights 1e-5 (measured: int4
within 5e-8). int8 1e-2 (measured: prefill 4.8e-4, step 7.4e-3): its m
≤ 8 route rounds every projection's output to bf16, and int8_matmul
rounds x to bf16, so the ~1e-7 f32 differences the two frameworks'
norms and softmaxes leave flip the odd rounding, and the flips
propagate (4.4e-3 at the step); and XLA, compiling the JAX layer scan,
skips some of those roundings (excess precision). The witness is
`test_int8_gap_is_rounding_of_projection_inputs`: with JAX keeping its
roundings and the port fed the JAX input at every projection, the int8
forward agrees within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turbo_whisper_workspace_tpu.models import llama as jlm
from turbo_whisper_workspace_tpu.ops import quant as jq
from turbo_whisper_workspace_tpu_torch.models import convert
from turbo_whisper_workspace_tpu_torch.models import llama as tlm
from turbo_whisper_workspace_tpu_torch.ops import quant as tq

from test_torch_quant import rel_l2, tpu_route

DIMS = jlm.LLAMA_CONFIGS["test-tiny"]
TDIMS = tlm.LLAMA_CONFIGS["test-tiny"]
FORWARD_TOL = 1e-5           # relative L2, f32 on both sides
# per weight kind; int8: the odd bf16 rounding flips (above)
KIND_TOL = {"dense": FORWARD_TOL, "int4": FORWARD_TOL, "int8": 1e-2}


@pytest.fixture
def jax_tpu_route(monkeypatch):
    """JAX's lm.forward imports matmul_any at call time, so the patch
    reaches it; cleared caches keep an earlier trace from being reused."""
    jax.clear_caches()
    monkeypatch.setattr(jq, "matmul_any", tpu_route)
    yield
    jax.clear_caches()


_PARAMS: dict = {}


def jax_params(kind: str):
    """The JAX test-tiny weights (seed 0), dense or quantized."""
    if kind not in _PARAMS:
        params = jlm.init_params(DIMS, jax.random.PRNGKey(0))
        if kind != "dense":
            params = jq.quantize_tree(params, bits={"int8": 8, "int4": 4}[kind])
        _PARAMS[kind] = params
    return _PARAMS[kind]


@pytest.mark.parametrize("kind", ["dense", "int8", "int4"])
@pytest.mark.parametrize("phase", ["prefill", "step"])
def test_forward_matches_jax(kind, phase, jax_tpu_route):
    params = jax_params(kind)
    tparams = convert.llama_from_jax_params(params, TDIMS)
    tokens = np.random.default_rng(1).integers(0, DIMS.n_vocab, (2, 9))
    jcache = jlm.init_kv_cache(DIMS, 2, max_len=12, dtype=jnp.float32)
    tcache = tlm.init_kv_cache(TDIMS, 2, max_len=12, dtype=torch.float32)
    # prefill at m = 18 rows (int4_matmul / int8_matmul), then one step at
    # m = 2 (int4_matmul_s8 / the dequant matmul)
    ref, jcache = jlm.forward(params, DIMS, jnp.asarray(tokens), jcache, pos=0)
    got, tcache = tlm.forward(tparams, TDIMS, torch.from_numpy(tokens), tcache, pos=0)
    if phase == "step":
        step = np.array([[7], [300]])
        ref, jcache = jlm.forward(params, DIMS, jnp.asarray(step), jcache, pos=9)
        got, tcache = tlm.forward(tparams, TDIMS, torch.from_numpy(step), tcache, pos=9)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert rel_l2(got.numpy(), ref) <= KIND_TOL[kind]
    assert rel_l2(tcache["k"].numpy(), jcache["k"]) <= KIND_TOL[kind]


def test_int8_gap_is_rounding_of_projection_inputs(jax_tpu_route, monkeypatch):
    """The int8 forward's gap to JAX comes from where bf16 roundings
    fall, not from the port's math. JAX runs compiled to keep every
    rounding it writes (XLA otherwise takes excess precision inside the
    layer scan, which alone moves an m ≤ 8 int8 projection by ~2e-3),
    recording each projection's input and output. Given the JAX input at
    every projection, the port's prefill and step logits agree within
    1e-5. Run on its own inputs, the port meets a projection whose input
    is within 1e-6 of JAX's and whose output is not within 1e-5: one
    bf16 rounding flipped."""
    params = jax_params("int8")
    seen = []

    def recording(x, wp):
        out = tpu_route(x, wp)
        jax.debug.callback(lambda *v: seen.append(tuple(map(np.array, v))), x, out,
                           ordered=True)
        return out

    monkeypatch.setattr(jq, "matmul_any", recording)
    forward = jax.jit(lambda p, tok, c, pos: jlm.forward(p, DIMS, tok, c, pos),
                      static_argnums=3, compiler_options={"xla_allow_excess_precision": False})
    tokens, step = np.random.default_rng(1).integers(0, DIMS.n_vocab, (2, 9)), np.array([[7], [300]])
    jcache = jlm.init_kv_cache(DIMS, 2, max_len=12, dtype=jnp.float32)
    ref, jcache = forward(params, jnp.asarray(tokens), jcache, 0)
    ref_step, _ = forward(params, jnp.asarray(step), jcache, 9)
    jax.effects_barrier()
    assert len(seen) == 2 * (7 * DIMS.n_layer + 1)

    tparams = convert.llama_from_jax_params(params, TDIMS)
    matmul_any = tq.matmul_any
    for fed in (True, False):
        calls, gaps = iter(seen), []

        def projection(x, wp, act=None):
            assert act is None                     # int8 weights: no shared quantized input
            x_jax, out_jax = next(calls)
            out = matmul_any(torch.from_numpy(x_jax) if fed else x, wp)
            gaps.append((rel_l2(x.numpy(), x_jax), rel_l2(out.numpy(), out_jax)))
            return out

        monkeypatch.setattr(tq, "matmul_any", projection)
        tcache = tlm.init_kv_cache(TDIMS, 2, max_len=12, dtype=torch.float32)
        got, tcache = tlm.forward(tparams, TDIMS, torch.from_numpy(tokens), tcache, pos=0)
        got_step, _ = tlm.forward(tparams, TDIMS, torch.from_numpy(step), tcache, pos=9)
        assert len(gaps) == len(seen)
        if fed:
            assert rel_l2(got.numpy(), ref) <= FORWARD_TOL
            assert rel_l2(got_step.numpy(), ref_step) <= FORWARD_TOL
        else:
            assert rel_l2(got_step.numpy(), ref_step) > FORWARD_TOL
            assert any(gin <= 1e-6 and gout > FORWARD_TOL for gin, gout in gaps)


def test_forward_without_cache_matches_jax():
    params = jax_params("dense")
    tokens = np.random.default_rng(2).integers(0, DIMS.n_vocab, (1, 6))
    ref, cache = jlm.forward(params, DIMS, jnp.asarray(tokens))
    got, tcache = tlm.forward(convert.llama_from_jax_params(params, TDIMS), TDIMS,
                              torch.from_numpy(tokens))
    assert cache is None and tcache is None
    assert rel_l2(got.numpy(), ref) <= FORWARD_TOL


def test_incremental_matches_full():
    """Cached steps, the cache written in place, equal the full forward."""
    tparams = convert.llama_from_jax_params(jax_params("dense"), TDIMS)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, DIMS.n_vocab, (2, 7)))
    full, _ = tlm.forward(tparams, TDIMS, tokens)
    cache = tlm.init_kv_cache(TDIMS, 2, max_len=7, dtype=torch.float32)
    k_buf = cache["k"]
    steps = []
    for t in range(7):
        logits, cache = tlm.forward(tparams, TDIMS, tokens[:, t:t + 1], cache, pos=t)
        steps.append(logits[:, 0])
    assert cache["k"] is k_buf
    torch.testing.assert_close(torch.stack(steps, 1), full, atol=1e-4, rtol=1e-4)


def test_rope_and_rms_norm_match_jax():
    """RoPE at positions up to 2047 (f32 angles from f64 frequencies
    cast to f32), as the forward rotates: rows of the cached tables, and
    RMSNorm, in f32."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 2048, 2, 128)).astype(np.float32)
    positions = np.arange(2048)
    ref = np.asarray(jlm._rope(jnp.asarray(x), jnp.asarray(positions), 500000.0))
    rows = tuple(tab.index_select(0, torch.from_numpy(positions))[None, :, None, :]
                 for tab in tlm.rope_table(64, 500000.0, 2048, "cpu"))
    got = tlm.llama_ops.apply_rope(torch.from_numpy(x), *rows)
    assert rel_l2(got.numpy(), ref) <= FORWARD_TOL
    scale = rng.standard_normal(128).astype(np.float32)
    ref = np.asarray(jlm.rms_norm(jnp.asarray(x), {"scale": jnp.asarray(scale)}, 1e-5))
    got = tlm.rms_norm(torch.from_numpy(x), {"scale": torch.from_numpy(scale)}, 1e-5)
    assert rel_l2(got.numpy(), ref) <= FORWARD_TOL


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_llama_from_jax_params_carries_quantized_bytes(kind):
    params = jax_params(kind)
    tparams = convert.llama_from_jax_params(params, TDIMS, dtype=torch.bfloat16)
    assert len(tparams["blocks"]) == DIMS.n_layer
    for li, block in enumerate(tparams["blocks"]):
        for name, proj in block.items():
            for key, val in proj.items():
                ref = np.asarray(params["blocks"][name][key][li])
                if key in ("w_q", "w_q4", "scale", "scale4") and name not in (
                        "attn_norm", "mlp_norm"):
                    assert val.dtype == {"w_q": torch.int8, "w_q4": torch.int8}.get(
                        key, torch.float32)
                    np.testing.assert_array_equal(val.numpy(), ref)
                else:
                    assert val.dtype == torch.bfloat16
    np.testing.assert_array_equal(tparams["lm_head"]["w_q"].numpy(),
                                  np.asarray(params["lm_head"]["w_q"]))
    assert tparams["token_emb"].dtype == torch.bfloat16


@pytest.mark.parametrize("bits", [4, 8])
def test_quantized_bf16_init_matches_jax_quantize_tree(bits):
    """The full-width model on the card is quantize_tree(init_params(…,
    bf16)): it quantizes the bf16 weights bit-equal to the JAX package's
    quantize_tree of the same bf16 values."""
    dense = tlm.init_params(TDIMS, torch.Generator().manual_seed(0), torch.bfloat16)
    got = tq.quantize_tree(dense, bits=bits)
    jax_tree = {"blocks": {name: {"w": np.stack([b[name]["w"].float().numpy()
                                                 for b in dense["blocks"]])}
                           for name in tlm.PROJECTIONS},
                "lm_head": {"w": dense["lm_head"]["w"].float().numpy()}}
    ref = jq.quantize_tree(jax_tree, bits=bits)
    for name in tlm.PROJECTIONS:
        assert set(got["blocks"][0][name]) == set(ref["blocks"][name])
        for key, val in ref["blocks"][name].items():
            for li, block in enumerate(got["blocks"]):
                np.testing.assert_array_equal(block[name][key].numpy(), np.asarray(val[li]))
    for key, val in ref["lm_head"].items():
        np.testing.assert_array_equal(got["lm_head"][key].numpy(), np.asarray(val))
    assert ("w_q4" if bits == 4 else "w_q") in got["blocks"][0]["q"]
    assert "w_q" in got["lm_head"] and got["token_emb"].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_hf_state_dict_matches_jax(dtype):
    transformers = pytest.importorskip("transformers")
    cfg = transformers.LlamaConfig(
        vocab_size=DIMS.n_vocab, hidden_size=DIMS.d_model,
        num_hidden_layers=DIMS.n_layer, num_attention_heads=DIMS.n_head,
        num_key_value_heads=DIMS.n_kv_head, intermediate_size=DIMS.d_ff,
        rope_theta=DIMS.rope_theta, rms_norm_eps=DIMS.norm_eps,
        max_position_embeddings=DIMS.max_ctx, tie_word_embeddings=False)
    torch.manual_seed(3)
    sd = transformers.LlamaForCausalLM(cfg).state_dict()
    ref = jlm.params_from_hf_state_dict(sd, DIMS, dtype=getattr(jnp, dtype))
    got = tlm.params_from_hf_state_dict(sd, TDIMS, dtype=getattr(torch, dtype))
    for name in ("token_emb",):
        np.testing.assert_array_equal(got[name].float().numpy(),
                                      np.asarray(ref[name], np.float32))
    np.testing.assert_array_equal(got["lm_head"]["w"].float().numpy(),
                                  np.asarray(ref["lm_head"]["w"], np.float32))
    for li, block in enumerate(got["blocks"]):
        for name, proj in block.items():
            for key, val in proj.items():
                assert val.dtype == getattr(torch, dtype) and val.is_contiguous()
                np.testing.assert_array_equal(
                    val.float().numpy(), np.asarray(ref["blocks"][name][key][li], np.float32))


# ---------------------------------------------------------------------------
# Fused sibling projections (models/llama.py:fuse_siblings): q|k|v and
# gate|up as one int4 weight each, the forward splitting the output

GQA_DIMS = tlm.LlamaDims(n_vocab=256, d_model=256, n_layer=2, n_head=8, n_kv_head=2,
                         d_ff=512, max_ctx=64)       # 4 query heads a kv head


def gqa_int4_params(dtype=torch.bfloat16):
    return tq.quantize_tree(tlm.init_params(GQA_DIMS, torch.Generator().manual_seed(0), dtype),
                            bits=4)


def prefill_and_step(params, dtype, batch):
    """Logits of a 12-token prefill (m = 12·batch: int4_matmul) and of a
    decode step after it (m = batch: int4_matmul_s8), and the cache."""
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, GQA_DIMS.n_vocab, (batch, 12), generator=gen)
    step = torch.randint(0, GQA_DIMS.n_vocab, (batch, 1), generator=gen)
    cache = tlm.init_kv_cache(GQA_DIMS, batch, 16, dtype=dtype)
    prefill, _ = tlm.forward(params, GQA_DIMS, tokens, cache, pos=0)
    logits, _ = tlm.forward(params, GQA_DIMS, step, cache, pos=12)
    return prefill, logits, cache


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [1, 4])
def test_fused_siblings_forward_equals_separate(dtype, batch):
    """The prefill and a decode step at m = 1 and m = 4 give the same
    logits and cache, bit for bit, with the siblings fused: each output
    column's sums do not depend on the columns beside it."""
    params = gqa_int4_params(dtype)
    fused = tlm.fuse_siblings(gqa_int4_params(dtype))
    assert all("qkv" in b and "gate_up" in b for b in fused["blocks"])
    got = prefill_and_step(fused, dtype, batch)
    ref = prefill_and_step(params, dtype, batch)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert all(torch.equal(got[2][n], ref[2][n]) for n in ("k", "v"))


def test_fusion_holds_the_siblings_side_by_side_and_releases_them():
    """After fusion a block holds q|k|v and gate|up, their columns side by
    side, and no separate q, k, v, gate or up: nothing keeps those alive."""
    import gc
    import weakref

    params = gqa_int4_params()
    want = [{fused: {key: torch.cat([b[n][key] for n in names], dim=1)
                     for key in ("w_q4", "scale4")} for fused, names in tlm.SIBLINGS.items()}
            for b in params["blocks"]]
    outs = [b["out"]["w_q4"] for b in params["blocks"]]
    separate = [weakref.ref(b[n][key]) for b in params["blocks"]
                for n in ("q", "k", "v", "gate", "up") for key in ("w_q4", "scale4")]
    assert tlm.fuse_siblings(params) is params
    gc.collect()
    assert all(r() is None for r in separate)
    for block, expect, out in zip(params["blocks"], want, outs):
        assert set(block) == {"qkv", "out", "gate_up", "down", "attn_norm", "mlp_norm"}
        for fused, weights in expect.items():
            assert set(block[fused]) == {"w_q4", "scale4"}
            assert all(torch.equal(block[fused][k], w) for k, w in weights.items())
        assert block["out"]["w_q4"] is out
    tlm.fuse_siblings(params)                       # a second call changes nothing
    assert all(torch.equal(b["qkv"]["w_q4"], e["qkv"]["w_q4"])
               for b, e in zip(params["blocks"], want))


@pytest.mark.parametrize("case", ["dense", "int8", "mixed", "unequal_groups"])
def test_blocks_of_other_formats_stay_separate(case):
    """Only siblings that are all int4 with one group count fuse; the
    forward of a partly fused dict equals the separate one's."""
    dense = tlm.init_params(GQA_DIMS, torch.Generator().manual_seed(0), torch.bfloat16)
    if case == "dense":
        params = dense
    elif case == "int8":
        params = tq.quantize_tree(dense, bits=8)
    else:
        params = tq.quantize_tree(dense, bits=4)
        block = params["blocks"][0]
        if case == "mixed":           # q int8 beside int4 k and v
            block["q"] = tq.quantize_int8(dense["blocks"][0]["q"]["w"])
        else:                          # gate in groups of 128, up in groups of 64
            block["up"] = tq.quantize_int4(dense["blocks"][0]["up"]["w"], group=64)
    ref = prefill_and_step(params, torch.bfloat16, 1)
    tlm.fuse_siblings(params)
    first, second = params["blocks"]
    if case in ("dense", "int8"):
        assert not any(n in b for b in params["blocks"] for n in tlm.SIBLINGS)
    elif case == "mixed":
        assert {"q", "k", "v", "gate_up"} <= set(first) and "qkv" not in first
        assert {"qkv", "gate_up"} <= set(second)
    else:
        assert {"qkv", "gate", "up"} <= set(first) and "gate_up" not in first
        assert {"qkv", "gate_up"} <= set(second)
    got = prefill_and_step(params, torch.bfloat16, 1)
    assert all(torch.equal(a, b) for a, b in zip(got[:2], ref[:2]))


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("head", ["int8", "int4"])
def test_decode_forward_calls_int4_matmul_s8_four_times_a_layer_fused(fused, head,
                                                                      monkeypatch):
    """A decode forward (m = 1) calls the W4A8 kernel's wrapper once for
    q|k|v, out, gate|up and down: 4 a layer fused, 7 separate, and one
    more for an int4 head. The count is taken where matmul_any looks the
    wrapper up, on the quant module."""
    params = gqa_int4_params()
    if head == "int4":
        params["lm_head"] = tq.quantize_int4(
            tlm.init_params(GQA_DIMS, torch.Generator().manual_seed(0))["lm_head"]["w"])
    if fused:
        tlm.fuse_siblings(params)
    cache = tlm.init_kv_cache(GQA_DIMS, 1, 16, dtype=torch.bfloat16)
    tlm.forward(params, GQA_DIMS, torch.tensor([[3, 4, 5]]), cache, pos=0)
    calls = []
    kernel = tq.int4_matmul_s8
    monkeypatch.setattr(tq, "int4_matmul_s8", lambda *a: calls.append(a[2].shape) or kernel(*a))
    tlm.forward(params, GQA_DIMS, torch.tensor([[6]]), cache, pos=3)
    per_layer = 4 if fused else 7
    assert len(calls) == per_layer * GQA_DIMS.n_layer + (head == "int4")
    if fused:
        d, kv, f = GQA_DIMS.d_model, GQA_DIMS.n_kv_head * GQA_DIMS.head_dim, GQA_DIMS.d_ff
        assert calls[:4] == [(d // 2, d + 2 * kv), (d // 2, d), (d // 2, 2 * f), (f // 2, d)]


@pytest.mark.parametrize("batch,t", [(1, 1), (4, 1), (1, 12)])
def test_fused_outputs_reach_the_layers_kernels_dense(batch, t, monkeypatch):
    """q, k, v and gate, up reach RoPE and SwiGLU dense: at m = 1 as views
    of the one fused output, copied by nothing; at m > 1 as copies of its
    columns."""
    from turbo_whisper_workspace_tpu_torch.ops import llama_ops

    params = tlm.fuse_siblings(gqa_int4_params())
    seen = []
    rope, swiglu = llama_ops.llama_rope_cache, llama_ops.llama_swiglu_quant

    def rope_spy(q, k, v, *args):
        seen.append((q, k, v))
        return rope(q, k, v, *args)

    def swiglu_spy(gate, up, *args):
        seen.append((gate, up))
        return swiglu(gate, up, *args)

    monkeypatch.setattr(llama_ops, "llama_rope_cache", rope_spy)
    monkeypatch.setattr(llama_ops, "llama_swiglu_quant", swiglu_spy)
    cache = tlm.init_kv_cache(GQA_DIMS, batch, 16, dtype=torch.bfloat16)
    tlm.forward(params, GQA_DIMS, torch.full((batch, t), 5), cache, pos=0)
    assert len(seen) == 2 * GQA_DIMS.n_layer
    for parts in seen:
        assert all(p.is_contiguous() for p in parts)
        storages = {p.untyped_storage().data_ptr() for p in parts}
        assert len(storages) == (1 if batch * t == 1 else len(parts))
