"""The Llama layer's kernels (turbo_whisper_workspace_tpu_torch/ops/
llama_ops.py) against the JAX package.

The JAX package has no such module: XLA fuses this work inside its
Llama forward (turbo_whisper_workspace_tpu/models/llama.py:139-175). Each
plain version is held here against the JAX code it replaces, at test-tiny
width (4 query heads over 2 kv heads of 16 dims, 2 layers where a model
runs), on the same numpy inputs from a seed, in f32 and in bf16:

* the residual add, `rms_norm` and `quant_act_grouped` (ops/quant.py:222);
* `_rope` and the cache's `dynamic_update_slice`;
* the attention einsums (models/llama.py:156-168, jitted with `pos`
  traced) at t = 1 and t = 7;
* `silu(gate) · up` and the quantizer;
* `matmul_any` with a shared (xq, xs), equal to the call that quantizes.

Tolerances, relative L2: f32 1e-6 (the two frameworks' sums and
rsqrt part in the last bits); bf16 1e-2 (a last-bit difference of an f32
intermediate flips the odd bf16 rounding). The quantizer's int8 payload
is bit-equal given the same input; from each framework's own norm, an
element may move by 1 where the bf16 values part (at most 2% of the
elements after the norm; 5% after SiLU · up, whose bf16 rounding points
the port keeps from models/llama.py and XLA does not). The decode regime's split softmax (csrc/
llama_attention.cu) is mirrored in torch and held to the plain version.
`cuda`-marked cases, skipped here, hold each kernel to its plain version
on the card.
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turbo_whisper_workspace_tpu.models import llama as jlm
from turbo_whisper_workspace_tpu.ops import quant as jq
from turbo_whisper_workspace_tpu_torch.models import llama as tlm
from turbo_whisper_workspace_tpu_torch.ops import build
from turbo_whisper_workspace_tpu_torch.ops import llama_ops as lo
from turbo_whisper_workspace_tpu_torch.ops import quant as tq

from test_torch_quant import rel_l2

B, H, KVH, DH, S = 2, 4, 2, 16, 12
D = H * DH
TOL = {"float32": 1e-6, "bfloat16": 1e-2}
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _pair(a: np.ndarray, dtype: str):
    """One numpy array as (torch, jax) tensors of the dtype, the same values."""
    tdt, jdt = DTYPES[dtype]
    t = torch.from_numpy(a).to(tdt)
    return t, jnp.asarray(t.float().numpy().copy()).astype(jdt)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_quant_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x, jx = _pair(rng.standard_normal((B, 3, D)).astype(np.float32), dtype)
    delta, jdelta = _pair(rng.standard_normal((B, 3, D)).astype(np.float32), dtype)
    scale, jscale = _pair((1 + 0.1 * rng.standard_normal(D)).astype(np.float32), dtype)
    n_groups = 2
    xn, h, (xq, xs) = lo.llama_norm_quant(x, scale, 1e-5, delta, n_groups)
    jxn = jx + jdelta
    jh = jlm.rms_norm(jxn, {"scale": jscale}, 1e-5)
    jxq, jxs = jq.quant_act_grouped(jh.reshape(-1, D), n_groups)
    assert xn.dtype == h.dtype == x.dtype and xq.dtype == torch.int8
    assert rel_l2(_np(xn), _np(jxn)) <= TOL[dtype]
    assert rel_l2(_np(h), _np(jh)) <= TOL[dtype]
    assert rel_l2(xs.numpy(), np.asarray(jxs)) <= TOL[dtype]
    moved = np.abs(xq.numpy().astype(int) - np.asarray(jxq).astype(int))
    assert moved.max() <= 1 and moved.mean() <= 0.02
    # given the JAX norm, the quantizer is bit-equal
    fq, fs = tq.quant_act_grouped(torch.tensor(_np(jh)).to(h.dtype).reshape(-1, D),
                                  n_groups)
    np.testing.assert_array_equal(fq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(fs.numpy(), np.asarray(jxs))
    # without the norm (the attention output), and without the quantizer
    _, same, (aq, _) = lo.llama_norm_quant(x, None, 1e-5, n_groups=n_groups, norm=False)
    assert same is x
    np.testing.assert_array_equal(aq.numpy(), np.asarray(
        jq.quant_act_grouped(jx.reshape(-1, D), n_groups)[0]))
    assert lo.llama_norm_quant(x, scale, 1e-5)[2] is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,pos", [(1, 9), (7, 3)])
def test_rope_cache_matches_jax(dtype, t, pos):
    rng = np.random.default_rng(1)
    q, jqx = _pair(rng.standard_normal((B, t, H, DH)).astype(np.float32), dtype)
    k, jk = _pair(rng.standard_normal((B, t, KVH, DH)).astype(np.float32), dtype)
    v, jv = _pair(rng.standard_normal((B, t, KVH, DH)).astype(np.float32), dtype)
    cache, jcache = _pair(rng.standard_normal((2, B, S, KVH * DH)).astype(np.float32), dtype)
    ck, cv = cache.clone(), cache.clone()             # two layers; layer 0 written
    dims = tlm.LLAMA_CONFIGS["test-tiny"]
    cos, sin = tlm.rope_table(dims.head_dim // 2, dims.rope_theta, dims.max_ctx, "cpu")
    got = lo.llama_rope_cache(q, k, v, ck[0], cv[0], cos, sin, torch.tensor(pos))

    @jax.jit
    def ref(q, k, v, c, pos):
        positions = pos + jnp.arange(t)
        q = jlm._rope(q, positions, 500000.0)
        k = jlm._rope(k, positions, 500000.0)
        ck = jax.lax.dynamic_update_slice(c, k.reshape(B, t, -1), (0, pos, 0))
        cv = jax.lax.dynamic_update_slice(c, v.reshape(B, t, -1), (0, pos, 0))
        return q, ck, cv

    jqr, jck, jcv = ref(jqx, jk, jv, jcache[0], pos)
    assert got.dtype == q.dtype
    assert rel_l2(_np(got), _np(jqr)) <= TOL[dtype]
    assert rel_l2(_np(ck[0]), _np(jck)) <= TOL[dtype]
    np.testing.assert_array_equal(_np(cv[0]), _np(jcv))
    # the layer's cache alone was written, at the positions' rows
    np.testing.assert_array_equal(_np(ck[1]), _np(cache[1]))


def jax_attention(q, kk, vv, pos):
    """models/llama.py:156-168's attention, on one layer's cache: the
    position mask from a traced pos, the two einsums, the f32 softmax."""
    b, t, h, dh = q.shape
    kvh = kk.shape[-1] // dh
    s_len = kk.shape[1]
    positions = pos + jnp.arange(t)
    attn_mask = jnp.arange(s_len)[None, :] <= positions[:, None]
    kk = kk.reshape(b, s_len, kvh, dh)
    vv = vv.reshape(b, s_len, kvh, dh)
    q5 = q.reshape(b, t, kvh, h // kvh, dh)
    logits = jnp.einsum("btkgd,bskd->bkgts", q5, kk,
                        preferred_element_type=jnp.float32) * (dh ** -0.5)
    logits = jnp.where(attn_mask[None, None, None], logits, -1e30)
    w = jax.nn.softmax(logits, axis=-1).astype(q.dtype)
    return jnp.einsum("bkgts,bskd->btkgd", w, vv).reshape(b, t, h * dh)


def _attention_inputs(dtype, t, seed=2):
    rng = np.random.default_rng(seed)
    q = _pair(rng.standard_normal((B, t, H, DH)).astype(np.float32), dtype)
    ck = _pair(rng.standard_normal((B, S, KVH * DH)).astype(np.float32), dtype)
    cv = _pair(rng.standard_normal((B, S, KVH * DH)).astype(np.float32), dtype)
    return q, ck, cv


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,pos", [(1, 0), (1, 11), (7, 2), (7, 5)])
def test_attention_matches_jax(dtype, t, pos):
    """Rows past pos + t hold random values: the mask keeps them out."""
    (q, jqx), (ck, jck), (cv, jcv) = _attention_inputs(dtype, t)
    got = lo.llama_attention(q, ck, cv, torch.tensor(pos))
    ref = jax.jit(jax_attention)(jqx, jck, jcv, pos)
    assert got.shape == (B, t, H * DH) and got.dtype == q.dtype
    assert rel_l2(_np(got), _np(ref)) <= TOL[dtype]
    assert torch.equal(got, lo.llama_attention(q, ck, cv, pos))      # host or device pos


def decode_mirror(q, ck, cv, pos: int, ranks: int) -> torch.Tensor:
    """csrc/llama_attention.cu's decode regime in torch: each rank's
    slice of the pos + t keys, its rows' (max, Σ exp), the global (M, L)
    in rank order, the weights bf16(exp(s − M) / L) in q's dtype, each
    rank's f32 P·V partial, summed in rank order."""
    b, t, h, dh = q.shape
    kvh = ck.shape[-1] // dh
    group = h // kvh
    kk = ck.reshape(b, -1, kvh, dh).float()
    vv = cv.reshape(b, -1, kvh, dh).float()
    q5 = q.reshape(b, t, kvh, group, dh).float()
    positions = pos + torch.arange(t)
    scores, stats = [], []
    for sl in lo.decode_slices(pos, t, ranks):
        keys = torch.arange(sl.start, sl.stop)
        s = torch.einsum("btkgd,bskd->bkgts", q5, kk[:, keys]) * np.float32(dh ** -0.5)
        s = s.masked_fill(~(keys[None, :] <= positions[:, None]), -torch.inf)
        m = s.amax(-1, keepdim=True) if len(keys) else torch.full(s.shape[:-1] + (1,), -torch.inf)
        l_ = torch.where(m > -torch.inf, torch.exp(s - m), 0).sum(-1, keepdim=True)
        scores.append((keys, s))
        stats.append((m, l_))
    m_all = torch.stack([m for m, _ in stats]).amax(0)
    l_all = torch.zeros_like(m_all)
    for m, l_ in stats:
        l_all += torch.where(l_ > 0, l_ * torch.exp(m - m_all), 0)
    out = torch.zeros(b, kvh, group, t, dh)
    for keys, s in scores:
        w = (torch.exp(s - m_all) / l_all).to(q.dtype).float()
        out += torch.einsum("bkgts,bskd->bkgtd", w, vv[:, keys])
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, h * dh).to(q.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,pos,ranks", [(1, 11, 4), (2, 0, 3), (7, 5, 8), (8, 4, 1)])
def test_decode_split_matches_plain_version(dtype, t, pos, ranks):
    (q, _), (ck, _), (cv, _) = _attention_inputs(dtype, t, seed=3)
    ref = lo.llama_attention_reference(q, ck, cv, pos)
    got = decode_mirror(q, ck, cv, pos, ranks)
    assert rel_l2(_np(got), _np(ref)) <= {"float32": 1e-6, "bfloat16": 5e-3}[dtype]


@pytest.mark.parametrize("t,group,s_len,plan", [
    (1, 4, 2004, ("decode", 4, 8, 251)), (1, 4, 520, ("decode", 4, 8, 65)),
    (1, 2, 12, ("decode", 4, 1, 12)), (2, 4, 2004, ("decode", 8, 8, 251)),
    (8, 4, 2004, ("decode", 32, 8, 251)),
    (9, 2, 24, ("prefill", 1)), (1748, 4, 1748, ("prefill", 28)), (5, 8, 64, ("prefill", 1))])
def test_attention_plan(t, group, s_len, plan):
    """At the 8B LLM's 8 (b, kv head) pairs, which never cap the ranks."""
    assert lo.attention_plan(t, group, s_len, 8) == plan
    if plan[0] == "decode":
        for pos in (0, 3, s_len - t):
            slices = lo.decode_slices(pos, t, plan[2])
            assert [k for sl in slices for k in sl] == list(range(pos + t))
            assert max(len(sl) for sl in slices) <= plan[3]


@pytest.mark.parametrize("t,group,s_len,pairs,plan", [
    (1, 4, 2004, 8, ("decode", 4, 8, 251)), (1, 4, 2004, 64, ("decode", 4, 4, 501)),
    (1, 1, 227, 160, ("decode", 4, 1, 227)), (1, 1, 227, 800, ("decode", 4, 1, 227)),
    (3, 1, 227, 8 * 20, ("decode", 4, 1, 227)), (1, 1, 448, 40, ("decode", 4, 6, 75))])
def test_attention_plan_caps_the_ranks_by_pairs(t, group, s_len, pairs, plan):
    """Where the (b, kv head) pairs fill the card alone (the Whisper
    decoder's 20 heads at B = 8 or 40), the decode regime takes fewer
    ranks; the 8B LLM's 8 pairs keep theirs."""
    assert lo.attention_plan(t, group, s_len, pairs) == plan
    for pos in (0, s_len - t):
        slices = lo.decode_slices(pos, t, plan[2])
        assert [k for sl in slices for k in sl] == list(range(pos + t))
        assert max(len(sl) for sl in slices) <= plan[3]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu_quant_matches_jax(dtype):
    rng = np.random.default_rng(4)
    gate, jgate = _pair(rng.standard_normal((B, 1, 256)).astype(np.float32), dtype)
    up, jup = _pair(rng.standard_normal((B, 1, 256)).astype(np.float32), dtype)
    p, (xq, xs) = lo.llama_swiglu_quant(gate, up, 4)
    jp = jax.nn.silu(jgate) * jup
    jxq, jxs = jq.quant_act_grouped(jp.reshape(-1, 256), 4)
    assert p.dtype == gate.dtype and xq.shape == (B, 256) and xs.shape == (B, 4)
    assert rel_l2(_np(p), _np(jp)) <= TOL[dtype]
    # bf16: the port rounds g · sigmoid(g) to bf16 before the product with
    # up, as models/llama.py did; XLA's fusion keeps it in f32 (measured:
    # 2.3% of the payload moved by 1)
    moved = np.abs(xq.numpy().astype(int) - np.asarray(jxq).astype(int))
    assert moved.max() <= 1 and moved.mean() <= 0.05
    fq, _ = tq.quant_act_grouped(torch.tensor(_np(jp)).to(p.dtype).reshape(-1, 256), 4)
    np.testing.assert_array_equal(fq.numpy(), np.asarray(jxq))
    assert lo.llama_swiglu_quant(gate, up)[1] is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_any_takes_a_shared_quantized_input(dtype):
    """int4 at m ≤ 8: the shared (xq, xs) gives today's call's result bit
    for bit, and the same as the JAX TPU route (Pallas in interpret
    mode); it is refused where the route would not quantize."""
    from test_torch_quant import tpu_route

    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((1, 2, 128)).astype(np.float32)).to(
        DTYPES[dtype][0])
    w = (rng.standard_normal((128, 96)) * 0.1).astype(np.float32)
    wp = {k: torch.tensor(np.array(v)) for k, v in jq.quantize_int4(w, group=32).items()}
    act = tq.quant_act_grouped(x.reshape(-1, 128), 4)
    got = tq.matmul_any(x, wp, act=act)
    assert torch.equal(got, tq.matmul_any(x, wp))
    ref = tpu_route(jnp.asarray(x.float().numpy()), jq.quantize_int4(w, group=32))
    assert rel_l2(_np(got), np.asarray(ref)) <= TOL[dtype]
    with pytest.raises(ValueError):
        tq.matmul_any(x, {"w_q": torch.zeros(128, 96, dtype=torch.int8),
                          "scale": torch.ones(96)}, act=act)
    with pytest.raises(ValueError):
        tq.matmul_any(torch.zeros(9, 128), wp, act=tq.quant_act_grouped(torch.zeros(9, 128), 4))


@pytest.mark.parametrize("m", [tq.W4A8_MAX_M, tq.W4A8_MAX_M + 1])
def test_the_group_count_and_matmul_any_agree_on_the_w4a8_limit(m, monkeypatch):
    """Up to W4A8_MAX_M rows `w4a8_groups` gives the weight's groups, and
    matmul_any runs int4_matmul_s8 on a shared (xq, xs) in them, equal to
    its own quantization; a row more, it gives 0, matmul_any runs
    int4_matmul and refuses a quantized input."""
    routes = []
    for name in ("int4_matmul", "int4_matmul_s8"):
        monkeypatch.setattr(tq, name, lambda *a, _f=getattr(tq, name), _n=name:
                            routes.append(_n) or _f(*a))
    x = torch.randn(m, 128, generator=torch.Generator().manual_seed(6))
    wp = tq.quantize_int4(torch.randn(128, 96, generator=torch.Generator().manual_seed(7)),
                          group=32)
    groups = tq.w4a8_groups({"p": wp}, ("p",), m)
    act = tq.quant_act_grouped(x, 4)
    if m <= tq.W4A8_MAX_M:
        assert groups == 4
        assert torch.equal(tq.matmul_any(x, wp, act=act), tq.matmul_any(x, wp))
        assert routes == ["int4_matmul_s8"] * 2
    else:
        assert groups == 0
        tq.matmul_any(x, wp)
        assert routes == ["int4_matmul"]
        with pytest.raises(ValueError):
            tq.matmul_any(x, wp, act=act)


def test_wrappers_run_plain_versions_on_cpu_and_name_their_launches():
    """CPU tensors never launch; each wrapper passes as many arguments as
    its C signature declares."""
    lo.reset_launch_counts()
    (q, _), (ck, _), (cv, _) = _attention_inputs("bfloat16", 1)
    assert torch.equal(lo.llama_attention(q, ck, cv, 3),
                       lo.llama_attention_reference(q, ck, cv, 3))
    assert lo.launch_counts == dict.fromkeys(lo.launch_counts, 0)
    tree = ast.parse(pathlib.Path(lo.__file__).read_text())
    calls = {c.args[0].value: len(c.args) - 1 for c in ast.walk(tree)
             if isinstance(c, ast.Call) and getattr(c.func, "attr", "") == "launch"}
    assert calls == {n: len(build.SIGNATURES[n]) for n in lo.launch_counts}


@pytest.mark.parametrize("kind", ["dense", "int4"])
def test_forward_counts_one_launch_of_each_kernel_a_layer_step(kind, monkeypatch):
    """The layer calls each wrapper: a step at m ≤ 8 with int4 weights
    quantizes three inputs a layer (q/k/v, out, gate/up) in the norm
    kernel, the fourth (down) in the SwiGLU kernel; q, k and v share one
    (xq, xs)."""
    dims = tlm.LLAMA_CONFIGS["test-tiny"]
    params = tlm.init_params(dims, torch.Generator().manual_seed(0))
    if kind == "int4":
        params = tq.quantize_tree(params, bits=4)
    calls, shared = [], []
    for name in lo.launch_counts:
        fn = getattr(lo, name)

        def counted(*a, _f=fn, _n=name, **k):
            out = _f(*a, **k)
            calls.append((_n, isinstance(out, tuple) and out[-1] is not None))
            return out

        monkeypatch.setattr(lo, name, counted)
    matmul_any = tq.matmul_any
    monkeypatch.setattr(tq, "matmul_any", lambda x, wp, act=None:
                        shared.append(act) or matmul_any(x, wp, act=act))
    cache = tlm.init_kv_cache(dims, 1, 8, dtype=torch.float32)
    tlm.forward(params, dims, torch.tensor([[5, 6, 7]]), cache, pos=0)
    names = [n for n, _ in calls]
    assert names.count("llama_attention") == names.count("llama_rope_cache") == dims.n_layer
    assert names.count("llama_swiglu_quant") == dims.n_layer
    quantized = [n for n, q in calls if q]
    if kind == "dense":
        assert not quantized and all(a is None for a in shared)
        assert names.count("llama_norm_quant") == 2 * dims.n_layer + 1
    else:
        assert names.count("llama_norm_quant") == 3 * dims.n_layer + 1
        assert len(quantized) == 4 * dims.n_layer
        qkv, out, gate, up, down = shared[2], shared[3], shared[4], shared[5], shared[6]
        assert shared[0] is shared[1] is qkv and gate is up
        assert len({id(a) for a in (qkv, out, gate, down)}) == 4 and None not in shared[:7]
        assert shared[-1] is None           # the int8 head quantizes nothing


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs these checks on the card")
    return torch.device("cuda")


def _close(got, ref, tol=5e-3):
    assert torch.isfinite(got.float()).all()
    assert rel_l2(_np(got.cpu()), _np(ref.cpu())) <= tol


def test_every_whisper_head_dim_is_a_kernel_head_dim():
    """The Whisper decoder's self-attention over the bf16 cache and a
    2048-wide 32-head Llama (head dim 64) take llama_attention."""
    from turbo_whisper_workspace_tpu_torch.models import whisper as twm

    assert {d.n_text_state // d.n_text_head for d in twm.WHISPER_CONFIGS.values()} <= set(
        lo.HEAD_DIMS)
    assert 2048 // 32 in lo.HEAD_DIMS


@pytest.mark.cuda
def test_cuda_attention_plan_is_the_kernels(cuda_device):
    """attention_plan mirrors csrc/llama_attention.cu:make_plan: the
    built library's plan (tww_llama_attention_plan) at the LLM's and the
    Whisper decoder's shapes and around each regime's edges."""
    cases = [(t, group, s_len, pairs) for t in (1, 2, 3, 8, 9, 40, 1748)
             for group in (1, 2, 4, 8, 32) for s_len in (12, 227, 448, 520, 2004)
             for pairs in (1, 8, 32, 40, 64, 160, 800) if t <= s_len]
    assert all(lo.attention_plan(*c) == lo.kernel_plan(*c) for c in cases)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
@pytest.mark.parametrize("t,pos", [(1, 0), (1, 300), (2, 50), (4, 200), (9, 0), (70, 100),
                                   (300, 0)])
def test_cuda_attention_matches_plain_version(cuda_device, dh, t, pos):
    gen = torch.Generator(cuda_device).manual_seed(0)
    s_len = 512
    q = torch.randn(2, t, 8, dh, generator=gen, device=cuda_device).to(torch.bfloat16)
    ck, cv = (torch.randn(2, s_len, 2 * dh, generator=gen, device=cuda_device)
              .to(torch.bfloat16) for _ in range(2))
    ref = lo.llama_attention_reference(q, ck, cv, pos)
    _close(lo.llama_attention(q, ck, cv, torch.tensor(pos, device=cuda_device)), ref)
    _close(lo.llama_attention(q, ck, cv, pos), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("m,d,n_groups", [(1, 4096, 32), (5, 256, 8), (3, 4096, 0)])
def test_cuda_norm_quant_and_swiglu_match_plain_versions(cuda_device, m, d, n_groups):
    gen = torch.Generator(cuda_device).manual_seed(1)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=cuda_device).to(torch.bfloat16)

    x, delta, scale = randn(m, d), randn(m, d), randn(d)
    for kw in ({"delta": delta}, {}, {"norm": False}):
        if not n_groups and not kw.get("norm", True):
            continue
        args = (x, None if kw.get("norm") is False else scale, 1e-5)
        got = lo.llama_norm_quant(*args, kw.get("delta"), n_groups, kw.get("norm", True))
        ref = lo.llama_norm_quant_reference(*args, kw.get("delta"), n_groups,
                                            kw.get("norm", True))
        _close(got[1], ref[1], 1e-2)
        if n_groups:
            assert (got[2][0].int() - ref[2][0].int()).abs().max() <= 1
    p, act = lo.llama_swiglu_quant(randn(m, 2 * d), randn(m, 2 * d), n_groups)
    gate, up = randn(m, 2 * d), randn(m, 2 * d)
    p, act = lo.llama_swiglu_quant(gate, up, n_groups)
    rp, ract = lo.llama_swiglu_quant_reference(gate, up, n_groups)
    _close(p, rp, 1e-2)
    if n_groups:
        assert (act[0].int() - ract[0].int()).abs().max() <= 1


@pytest.mark.cuda
def test_cuda_rope_cache_matches_plain_version(cuda_device):
    gen = torch.Generator(cuda_device).manual_seed(2)
    dims = tlm.LLAMA_CONFIGS["llama-3.1-8b"]
    cos, sin = tlm.rope_table(dims.head_dim // 2, dims.rope_theta, dims.max_ctx, cuda_device)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=cuda_device).to(torch.bfloat16)

    for t, pos in ((1, 1500), (33, 7)):
        q, k, v = randn(1, t, 32, 128), randn(1, t, 8, 128), randn(1, t, 8, 128)
        ck, cv = randn(1, 2048, 1024), randn(1, 2048, 1024)
        rck, rcv = ck.clone(), cv.clone()
        got = lo.llama_rope_cache(q, k, v, ck, cv, cos, sin,
                                  torch.tensor(pos, device=cuda_device))
        ref = lo.llama_rope_cache_reference(q, k, v, rck, rcv, cos, sin, pos)
        _close(got, ref, 1e-2)
        _close(ck, rck, 1e-2)
        assert torch.equal(cv, rcv)


@pytest.mark.cuda
def test_cuda_graphed_8b_decode_step_fused_equals_separate(cuda_device):
    """The graphed m = 1 step at the 8B widths (two layers) from one
    prefilled cache: fused siblings give the same logits, tokens and
    cache, bit for bit, in 4 int4_matmul_s8 launches a layer in place of
    7. The prefill runs with the separate weights on both sides: at m > 8
    int4_matmul plans k and v apart from q|k|v, so their sums may round
    otherwise there."""
    import dataclasses

    from turbo_whisper_workspace_tpu_torch.llm import llm_helper
    from turbo_whisper_workspace_tpu_torch.utils.step_loop import StepGraph

    dims = dataclasses.replace(tlm.LLAMA_CONFIGS["llama-3.1-8b"], n_layer=2, max_ctx=512)
    gen = torch.Generator(cuda_device).manual_seed(0)
    params = tq.quantize_tree(tlm.init_params(dims, gen, torch.bfloat16, cuda_device), bits=4)
    fused = tlm.fuse_siblings({**params, "blocks": [dict(b) for b in params["blocks"]]})
    assert all("q" in b and "qkv" in f for b, f in zip(params["blocks"], fused["blocks"]))
    prompt = torch.randint(0, dims.n_vocab, (1, 300), generator=gen, device=cuda_device)
    cache = tlm.init_kv_cache(dims, 1, 320, device=cuda_device)
    with torch.no_grad():
        tlm.forward(params, dims, prompt, cache, pos=0)
    prefilled = {n: x.clone() for n, x in cache.items()}

    def steps(p, n=6):
        for name, x in cache.items():
            x.copy_(prefilled[name])
        state = {"tok": torch.zeros((1, 1), dtype=torch.long, device=cuda_device),
                 "pos": torch.tensor(300, device=cuda_device),
                 "logits": torch.zeros(1, dims.n_vocab, device=cuda_device)}

        def step():
            logits, _ = tlm.forward(p, dims, state["tok"], cache, pos=state["pos"])
            state["logits"].copy_(logits[:, 0])
            state["tok"].copy_(logits[:, 0].argmax(-1, keepdim=True))
            state["pos"].add_(1)

        with torch.no_grad():
            graph = StepGraph(step, state)
            before = tq.launch_counts["int4_matmul_s8"]
            out = []
            for _ in range(n):
                graph.replay()
                out.append(state["logits"].clone())
        torch.cuda.synchronize()
        return (torch.stack(out), {k: x.clone() for k, x in cache.items()},
                (tq.launch_counts["int4_matmul_s8"] - before) // n)

    ref, got = steps(params), steps(fused)
    assert torch.equal(got[0], ref[0])
    assert all(torch.equal(got[1][n], ref[1][n]) for n in ("k", "v"))
    assert (ref[2], got[2]) == (7 * dims.n_layer, 4 * dims.n_layer)
    llm = llm_helper.TorchLlama(params, dims, device=cuda_device)    # fuses in place
    assert all(set(b) >= {"qkv", "gate_up"} and "q" not in b for b in llm.params["blocks"])
