"""The port's s8×s8 kernels against the JAX package, on the CPU.

* `cross_attention_s8`'s plain version against the JAX Pallas kernel in
  interpret mode, and the s8 route of Whisper decoding
  (`TranscriptionConfig.cross_attention_s8`) against the JAX package run
  with TWW_PALLAS=interpret and TWW_CROSS_S8=1 on the same weights: one
  decoder step's logits, greedy and beam-3 tokens through the
  transcriber, and the pipeline entry point;
* the LLM-ops profiler's `s8_matmul` and `s8g4_matmul` plain versions
  against the JAX script's Pallas kernels in interpret mode, and the
  profiler's `main` at a small model.

The CUDA kernels themselves need a card: the `cuda`-marked test holds
them to the plain versions there (chip_smoke.py does it at full width).
"""

import functools
import importlib.util
import json
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from turbo_whisper_workspace_tpu.config import TranscriptionConfig as JConfig
from turbo_whisper_workspace_tpu.models import whisper as jwm
from turbo_whisper_workspace_tpu.ops import attention as jatt
from turbo_whisper_workspace_tpu.pipeline import transcriber as jtr
from turbo_whisper_workspace_tpu_torch.config import PipelineConfig
from turbo_whisper_workspace_tpu_torch.config import TranscriptionConfig as TConfig
from turbo_whisper_workspace_tpu_torch.models import convert
from turbo_whisper_workspace_tpu_torch.models import llama as tlm
from turbo_whisper_workspace_tpu_torch.models import whisper as twm
from turbo_whisper_workspace_tpu_torch.ops import attention as tatt
from turbo_whisper_workspace_tpu_torch.ops import quant as tq
from turbo_whisper_workspace_tpu_torch.pipeline import audio_pipeline as tpipe
from turbo_whisper_workspace_tpu_torch.pipeline import transcriber as ttr
from turbo_whisper_workspace_tpu_torch.scripts import profile_llm_ops as tprof

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = REPO / "examples" / "golden" / "conversation.wav"
# tests/test_pallas_model_path.py's tiny Whisper, with the multilingual
# vocabulary the transcriber's tokenizer needs
DIMS = jwm.WhisperDims(80, 1500, 64, 2, 2, 51865, 448, 64, 2, 2)


def rel_l2(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


# ---------------------------------------------------------------------------
# cross_attention_s8


def _cross_inputs(tq_, t=256, seed=0):
    """tests/test_attention_kernel.py's s8 inputs: (b, h, dh) = (2, 4, 64)."""
    rng = np.random.default_rng(seed)
    b, h, dh = 2, 4, 64
    q = rng.standard_normal((b, h, tq_, dh)).astype(np.float32)
    kq = rng.integers(-127, 128, (b, h, dh, t)).astype(np.int8)
    vq = rng.integers(-127, 128, (b, t, h * dh)).astype(np.int8)
    ks = rng.uniform(0.005, 0.02, (b, h)).astype(np.float32)
    vs = rng.uniform(0.005, 0.02, (b, h)).astype(np.float32)
    return q, kq, vq, ks, vs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seq_len", [256, 200])
@pytest.mark.parametrize("tq_", [1, 5])
def test_cross_s8_reference_matches_jax(tq_, seq_len, dtype):
    """Measured relative L2 against the Pallas kernel: at most 1.5e-7 in
    f32 and 0 in bf16 (limit 2e-3). The s8 output sits 1.3-2.0% mean
    relative from the int8 kernel's; without the mask it reads 0.32-0.58."""
    q, kq, vq, ks, vs = _cross_inputs(tq_)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    pallas = np.asarray(jatt.cross_attention_s8(
        jnp.asarray(q, jdt), kq, vq, ks, vs, seq_len=seq_len, interpret=True), np.float32)
    args = (torch.from_numpy(q).to(tdt), *map(torch.from_numpy, (kq, vq, ks, vs)))
    got = tatt.cross_attention_s8_reference(*args, seq_len=seq_len)
    assert got.dtype == tdt and got.shape == (2, 4, tq_, 64)
    assert rel_l2(_np(got), pallas) <= 2e-3
    # the yardstick of tests/test_attention_kernel.py:142-164: within 3%
    # mean relative of the bf16-dequant kernel's plain version
    ref = _np(tatt.cross_attention_int8_reference(*args, seq_len=seq_len))
    assert np.abs(_np(got) - ref).mean() / np.abs(ref).mean() < 0.03
    # the t ≥ seq_len mask matters
    if seq_len < 256:
        unmasked = _np(tatt.cross_attention_s8_reference(*args))
        assert rel_l2(unmasked, pallas) > 5e-3


def s8_cluster_mirror(q, kq, vq, k_scale, v_scale, seq_len, ranks):
    """cross_attention_s8's cluster arithmetic in its order, in torch:
    the query quantized per row (the same on every rank); per-slice s32
    scores of `ranks` 16-key-aligned slices; each slice's max m_r and sum
    of exp2 against it (−inf and 0 for a slice wholly past seq_len); the
    global M and Σ = Σ_r sum_r · exp2(m_r − M) in rank order; each slice's
    weights w8 = rint(exp2(s − M) · (1/Σ) / ws) at ws = (1/Σ)/127 against
    the global M; exact s32 partials of w8 · V summed over the ranks."""
    b, h, tq, dh = q.shape
    tpad = kq.shape[-1]
    width = -(-(-(-tpad // ranks)) // 16) * 16
    qf = (q.float() * (k_scale[:, :, None, None] * dh ** -0.5 * tatt.LOG2E)).to(
        torch.bfloat16).float()
    qs = tatt._div(qf.abs().amax(-1, keepdim=True).clamp_min(1e-30), 127.0)
    q8 = torch.clamp(torch.round(qf / qs), -127, 127).double()
    vh = vq.reshape(b, tpad, h, dh).double()
    slices = [(r * width, min((r + 1) * width, seq_len)) for r in range(-(-tpad // width))]
    scores, maxes, sums = [], [], []
    for lo, hi in slices:
        if hi <= lo:                          # a rank wholly past seq_len
            scores.append(None)
            maxes.append(torch.full((b, h, tq, 1), -torch.inf))
            sums.append(torch.zeros((b, h, tq, 1)))
            continue
        s = torch.einsum("bhqd,bhdt->bhqt", q8, kq[..., lo:hi].double()).float() * qs
        scores.append(s)
        maxes.append(s.amax(-1, keepdim=True))
        sums.append(torch.exp2(s - maxes[-1]).sum(-1, keepdim=True))
    m = maxes[0]
    for mr in maxes[1:]:
        m = torch.maximum(m, mr)
    total = sums[0] * torch.exp2(maxes[0] - m)
    for sr, mr in zip(sums[1:], maxes[1:]):
        total = total + sr * torch.exp2(mr - m)
    inv = torch.reciprocal(total)
    ws = tatt._div(inv.clamp_min(1e-30), 127.0)
    acc = torch.zeros((b, h, tq, dh), dtype=torch.float64)
    for (lo, hi), s in zip(slices, scores):
        if s is not None:
            w8 = torch.round(torch.exp2(s - m) * inv / ws)
            acc = acc + torch.einsum("bhqt,bthd->bhqd", w8.double(), vh[:, lo:hi])
    return (acc.float() * ws * v_scale[:, :, None, None]).to(q.dtype)


_S8_JAX = {}


@pytest.mark.parametrize("seq_len", [256, 100])
@pytest.mark.parametrize("ranks", [1, 2, 3, 8])
@pytest.mark.parametrize("tq_", [1, 5, 35])
def test_cross_s8_cluster_order_matches_jax(tq_, ranks, seq_len):
    """The s8 cluster's order of operations at Tpad 256 (at seq_len 100
    every split has a rank wholly past the keys: from key 128, 192 and
    128 on) against the JAX Pallas kernel in interpret mode with
    test_cross_s8_reference_matches_jax's limit, against the plain
    version, and within 3% mean relative of cross_attention_int8's."""
    q, kq, vq, ks, vs = _cross_inputs(tq_)
    if (tq_, seq_len) not in _S8_JAX:
        _S8_JAX[(tq_, seq_len)] = np.asarray(jatt.cross_attention_s8(
            jnp.asarray(q), kq, vq, ks, vs, seq_len=seq_len, interpret=True), np.float32)
    args = (torch.from_numpy(q), *map(torch.from_numpy, (kq, vq, ks, vs)))
    got = s8_cluster_mirror(*args, seq_len, ranks)
    assert got.shape == (2, 4, tq_, 64)
    assert rel_l2(_np(got), _S8_JAX[(tq_, seq_len)]) <= 2e-3
    assert rel_l2(_np(got), _np(tatt.cross_attention_s8_reference(*args, seq_len=seq_len))) <= 2e-3
    ref = _np(tatt.cross_attention_int8_reference(*args, seq_len=seq_len))
    assert np.abs(_np(got) - ref).mean() / np.abs(ref).mean() < 0.03


# ---------------------------------------------------------------------------
# The s8 route of Whisper decoding


@pytest.fixture(scope="module")
def pair():
    params = jwm.init_params(DIMS, jax.random.PRNGKey(0))
    model = convert.from_jax_params(jax.tree.map(np.asarray, params),
                                    twm.WhisperDims(**DIMS.__dict__))
    feats = (np.random.default_rng(1).standard_normal(
        (2, DIMS.n_audio_ctx, DIMS.n_audio_state)) * 0.3).astype(np.float32)
    ckv_j = jwm.precompute_cross_kv(params, DIMS, feats, quantize=True)
    ckv_t = model.decoder.precompute_cross_kv(torch.from_numpy(feats), quantize=True)
    return params, model, ckv_j, ckv_t


@pytest.fixture
def jax_s8(monkeypatch):
    """The JAX package on its s8 route: both switches are read at trace
    time (tests/test_pallas_model_path.py:47-54), and the route is
    ignored when the Pallas mode is "off", the CPU default."""
    monkeypatch.setenv("TWW_PALLAS", "interpret")
    monkeypatch.setenv("TWW_CROSS_S8", "1")
    jax.clear_caches()
    yield
    monkeypatch.delenv("TWW_PALLAS")
    monkeypatch.delenv("TWW_CROSS_S8")
    jax.clear_caches()


def _forbid(monkeypatch, name):
    """ops.attention.<name> raises if called; returns the calls of the
    other cross-attention kernel's plain version."""
    def refuse(*args, **kwargs):
        raise AssertionError(f"{name} was called")

    other = ("cross_attention_int8" if name == "cross_attention_s8"
             else "cross_attention_s8")
    calls = []
    fn = getattr(tatt, other)
    monkeypatch.setattr(tatt, name, refuse)
    monkeypatch.setattr(tatt, other, lambda *a, **k: calls.append(1) or fn(*a, **k))
    return calls


def test_decoder_step_s8_matches_jax(pair, jax_s8, monkeypatch):
    """Prefill then one step at pos 3 over the int8 cross-KV, f32 self
    cache. Measured relative L2: 4.6e-7 prefill, 5.2e-7 step (limit
    5e-3); the route itself moves the logits by 1.2-1.3e-4, so the port's
    int8 route must read at least ten times farther from the JAX s8 logits."""
    params, model, ckv_j, ckv_t = pair
    prefill = np.array([[11, 3, 7], [42, 9, 1]], np.int32)
    step = np.array([[500], [300]], np.int32)
    cache_j = jwm.init_kv_cache(DIMS, 2, max_len=8, dtype=jnp.float32)
    ref1, cache_j = jwm.decoder_forward(params, DIMS, prefill, ckv_j, cache_j, pos=0)
    ref2, _ = jwm.decoder_forward(params, DIMS, step, ckv_j, cache_j, pos=3)

    def run(cross_s8):
        cache_t = twm.init_kv_cache(model.dims, 2, max_len=8, dtype=torch.float32)
        got1, cache_t = model.decoder(torch.from_numpy(prefill).long(), ckv_t, cache_t,
                                      pos=0, cross_s8=cross_s8)
        got2, _ = model.decoder(torch.from_numpy(step).long(), ckv_t, cache_t, pos=3,
                                cross_s8=cross_s8)
        return got1.numpy(), got2.numpy()

    int8_route = run(False)
    calls = _forbid(monkeypatch, "cross_attention_int8")
    got1, got2 = run(True)
    assert len(calls) == 2 * DIMS.n_text_layer
    for got, ref, other in zip((got1, got2), (ref1, ref2), int8_route):
        assert rel_l2(got, ref) <= 5e-3
        assert rel_l2(got, ref) < 0.1 * rel_l2(other, ref)


def _assert_same_tokens(got, ref, p_len):
    """Equal tokens and lengths. A divergence at a near-tie of the logits
    would be allowed (tests/test_torch_llm.py:assert_same_tokens), but
    none occurs at these weights and inputs, so the check is exact."""
    got_t, ref_t = got.tokens.numpy(), np.asarray(ref.tokens)
    assert got_t.shape == ref_t.shape and got_t.shape[1] == p_len + 8
    np.testing.assert_array_equal(got_t, ref_t)
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(ref.lengths))


@pytest.mark.parametrize("beam_size", [1, 3])
def test_transcriber_s8_tokens_match_jax(pair, jax_s8, monkeypatch, beam_size):
    """Greedy and beam-3 decodes of 8 steps through the transcriber with
    cross_attention_s8=True, against the JAX transcriber on its s8 route,
    over the same int8 cross-KV; language detection first."""
    params, model, ckv_j, ckv_t = pair
    kw = dict(max_decode_len=8, beam_size=beam_size)
    jt = jtr.load_transcriber(params, DIMS, JConfig(**kw))
    tt = ttr.load_transcriber(model, TConfig(cross_attention_s8=True, **kw), device="cpu")
    calls = _forbid(monkeypatch, "cross_attention_int8")
    langs = tt._detect_language_rows(ckv_t)
    assert langs == jt._detect_language_rows(ckv_j)
    ref, p_len = jt._decode_batch(ckv_j, langs)
    got, _ = tt._decode_batch(ckv_t, langs)
    assert calls
    _assert_same_tokens(got, ref, p_len)
    np.testing.assert_allclose(got.avg_logprobs.numpy(), np.asarray(ref.avg_logprobs),
                               atol=1e-3)


@pytest.mark.parametrize("beam_size", [1, 3])
def test_default_config_never_calls_cross_attention_s8(pair, monkeypatch, beam_size):
    _, model, _, ckv_t = pair
    tt = ttr.load_transcriber(model, TConfig(max_decode_len=4, beam_size=beam_size),
                              device="cpu")
    assert not tt.config.cross_attention_s8
    calls = _forbid(monkeypatch, "cross_attention_s8")
    langs = tt._detect_language_rows(ckv_t)
    tt._decode_batch(ckv_t, langs)
    assert calls


def test_pipeline_honours_cross_attention_s8(monkeypatch, tmp_path):
    """AudioProcessingPipeline loads its transcriber with its config's
    field, and its requests then take the s8 route."""
    monkeypatch.setitem(twm.WHISPER_CONFIGS, "test-s8", twm.WhisperDims(**DIMS.__dict__))
    monkeypatch.setattr(ttr, "FALLBACK_TEMPERATURES", (0.0,))
    cfg = TConfig(model="test-s8", max_decode_len=4, cross_attention_s8=True)
    pipe = tpipe.AudioProcessingPipeline(
        PipelineConfig(transcription=cfg, models_dir=str(tmp_path)), device="cpu")
    calls = _forbid(monkeypatch, "cross_attention_int8")
    result = pipe.transcribe(str(GOLDEN))
    assert pipe.load_transcription_model().config.cross_attention_s8
    assert calls and sorted(result) == ["chunks", "duration", "language",
                                        "processing_times", "segments", "text"]


# ---------------------------------------------------------------------------
# The LLM-ops profiler's kernels


@pytest.fixture(scope="module")
def jprof(tmp_path_factory):
    """scripts/profile_llm_ops.py loaded by path, its Pallas calls in
    interpret mode. Importing it points JAX's persistent compilation cache
    at $JAX_COMPILATION_CACHE_DIR: that goes to a temporary directory, and
    the cache settings are restored afterwards."""
    names = ("jax_compilation_cache_dir", "jax_persistent_cache_min_entry_size_bytes",
             "jax_persistent_cache_min_compile_time_secs")
    saved = {name: getattr(jax.config, name) for name in names}
    mp = pytest.MonkeyPatch()
    mp.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path_factory.mktemp("jax_cache")))
    spec = importlib.util.spec_from_file_location(
        "jax_profile_llm_ops", REPO / "scripts" / "profile_llm_ops.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        mp.undo()
    mod.pl = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec, GridSpec=pl.GridSpec, CostEstimate=pl.CostEstimate)
    yield mod
    for name, value in saved.items():
        jax.config.update(name, value)
    from jax._src import compilation_cache

    compilation_cache.reset_cache()


SHAPES = [(1, 512, 256), (3, 256, 1000), (8, 512, 200)]


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_s8_matmul_reference_bit_equal_to_jax(jprof, m, k, n):
    rng = np.random.default_rng(m)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w_q = rng.integers(-127, 128, (k, n)).astype(np.int8)
    scale = rng.uniform(0.005, 0.02, n).astype(np.float32)
    xq_j, xs_j = jprof.quant_act(jnp.asarray(x))
    xq, xs = tprof.quant_act(torch.from_numpy(x))
    assert xs.shape == (m, 1)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(xq_j))
    np.testing.assert_array_equal(xs.numpy(), np.asarray(xs_j))
    ref = np.asarray(jprof.s8_matmul(xq_j, xs_j, w_q, scale), np.float32)
    got = tprof.s8_matmul_reference(xq, xs, torch.from_numpy(w_q), torch.from_numpy(scale))
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    np.testing.assert_array_equal(_np(got), ref)


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_s8g4_matmul_reference_matches_jax(jprof, m, k, n):
    """Bit-equal: at these shapes XLA does not contract the kernel's
    acc + dot·(xs·ws) into a fused multiply-add (it does now and then for
    int4_matmul_s8's kernel, tests/test_torch_quant.py)."""
    rng = np.random.default_rng(10 + m)
    n_groups = k // tprof.GROUP
    x = rng.standard_normal((m, k)).astype(np.float32)
    w_q4 = rng.integers(-128, 128, (k // 2, n)).astype(np.int8)
    scale4 = rng.uniform(0.005, 0.02, (n_groups, n)).astype(np.float32)
    xq_j, xs_j = jprof.quant_act_grouped(jnp.asarray(x), n_groups)
    xq, xs = tprof.quant_act_grouped(torch.from_numpy(x), n_groups)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(xq_j))
    np.testing.assert_array_equal(xs.numpy(), np.asarray(xs_j))
    ref = np.asarray(jprof.s8g4_matmul(xq_j, xs_j, w_q4, scale4), np.float32)
    got = _np(tprof.s8g4_matmul_reference(xq, xs, torch.from_numpy(w_q4),
                                          torch.from_numpy(scale4)))
    assert got.shape == (m, n)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("m,k,n,regime", [
    (1, 3072, 8192, "gemv"), (1, 3072, 1024, "gemv"), (1, 3072, 128256, "gemv"),
    (1, 8192, 3072, "gemv"), (8, 3072, 8192, "gemv"), (16, 3072, 8192, "gemv"),
    (17, 3072, 8192, "mma"), (32, 3072, 8192, "mma"), (3, 256, 1000, "gemv"),
    (1, 4, 4, "gemv")])
def test_s8_plan_regimes_and_splits(m, k, n, regime):
    """s8_matmul's plan: the GEMV at M ≤ 16 (the profiler's M = 1), its
    K split covering the K steps exactly once and only where the column
    tiles leave the card short of blocks; the 16-row mma tiles above."""
    got, split = tprof.s8_plan(m, k, n)
    assert got == regime
    steps = -(-k // tprof.S8_GEMV_STEP)
    if regime == "mma":
        assert split == 1
        return
    assert split == tq.gemv_split(steps, n) and split in (1, 2, 4, 8)
    ranges = tq.split_ranges(steps, split)
    assert [i for r in ranges for i in r] == list(range(steps))
    assert split == 1 or min(len(r) for r in ranges) >= tq.GEMV_WARPS
    if n == 128256:
        assert split == 1
    if (k, n) == (3072, 1024):
        assert split == 8


def s8_split_mirror(xq, xs, w_q, scale):
    """s8_matmul's GEMV sums in the kernel's order: exact s32 partials
    of each K step of 32 rows, a warp taking every 8th step of its rank's
    slice, the warps then the ranks folded in order, then × xs and × ws
    in f32 and one rounding to bf16."""
    m, k = xq.shape
    _, split = tprof.s8_plan(m, k, w_q.shape[1])
    rows = tprof.S8_GEMV_STEP
    x, w = xq.long(), w_q.long()

    def part(s):
        return x[:, s * rows:(s + 1) * rows] @ w[s * rows:(s + 1) * rows]

    total = torch.zeros(m, w.shape[1], dtype=torch.long)
    for r in tq.split_ranges(-(-k // rows), split):
        for wi in range(tq.GEMV_WARPS):
            for s in r[wi::tq.GEMV_WARPS]:
                total += part(s)
    assert total.abs().max() < 2 ** 31          # the kernel's s32 sums do not wrap
    acc = total.to(torch.int32).float()
    return (acc * xs * scale).to(torch.bfloat16), split


@pytest.mark.parametrize("m,k,n,split", [(1, 2048, 256, 8), (3, 1000, 200, 4),
                                         (16, 512, 1000, 2), (8, 512, 200, 2)])
def test_s8_split_fold_bit_equal_to_reference_and_jax(jprof, m, k, n, split):
    """The s32 fold over the plan's K slices is exact in any order: the
    mirror is bit-equal to s8_matmul_reference and to the JAX script's
    Pallas kernel in interpret mode."""
    rng = np.random.default_rng(20 + m)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w_q = rng.integers(-127, 128, (k, n)).astype(np.int8)
    scale = rng.uniform(0.005, 0.02, n).astype(np.float32)
    xq, xs = tprof.quant_act(torch.from_numpy(x))
    got, got_split = s8_split_mirror(xq, xs, torch.from_numpy(w_q), torch.from_numpy(scale))
    assert got_split == split
    ref = tprof.s8_matmul_reference(xq, xs, torch.from_numpy(w_q), torch.from_numpy(scale))
    assert torch.equal(got, ref)
    pallas = np.asarray(jprof.s8_matmul(jnp.asarray(xq.numpy()), jnp.asarray(xs.numpy()),
                                        w_q, scale), np.float32)
    np.testing.assert_array_equal(_np(got), pallas)


S8G4_PLAN_CASES = [
    (1, 3072, 8192, 128, "gemv", 2), (1, 3072, 3072, 128, "gemv", 4),
    (1, 3072, 1024, 128, "gemv", 4), (1, 8192, 3072, 128, "gemv", 8),
    (1, 3072, 128256, 128, "gemv", 1), (1, 4096, 14336, 128, "gemv", 2),
    (1, 14336, 4096, 128, "gemv", 4), (8, 3072, 8192, 128, "mma", 1),
    (16, 3072, 1000, 128, "mma", 1), (9, 3072, 1024, 128, "gemv", 8),
    (16, 8192, 4104, 128, "mma", 1),
    (17, 3072, 1024, 128, "mma", 1), (3, 256, 1000, 128, "gemv", 1),
    (3, 256, 200, 32, "gemv", 1), (2, 2048, 200, 128, "gemv", 4),
    (1, 768, 8, 128, "gemv", 1), (9, 2048, 1000, 64, "gemv", 4)]


@pytest.mark.parametrize("m,k,n,group,regime,split", S8G4_PLAN_CASES)
def test_s8g4_plan_regimes_and_splits(m, k, n, group, regime, split):
    """s8g4_matmul's plan: the GEMV at M ≤ 16 (the profiler's M = 1),
    its cluster a power of two that splits the n_groups/2 group pairs
    into runs of at least one, keeps two blocks an SM and the grid within
    the blocks the card holds at once in clusters of 4 or 8 (3072→8192:
    64 column tiles × 4 would run a second wave, so 2); the 16-row mma
    tiles above, or where no split holds a rank's dots at two blocks an
    SM (M = 8 at 3072→8192, M = 16 at K = 3072 and 8192)."""
    got = tprof.s8g4_plan(m, k, n, group)
    assert got == (regime, split)
    if regime == "mma":
        return
    n_groups, tiles = k // group, -(-n // tq.GEMV_COLS)
    half = n_groups // 2
    assert split in (1, 2, 4, 8) and split <= half
    assert tiles * split <= tprof.S8G4_CLUSTER_BLOCKS.get(split, tiles * split)
    assert tprof.s8g4_gemv_smem(m, n_groups, group, split) <= tprof.S8G4_GEMV_SMEM
    ranges = tq.split_ranges(half, split)
    assert [p for r in ranges for p in r] == list(range(half))
    assert min(len(r) for r in ranges) >= 1


def s8g4_gemv_mirror(xq, xs, w_q4, scale4, split=None):
    """s8g4_matmul's GEMV in the kernel's order: rank r of the plan's
    split takes group pairs [r·P/split, (r+1)·P/split); each of its K
    steps (32 packed rows) is an item, warp w taking items w, w + 8, ...;
    a step's two planes, 16 × the signed nibbles ((b << 4) & 0xF0 and
    b & 0xF0 as int8), give exact s32 dots shifted back by 4, the low
    plane against x's group-p columns and the high plane against group
    p + P's; a group's dot is the sum of its steps'; its term f32(d) ·
    (xs · ws) in f32; the output adds the n_groups terms in group order
    in f32, rounded once to bf16."""
    m, k = xq.shape
    n = w_q4.shape[1]
    n_groups = scale4.shape[0]
    group, half = k // n_groups, n_groups // 2
    spp = group // tprof.S8_GEMV_STEP
    split = split or tprof.s8g4_plan(m, k, n, group)[1]
    b = w_q4.view(torch.uint8).long()
    planes = [((b << 4) & 0xF0).to(torch.uint8).view(torch.int8).long(),
              (b & 0xF0).to(torch.uint8).view(torch.int8).long()]
    x = xq.long()
    dots = torch.zeros(n_groups, m, n, dtype=torch.long)
    for rank in tq.split_ranges(half, split):
        items = len(rank) * spp
        for w in range(tq.GEMV_WARPS):
            for it in range(w, items, tq.GEMV_WARPS):
                p = rank[0] + it // spp
                r0 = (rank[0] * spp + it) * tprof.S8_GEMV_STEP
                rows = slice(r0, r0 + tprof.S8_GEMV_STEP)
                for plane, gi in ((0, p), (1, p + half)):
                    d16 = x[:, rows.start + plane * (k // 2):rows.stop + plane * (k // 2)] \
                        @ planes[plane][rows]
                    assert (d16 % 16 == 0).all() and d16.abs().max() < 2 ** 31
                    dots[gi] += d16 >> 4
    assert dots.abs().max() < 2 ** 31
    acc = torch.zeros(m, n, dtype=torch.float32)
    for gi in range(n_groups):
        acc = acc + dots[gi].to(torch.int32).float() * (xs[:, gi:gi + 1] * scale4[gi:gi + 1])
    return acc.to(torch.bfloat16), split


@pytest.mark.parametrize("m,k,n,group,split", [
    (1, 256, 200, 32, None), (3, 256, 1000, 32, None), (9, 256, 136, 32, None),
    (3, 2048, 200, 128, None), (1, 2048, 1000, 64, 4), (16, 2048, 200, 128, 8)])
def test_s8g4_split_fold_bit_equal_to_reference_and_jax(jprof, m, k, n, group, split):
    """The GEMV's group-pair split, per-step s32 dots and group-order fold
    (at the plan's split, or another one: the bits do not depend on it)
    are bit-equal to s8g4_matmul_reference, and at K = 256, G = 32 to the
    JAX script's Pallas kernel in interpret mode, at N not a multiple of
    128. At K = 2048 XLA now and then contracts the JAX kernel's acc +
    dot·(xs·ws) into a fused multiply-add (as for int4_matmul_s8's kernel,
    tests/test_torch_quant.py), which the TPU kernel's math does not
    have: there an output may sit one bf16 step from the JAX one, in at
    most 0.1% of them."""
    rng = np.random.default_rng(30 + m)
    n_groups = k // group
    x = rng.standard_normal((m, k)).astype(np.float32)
    w_q4 = rng.integers(-128, 128, (k // 2, n)).astype(np.int8)
    scale4 = rng.uniform(0.005, 0.02, (n_groups, n)).astype(np.float32)
    xq, xs = tprof.quant_act_grouped(torch.from_numpy(x), n_groups)
    got, used = s8g4_gemv_mirror(xq, xs, torch.from_numpy(w_q4), torch.from_numpy(scale4),
                                 split)
    assert used == (split or tprof.s8g4_plan(m, k, n, group)[1])
    ref = tprof.s8g4_matmul_reference(xq, xs, torch.from_numpy(w_q4), torch.from_numpy(scale4))
    assert torch.equal(got, ref)
    pallas = np.asarray(jprof.s8g4_matmul(jnp.asarray(xq.numpy()), jnp.asarray(xs.numpy()),
                                          w_q4, scale4), np.float32)
    if k == 256:
        np.testing.assert_array_equal(_np(got), pallas)
        return
    off = _np(got) != pallas
    assert off.mean() <= 1e-3
    step = np.abs(pallas[off]) * 2.0 ** -7          # one bf16 step at |value| < 2^e
    assert (np.abs(_np(got)[off] - pallas[off]) <= step).all()


def test_s8_wrappers_run_plain_versions_on_cpu():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((3, 256)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((256, 200)).astype(np.float32))
    q8, q4 = tq.quantize_int8(w), tq.quantize_int4(w)
    tprof.reset_launch_counts()
    xq, xs = tprof.quant_act(x)
    torch.testing.assert_close(tprof.s8_matmul(xq, xs, q8["w_q"], q8["scale"]),
                               tprof.s8_matmul_reference(xq, xs, q8["w_q"], q8["scale"]),
                               rtol=0, atol=0)
    xq, xs = tprof.quant_act_grouped(x, 2)
    torch.testing.assert_close(tprof.s8g4_matmul(xq, xs, q4["w_q4"], q4["scale4"]),
                               tq.int4_matmul_s8(xq, xs, q4["w_q4"], q4["scale4"]),
                               rtol=0, atol=0)
    assert tprof.launch_counts == {"s8_matmul": 0, "s8g4_matmul": 0}


VARIANT_KEYS = ["layers bf16 dense", "layers int8 pallas (shipping)",
                "layers int8 XLA dequant-einsum", "layers s8xs8 MXU (prototype)",
                "layers int4 pallas (shipping)", "layers int4 XLA twin",
                "layers s8xs8 grouped-int4 (proto)", "lm_head int8 pallas (shipping)",
                "lm_head s8xs8 MXU (prototype)", "lm_head int8 XLA dequant-einsum"]


def test_profiler_main_runs_on_cpu(monkeypatch, capsys):
    """Every variant at a small model: d_model 256, d_ff 512, two layers
    (test-tiny's d_model 64 has no 128-row group)."""
    monkeypatch.setitem(tlm.LLAMA_CONFIGS, "test-small", tlm.LlamaDims(
        n_vocab=1024, d_model=256, n_layer=2, n_head=4, n_kv_head=2, d_ff=512,
        max_ctx=512))
    results = tprof.main(["--device", "cpu", "--model", "test-small", "--steps", "1",
                          "--iters", "1", "--variants",
                          "bf16,int8,xla8,s8,int4,xla4,s8g4,head"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == results and list(results) == VARIANT_KEYS
    assert all(v > 0 for v in results.values())


def test_profiler_main_needs_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tprof.main(["--steps", "1"])


# ---------------------------------------------------------------------------
# On the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs these checks on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(1, 512, 256), (3, 256, 1000), (20, 1024, 264)])
def test_cuda_s8_kernels_match_plain_versions(cuda_device, m, k, n):
    gen = torch.Generator(cuda_device).manual_seed(0)
    x = torch.randn(m, k, generator=gen, device=cuda_device)
    w = torch.randn(k, n, generator=gen, device=cuda_device) * k ** -0.5
    q8, q4 = tq.quantize_int8(w), tq.quantize_int4(w)
    xq, xs = tprof.quant_act(x)
    assert torch.equal(tprof.s8_matmul(xq, xs, q8["w_q"], q8["scale"]),
                       tprof.s8_matmul_reference(xq, xs, q8["w_q"], q8["scale"]))
    xq, xs = tprof.quant_act_grouped(x, k // tprof.GROUP)
    assert torch.equal(tprof.s8g4_matmul(xq, xs, q4["w_q4"], q4["scale4"]),
                       tprof.s8g4_matmul_reference(xq, xs, q4["w_q4"], q4["scale4"]))
    kv = tatt.quantize_cross_kv_int8(torch.randn(1, 2, 4, 1500, 64, generator=gen,
                                                 device=cuda_device),
                                     torch.randn(1, 2, 4, 1500, 64, generator=gen,
                                                 device=cuda_device))
    args = (torch.randn(2, 4, min(m, 8), 64, generator=gen, device=cuda_device)
            .to(torch.bfloat16), kv["k_q"][0], kv["v_q"][0], kv["k_scale"][0],
            kv["v_scale"][0])
    got = tatt.cross_attention_s8(*args, seq_len=1500).float()
    ref = tatt.cross_attention_s8_reference(*args, seq_len=1500).float()
    assert (got - ref).norm() <= 5e-3 * ref.norm()


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 2, 8, 9, 16, 17, 64, 512])
@pytest.mark.parametrize("k,n", [(1000, 4104), (3072, 1024), (260, 1000)])
def test_cuda_s8_matmul_both_regimes_bit_equal(cuda_device, m, k, n):
    """s8_matmul's GEMV (M ≤ 16: one or two n8 tiles of x) and mma tiles
    (M > 16), bit-equal to the plain version: ragged K (not a multiple of
    32) and N (4-byte loads at N % 16 != 0), K split over a cluster
    ((3072, 1024): 8 ranks)."""
    gen = torch.Generator(cuda_device).manual_seed(m)
    q = tq.quantize_int8(torch.randn(k, n, generator=gen, device=cuda_device) * k ** -0.5)
    xq, xs = tprof.quant_act(torch.randn(m, k, generator=gen, device=cuda_device))
    got = tprof.s8_matmul(xq, xs, q["w_q"], q["scale"])
    assert torch.equal(got, tprof.s8_matmul_reference(xq, xs, q["w_q"], q["scale"]))
    if (k, n) == (3072, 1024) and m <= 16:
        assert tprof.s8_plan(m, k, n) == ("gemv", 8)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 2, 8, 9, 16, 17])
@pytest.mark.parametrize("k,n", [(3072, 1000), (3072, 1024), (8192, 3072), (256, 136)])
def test_cuda_s8g4_matmul_both_regimes_bit_equal(cuda_device, m, k, n):
    """s8g4_matmul's GEMV (M ≤ 16) and mma tiles (M > 16, or where the
    GEMV's shared memory does not fit), bit-equal to the plain version and
    equal to int4_matmul_s8 on the same inputs: ragged N (1000: 4-byte
    loads; 136: a ragged column tile), K split over a cluster (3072→1024
    at M = 1: 4 ranks; 8192→3072: 8)."""
    gen = torch.Generator(cuda_device).manual_seed(m)
    q = tq.quantize_int4(torch.randn(k, n, generator=gen, device=cuda_device) * k ** -0.5)
    xq, xs = tq.quant_act_grouped(torch.randn(m, k, generator=gen, device=cuda_device),
                                  q["scale4"].shape[0])
    got = tprof.s8g4_matmul(xq, xs, q["w_q4"], q["scale4"])
    assert torch.equal(got, tprof.s8g4_matmul_reference(xq, xs, q["w_q4"], q["scale4"]))
    assert torch.equal(got, tq.int4_matmul_s8(xq, xs, q["w_q4"], q["scale4"]))


@pytest.mark.cuda
@pytest.mark.parametrize("tq_", [1, 4, 5, 35])
@pytest.mark.parametrize("t,seq_len", [(1500, 1500), (1500, 100), (300, 300), (200, 100)])
def test_cuda_cross_s8_cluster_matches_plain_version(cuda_device, tq_, t, seq_len):
    """cross_attention_s8 on its cluster of C > 1 ranks (Tpad 1536: 8;
    384: 3; 256: 2), query rows in chunks (Tq 35: five chunks of 7), and
    slices wholly past seq_len (100)."""
    gen = torch.Generator(cuda_device).manual_seed(tq_)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=cuda_device)

    kv = tatt.quantize_cross_kv_int8(randn(1, 2, 4, t, 64), randn(1, 2, 4, t, 64))
    args = (randn(2, 4, tq_, 64).to(torch.bfloat16), kv["k_q"][0], kv["v_q"][0],
            kv["k_scale"][0], kv["v_scale"][0])
    assert tatt.cross_int8_plan(tq_, kv["k_q"].shape[-1])[0] > 1
    out = tatt.cross_attention_s8(*args, seq_len=seq_len).float()
    ref = tatt.cross_attention_s8_reference(*args, seq_len=seq_len).float()
    assert (out - ref).abs().max().item() <= 2e-2
    assert (out - ref).norm() <= 5e-3 * ref.norm()


@pytest.mark.cuda
def test_cuda_cross_s8_rejects_tpad_not_multiple_of_16(cuda_device):
    """The cluster plan cuts Tpad in 16-key slices; the wrapper raises, it
    does not fall back."""
    q = torch.zeros(1, 1, 1, 64, dtype=torch.bfloat16, device=cuda_device)
    kq = torch.zeros(1, 1, 64, 100, dtype=torch.int8, device=cuda_device)
    vq = torch.zeros(1, 100, 64, dtype=torch.int8, device=cuda_device)
    scale = torch.ones(1, 1, device=cuda_device)
    with pytest.raises(ValueError, match="multiple of 16"):
        tatt.cross_attention_s8(q, kq, vq, scale, scale, seq_len=100)
