"""The port's fixed-shape decode steps and cadenced loops against the JAX
package: the steps a CUDA graph captures (`decode/greedy.py`,
`llm/generate.py`, `utils/step_loop.py`), run here on the CPU.

* The Llama step at a tensor `pos` (dense and int4, the JAX forward on
  its TPU route as in tests/test_torch_llama.py) equals JAX `lm.forward`
  at that `pos` within 1e-5 relative L2, logits and cache.
* The RoPE rows `models/llama.py` indexes from its tables are bit-equal
  to `_rope_tables` computed for those positions alone.
* The Whisper decoder step at a tensor `pos` over the whole f32 cache
  equals JAX `decoder_forward` within 1e-5 relative L2 (dense cross-KV;
  the int8 cross-KV step equals the port's int-`pos` step, whose gap to
  JAX is the cross route's own, within 1e-5).
* `greedy_decode_features` and `generate_tokens` run eagerly at the
  card's stop cadence (`graphed=False`, STOP_EVERY patched to 3 and to
  max_len) give JAX's tokens and lengths, sum_logprobs within 1e-5
  relative, and stop at the first read after the last row finished.
* A tensor `pos` with the int8 or lane cache raises; the step loop
  reads the stop flag at its cadence; launches made while a thread
  captures a graph go to the graph's record.
* `cuda`-marked, skipped here: on the card the graphed loops equal the
  eager step function bit for bit, and the launch counts include the
  replays.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_llama import DIMS as LDIMS
from test_torch_llama import TDIMS as LTDIMS
from test_torch_llama import jax_params, jax_tpu_route  # noqa: F401
from test_torch_quant import rel_l2
from turbo_whisper_workspace_tpu.decode import greedy as jgreedy
from turbo_whisper_workspace_tpu.decode import rules as jrules
from turbo_whisper_workspace_tpu.decode import tokenizer as jtok
from turbo_whisper_workspace_tpu.llm import generate as jgen
from turbo_whisper_workspace_tpu.models import llama as jlm
from turbo_whisper_workspace_tpu.models import whisper as jwm
from turbo_whisper_workspace_tpu_torch.decode import greedy as tgreedy
from turbo_whisper_workspace_tpu_torch.decode import rules as trules
from turbo_whisper_workspace_tpu_torch.decode import tokenizer as ttok
from turbo_whisper_workspace_tpu_torch.llm import generate as tgen
from turbo_whisper_workspace_tpu_torch.models import convert
from turbo_whisper_workspace_tpu_torch.models import llama as tlm
from turbo_whisper_workspace_tpu_torch.models import whisper as twm
from turbo_whisper_workspace_tpu_torch.ops import attention as tatt
from turbo_whisper_workspace_tpu_torch.ops import quant as tquant
from turbo_whisper_workspace_tpu_torch.utils import step_loop

STEP_TOL = 1e-5              # relative L2, f32 on both sides
WDIMS = jwm.WhisperDims(80, 1500, 64, 2, 2, 51865, 448, 64, 2, 2)
TWDIMS = twm.WhisperDims(**WDIMS.__dict__)
SP_J = jtok.special_tokens_for_vocab(WDIMS.n_vocab)
SP_T = ttok.special_tokens_for_vocab(WDIMS.n_vocab)
# rows of the greedy cadence case: feature row and prompt language; with
# the EOT embedding row scaled ×9 every row ends before max_len (at 7,
# 10, 4 and 12 sampled tokens), so the stop read decides when it ends
GREEDY_ROWS = ((0, "en"), (1, "ja"), (4, "zh"), (5, "it"))
GREEDY_LEN = 16


# ---------------------------------------------------------------------------
# Llama


@pytest.mark.parametrize("kind", ["dense", "int4"])
def test_llama_step_at_tensor_pos_matches_jax(kind, jax_tpu_route):
    params = jax_params(kind)
    tparams = convert.llama_from_jax_params(params, LTDIMS)
    tokens = np.random.default_rng(11).integers(0, LDIMS.n_vocab, (2, 7))
    jcache = jlm.init_kv_cache(LDIMS, 2, max_len=12, dtype=jnp.float32)
    tcache = tlm.init_kv_cache(LTDIMS, 2, max_len=12, dtype=torch.float32)
    _, jcache = jlm.forward(params, LDIMS, jnp.asarray(tokens[:, :6]), jcache, pos=0)
    _, tcache = tlm.forward(tparams, LTDIMS, torch.from_numpy(tokens[:, :6]), tcache, pos=0)
    ref, jcache = jlm.forward(params, LDIMS, jnp.asarray(tokens[:, 6:]), jcache,
                              pos=jnp.asarray(6))
    got, tcache = tlm.forward(tparams, LTDIMS, torch.from_numpy(tokens[:, 6:]), tcache,
                              pos=torch.tensor(6))
    assert got.shape == ref.shape
    assert rel_l2(got.numpy(), ref) <= STEP_TOL
    for name in ("k", "v"):
        assert rel_l2(tcache[name].numpy(), jcache[name]) <= STEP_TOL
        assert not tcache[name][:, :, 7:].any()          # nothing written past pos


@pytest.mark.parametrize("name", ["test-tiny", "llama-3.2-3b", "llama-3.1-8b"])
def test_rope_rows_bit_equal_to_per_call_tables(name):
    dims = tlm.LLAMA_CONFIGS[name]
    half = dims.head_dim // 2
    for positions in ([0], [1, 2, 3], [17], [dims.max_ctx - 1], list(range(40, 140))):
        pos = torch.tensor(positions)
        got = tlm._rope_rows(dims, pos)
        ref = tlm._rope_tables(pos, half, dims.rope_theta)
        for g, r in zip(got, ref):
            assert g.shape == r.shape == (1, len(positions), 1, half)
            assert torch.equal(g, r), (name, positions)


# ---------------------------------------------------------------------------
# Whisper


@pytest.fixture(scope="module")
def whisper_setup():
    params = jwm.init_params(WDIMS, jax.random.PRNGKey(0))
    model = convert.from_jax_params(jax.tree.map(np.asarray, params), TWDIMS)
    return params, model


@pytest.mark.parametrize("quantize", [False, True])
def test_whisper_step_at_tensor_pos_over_the_full_cache(whisper_setup, quantize):
    params, model = whisper_setup
    rng = np.random.default_rng(12)
    feats = (rng.standard_normal((2, WDIMS.n_audio_ctx, WDIMS.n_audio_state)) * 0.3
             ).astype(np.float32)
    tokens = rng.integers(0, 50000, (2, 5))
    ckv_t = model.decoder.precompute_cross_kv(torch.from_numpy(feats), quantize=quantize)
    caches = [twm.init_kv_cache(TWDIMS, 2, max_len=12, dtype=torch.float32)
              for _ in range(2)]
    for cache in caches:
        model.decoder(torch.from_numpy(tokens[:, :4]), ckv_t, cache, pos=0)
    got, _ = model.decoder(torch.from_numpy(tokens[:, 4:]), ckv_t, caches[0],
                           pos=torch.tensor(4))
    if quantize:
        # the int-pos step, sliced to the keys written so far
        ref, _ = model.decoder(torch.from_numpy(tokens[:, 4:]), ckv_t, caches[1], pos=4)
        ref_k = caches[1]["k"].numpy()
    else:
        ckv_j = jwm.precompute_cross_kv(params, WDIMS, feats)
        jcache = jwm.init_kv_cache(WDIMS, 2, max_len=12, dtype=jnp.float32)
        _, jcache = jwm.decoder_forward(params, WDIMS, jnp.asarray(tokens[:, :4]), ckv_j,
                                        jcache, pos=0)
        ref, jcache = jwm.decoder_forward(params, WDIMS, jnp.asarray(tokens[:, 4:]), ckv_j,
                                          jcache, pos=jnp.asarray(4))
        ref_k = jcache["k"]
    assert got.shape == (2, 1, WDIMS.n_vocab)
    assert rel_l2(got.numpy(), ref) <= STEP_TOL
    assert rel_l2(caches[0]["k"].numpy(), ref_k) <= STEP_TOL
    assert not caches[0]["k"][:, :, 5:].any()


@pytest.mark.parametrize("mode", ["int8", "lanes"])
def test_tensor_pos_with_the_int8_or_lane_cache_raises(whisper_setup, mode):
    _, model = whisper_setup
    feats = torch.zeros((2, WDIMS.n_audio_ctx, WDIMS.n_audio_state))
    ckv = model.decoder.precompute_cross_kv(feats, quantize=True)
    cache = twm.init_kv_cache(TWDIMS, 2, max_len=8, quantize=True)
    kw = {}
    if mode == "lanes":
        cache = twm.beam_lane_cache(cache, beam=2)
        kw = dict(beam=2, lane_map=torch.zeros((1, 2, 8), dtype=torch.int32))
    with pytest.raises(ValueError, match="beam loop"):
        model.decoder(torch.zeros((2, 1), dtype=torch.long), ckv, cache,
                      pos=torch.tensor(3), **kw)


@pytest.fixture(scope="module")
def greedy_setup():
    """JAX weights with the EOT embedding row scaled ×9, the port's twin,
    and the rows of GREEDY_ROWS (int8 cross-KV, prompts by language)."""
    params = jax.tree.map(np.array, jwm.init_params(WDIMS, jax.random.PRNGKey(0)))
    params["decoder"]["token_emb"][SP_J.eot] *= 9.0
    model = convert.from_jax_params(params, TWDIMS)
    feats = (np.random.default_rng(1).standard_normal(
        (6, WDIMS.n_audio_ctx, WDIMS.n_audio_state)) * 0.3).astype(np.float32)
    feats = feats[[row for row, _ in GREEDY_ROWS]]
    prompt = np.array([SP_J.sot_sequence(lang) for _, lang in GREEDY_ROWS], np.int32)
    ref = jgreedy.greedy_decode_features(
        params, WDIMS, jwm.precompute_cross_kv(params, WDIMS, feats, quantize=True),
        jnp.asarray(prompt), rules=jrules.DecodeRules(specials=SP_J), max_len=GREEDY_LEN)
    ckv_t = model.decoder.precompute_cross_kv(torch.from_numpy(feats), quantize=True)
    return model, ckv_t, torch.from_numpy(prompt).long(), ref


@pytest.mark.parametrize("every", [3, GREEDY_LEN])
def test_greedy_at_the_card_cadence_matches_jax(greedy_setup, every, monkeypatch):
    model, ckv_t, prompt, ref = greedy_setup
    monkeypatch.setattr(tgreedy, "STOP_EVERY", every)
    timings = {}
    got = tgreedy.greedy_decode_features(
        model, ckv_t, prompt, rules=trules.DecodeRules(specials=SP_T), max_len=GREEDY_LEN,
        graphed=False, timings=timings)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(ref.lengths))
    for field in ("sum_logprobs", "avg_logprobs", "no_speech_probs"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(ref, field)), rtol=STEP_TOL)
    # every row ends before max_len; the loop stops at the first read of
    # the flag after the last EOT (the decoder calls after the prefill:
    # one per sampled token after the first)
    last = int(np.asarray(ref.lengths).max())
    assert last < GREEDY_LEN - 1
    assert timings["decode_forwards"] == min(-(-last // every) * every, GREEDY_LEN - 1)
    assert timings["capture_s"] == 0.0


@pytest.mark.parametrize("every", [3, 8])
def test_generate_at_the_card_cadence_matches_jax(every, monkeypatch, jax_tpu_route):
    params = jax_params("int4")
    tparams = convert.llama_from_jax_params(params, LTDIMS)
    prompt = np.random.default_rng(13).integers(1, LDIMS.n_vocab, (2, 9))
    free = jgen.generate_tokens(params, LDIMS, jnp.asarray(prompt, jnp.int32), max_len=8)
    # EOS: row 0's third sampled token and row 1's fifth, so both rows end
    eos = (int(free.tokens[0, 11]), int(free.tokens[1, 13]))
    ref = jgen.generate_tokens(params, LDIMS, jnp.asarray(prompt, jnp.int32), max_len=8,
                               eos_tokens=eos)
    monkeypatch.setattr(tgen, "STOP_EVERY", every)
    timings = {}
    got = tgen.generate_tokens(tparams, LTDIMS, torch.from_numpy(prompt), max_len=8,
                               eos_tokens=eos, graphed=False, timings=timings)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(ref.lengths))
    last = int(np.asarray(ref.lengths).max())
    assert last <= 4
    assert timings["decode_forwards"] == min(-(-last // every) * every, 7)


# ---------------------------------------------------------------------------
# The step loop


def test_run_steps_reads_the_flag_at_its_cadence():
    """A step that finishes row r at step r + 1: the loop reads the flag
    before the first step and after every `every`, and stops at the first
    read that finds every row finished."""
    for every, rows, n_steps, want in ((3, 4, 10, 6), (1, 4, 10, 4), (5, 2, 3, 3),
                                       (4, 1, 10, 4), (2, 0, 10, 0)):
        state = {"finished": torch.zeros(max(rows, 1), dtype=torch.bool),
                 "step": torch.zeros((), dtype=torch.long)}
        if rows == 0:
            state["finished"].fill_(True)

        def step(state=state, rows=rows):
            state["step"].add_(1)
            state["finished"][:int(state["step"])] = True

        timings = {}
        assert step_loop.run_steps(step, state, n_steps, every, False,
                                   timings=timings) == want, (every, rows, n_steps)
        assert int(state["step"]) == want and timings["capture_s"] == 0.0
    with pytest.raises(ValueError, match="CUDA"):
        step_loop.run_steps(step, state, 4, 2, True)


def test_launches_during_a_capture_go_to_its_record():
    """While a thread captures a graph, its wrappers' launches go to the
    graph's record (each replay adds them); another thread's launches
    still count at once."""
    tatt.reset_launch_counts()
    tquant.reset_launch_counts()
    tatt.capture.record = record = {}
    try:
        tatt.count_launch(tatt.launch_counts, "cross_attention_int8")
        tatt.count_launch(tatt.launch_counts, "cross_attention_int8")
        other = threading.Thread(target=tatt.count_launch,
                                 args=(tquant.launch_counts, "int8_matmul"))
        other.start()
        other.join(timeout=10)
        assert not other.is_alive()
    finally:
        tatt.capture.record = None
    assert record == {"cross_attention_int8": (tatt.launch_counts, 2)}
    assert tatt.launch_counts["cross_attention_int8"] == 0
    assert tquant.launch_counts["int8_matmul"] == 1
    tatt.count_launch(tatt.launch_counts, "cross_attention_int8")
    assert tatt.launch_counts["cross_attention_int8"] == 1
    tquant.reset_launch_counts()
    tatt.reset_launch_counts()


# ---------------------------------------------------------------------------
# On the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py phase 13 runs these on the card")
    return torch.device("cuda")


def _counts() -> dict:
    return {**tatt.launch_counts, **tquant.launch_counts}


def _reset() -> None:
    tatt.reset_launch_counts()
    tquant.reset_launch_counts()


@pytest.mark.cuda
@pytest.mark.parametrize("cross_s8", [False, True])
def test_cuda_graphed_greedy_equals_the_eager_step(cuda_device, cross_s8):
    """Large-v3-turbo's head width (64) at 2 heads and 2 + 2 layers in
    bf16: the graphed loop's tokens, lengths and sum_logprobs equal the
    eager step function's bit for bit, and the launch counts hold the
    replays: the graphed run's are the eager run's plus its warm-up step,
    an eager step run once before the capture."""
    dims = twm.WhisperDims(80, 1500, 128, 2, 2, 51866, 448, 128, 2, 2)
    model = twm.init_params(dims, torch.Generator(cuda_device).manual_seed(0), torch.bfloat16)
    feats = torch.randn((4, 1500, 128), generator=torch.Generator(cuda_device).manual_seed(1),
                        device=cuda_device).to(torch.bfloat16)
    ckv = model.decoder.precompute_cross_kv(feats, quantize=True)
    sp = ttok.special_tokens_for_vocab(dims.n_vocab)
    prompt = torch.tensor([sp.sot_sequence("en")] * 4, device=cuda_device)
    kw = dict(rules=trules.DecodeRules(specials=sp), max_len=40, cross_s8=cross_s8)
    runs = {}
    for graphed in (False, True):
        _reset()
        timings = {}
        res = tgreedy.greedy_decode_features(model, ckv, prompt, graphed=graphed,
                                             timings=timings, **kw)
        torch.cuda.synchronize()
        runs[graphed] = (res, _counts(), timings)
    (eager, eager_counts, eager_t), (graph, graph_counts, timings) = runs[False], runs[True]
    for field in ("tokens", "lengths", "sum_logprobs"):
        assert torch.equal(getattr(graph, field), getattr(eager, field)), field
    assert timings["capture_s"] > 0 and eager_t["capture_s"] == 0
    steps = timings["decode_forwards"]
    assert steps == eager_t["decode_forwards"] > 0
    # one launch a layer a decoder call: the prefill's, then one call a step
    kernel = "cross_attention_s8" if cross_s8 else "cross_attention_int8"
    assert eager_counts[kernel] == 2 * (1 + steps), eager_counts
    assert graph_counts[kernel] == 2 * (1 + steps + 1), graph_counts
    assert sum(graph_counts.values()) == sum(eager_counts.values()) + 2


@pytest.mark.cuda
def test_cuda_graphed_generate_equals_the_eager_step(cuda_device):
    """test-tiny Llama, int4 body and int8 head in bf16: greedy tokens
    equal bit for bit, launch counts equal with the replays counted, and a
    sampled run is seeded."""
    dims = tlm.LLAMA_CONFIGS["test-tiny"]
    params = tquant.quantize_tree(tlm.init_params(
        dims, torch.Generator(cuda_device).manual_seed(0), torch.bfloat16, cuda_device), bits=4)
    prompt = torch.randint(1, dims.n_vocab, (2, 9),
                           generator=torch.Generator(cuda_device).manual_seed(2),
                           device=cuda_device)
    runs = {}
    for graphed in (False, True):
        _reset()
        timings = {}
        res = tgen.generate_tokens(params, dims, prompt, max_len=24, graphed=graphed,
                                   timings=timings)
        torch.cuda.synchronize()
        runs[graphed] = (res, _counts(), timings)
    (eager, eager_counts, eager_t), (graph, graph_counts, timings) = runs[False], runs[True]
    assert torch.equal(graph.tokens, eager.tokens) and torch.equal(graph.lengths, eager.lengths)
    assert timings["capture_s"] > 0 and eager_t["capture_s"] == 0
    steps = timings["decode_forwards"]
    assert steps == eager_t["decode_forwards"] > 0
    # the prefill (m = 18): int4_matmul for the 7 body projections of each
    # of 2 layers and int8_matmul for the head; a step: int4_matmul_s8 and
    # int8_matmul. The graphed run adds its warm-up step.
    for counts, n in ((eager_counts, steps), (graph_counts, steps + 1)):
        assert counts["int4_matmul"] == 14, counts
        assert counts["int4_matmul_s8"] == 14 * n, counts
        assert counts["int8_matmul"] == 1 + n, counts
    sampled = [tgen.generate_tokens(params, dims, prompt, max_len=24, temperature=0.6,
                                    generator=torch.Generator(cuda_device).manual_seed(s))
               for s in (3, 3, 4)]
    assert torch.equal(sampled[0].tokens, sampled[1].tokens)
    assert not torch.equal(sampled[0].tokens, sampled[2].tokens)
