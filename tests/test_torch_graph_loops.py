"""The port's fixed-shape decode steps and cadenced loops against the JAX
package: the steps a CUDA graph captures (`decode/greedy.py`,
`llm/generate.py`, `utils/step_loop.py`), run here on the CPU.

* The Llama step at a tensor `pos` (dense and int4, the JAX forward on
  its TPU route as in tests/test_torch_llama.py) equals JAX `lm.forward`
  at that `pos` within 1e-5 relative L2, logits and cache.
* The RoPE rows the forwards index from `models/llama.rope_table`'s
  cached tables are bit-equal to `_rope_tables` computed for those
  positions alone.
* The Whisper decoder step at a tensor `pos` over the whole f32 cache
  equals JAX `decoder_forward` within 1e-5 relative L2 (dense cross-KV;
  the int8 cross-KV step equals the port's int-`pos` step, whose gap to
  JAX is the cross route's own, within 1e-5).
* A beam step at a tensor `pos` over the int8 and the lane caches
  equals the int-`pos` step bit for bit (logits and cache) and JAX
  `decoder_forward` within 1e-5 relative L2 (dense cross-KV).
* `greedy_decode_features`, `beam_decode_features` (its three cache
  modes) and `generate_tokens` run eagerly at the card's stop cadence
  (`graphed=False`, STOP_EVERY patched to 3 and to max_len) give JAX's
  tokens and lengths (greedy: sum_logprobs within 1e-5 relative; beam:
  the finished sets equal, scores within 1e-3), and stop at the first
  read after the last row finished (beam: every item saturated).
* The step loop reads the stop flag at its cadence; launches made while
  a thread captures a graph go to the graph's record.
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
from turbo_whisper_workspace_tpu.decode import beam as jbeam
from turbo_whisper_workspace_tpu.decode import greedy as jgreedy
from turbo_whisper_workspace_tpu.decode import rules as jrules
from turbo_whisper_workspace_tpu.decode import tokenizer as jtok
from turbo_whisper_workspace_tpu.llm import generate as jgen
from turbo_whisper_workspace_tpu.models import llama as jlm
from turbo_whisper_workspace_tpu.models import whisper as jwm
from turbo_whisper_workspace_tpu_torch.decode import beam as tbeam
from turbo_whisper_workspace_tpu_torch.decode import greedy as tgreedy
from turbo_whisper_workspace_tpu_torch.decode import rules as trules
from turbo_whisper_workspace_tpu_torch.decode import tokenizer as ttok
from turbo_whisper_workspace_tpu_torch.llm import generate as tgen
from turbo_whisper_workspace_tpu_torch.models import convert
from turbo_whisper_workspace_tpu_torch.models import llama as tlm
from turbo_whisper_workspace_tpu_torch.models import whisper as twm
from turbo_whisper_workspace_tpu_torch.ops import attention as tatt
from turbo_whisper_workspace_tpu_torch.ops import build as tbuild
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
        got = tuple(tab.index_select(0, pos)[None, :, None, :] for tab in tlm.rope_table(
            half, dims.rope_theta, dims.max_ctx, pos.device))
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
def test_beam_step_at_tensor_pos_over_the_int8_and_lane_caches(whisper_setup, mode):
    """A beam-3 step at pos 5 over the regathered int8 cache and over the
    lane cache, after a prefill of 4 tokens and a step at pos 4 (then a
    regather: the beams continue beams 2, 0, 0), at a tensor pos: equal
    to the same step at an int pos bit for bit, logits and cache, and to
    JAX `decoder_forward` at a traced pos within STEP_TOL."""
    params, model = whisper_setup
    beam, b, total = 3, 2, 10
    rng = np.random.default_rng(14)
    feats = (rng.standard_normal((b, WDIMS.n_audio_ctx, WDIMS.n_audio_state)) * 0.3
             ).astype(np.float32)
    prefill = rng.integers(0, 50000, (b, 4))
    steps = rng.integers(0, 50000, (2, b * beam, 1))
    src = np.array([2, 0, 0])
    ckv_t = model.decoder.precompute_cross_kv(torch.from_numpy(feats))
    ckv_j = jwm.precompute_cross_kv(params, WDIMS, feats)
    tcache = twm.init_kv_cache(TWDIMS, b, max_len=total, dtype=torch.float32, quantize=True)
    model.decoder(torch.from_numpy(prefill), ckv_t, tcache, pos=0)
    jcache = jwm.init_kv_cache(WDIMS, b, max_len=total, quantize=True)
    _, jcache = jwm.decoder_forward(params, WDIMS, jnp.asarray(prefill), ckv_j, jcache, pos=0)
    lane_maps = [None, None]
    if mode == "lanes":
        tcache, jcache = twm.beam_lane_cache(tcache, beam), jwm.beam_lane_cache(jcache, beam)
        lane_maps = [np.zeros((b, beam, total), np.int32) for _ in range(2)]
        lane_maps[0][:, :, 4] = np.arange(beam)
        lane_maps[1][:, :, 4] = src
        lane_maps[1][:, :, 5] = np.arange(beam)
    else:
        tcache = {key: x.repeat_interleave(beam, 1) for key, x in tcache.items()}
        jcache = jax.tree.map(lambda x: jnp.repeat(x, beam, axis=1), jcache)
    kw = [dict(beam=beam, lane_map=None if m is None else torch.from_numpy(m))
          for m in lane_maps]
    jkw = [dict(beam=beam, lane_map=None if m is None else jnp.asarray(m)) for m in lane_maps]
    model.decoder(torch.from_numpy(steps[0]), ckv_t, tcache, pos=4, **kw[0])
    _, jcache = jwm.decoder_forward(params, WDIMS, jnp.asarray(steps[0]), ckv_j, jcache,
                                    pos=4, **jkw[0])
    if mode == "int8":
        rows = (np.arange(b)[:, None] * beam + src).reshape(-1)
        tcache = {key: x[:, torch.from_numpy(rows)] for key, x in tcache.items()}
        jcache = jax.tree.map(lambda x: x[:, rows], jcache)
    caches = [{key: x.clone() for key, x in tcache.items()} for _ in range(2)]
    tok = torch.from_numpy(steps[1])
    ref, _ = model.decoder(tok, ckv_t, caches[0], pos=5, **kw[1])
    got, _ = model.decoder(tok, ckv_t, caches[1], pos=torch.tensor(5), **kw[1])
    assert got.shape == (b * beam, 1, WDIMS.n_vocab)
    assert torch.equal(got, ref)
    for key in caches[0]:
        assert torch.equal(caches[1][key], caches[0][key]), key
    jref, _ = jwm.decoder_forward(params, WDIMS, jnp.asarray(steps[1]), ckv_j, jcache,
                                  pos=jnp.asarray(5), **jkw[1])
    assert rel_l2(got.numpy(), jref) <= STEP_TOL


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


BEAM_SIZE = 5
# (quantize_cache, lane_cache): bf16 and int8 regathered, int8 lanes
BEAM_MODES = {"bf16": (False, False), "int8": (True, False), "lanes": (True, True)}


@pytest.fixture(scope="module")
def beam_refs(greedy_setup):
    """JAX beam search (beam 5) on greedy_setup's rows, per cache mode. With
    the EOT row scaled every item holds K finished hypotheses before
    max_len (after 11-13 selections), so the JAX loop stops on
    saturation."""
    model, ckv_t, prompt, _ = greedy_setup
    params = jax.tree.map(np.array, jwm.init_params(WDIMS, jax.random.PRNGKey(0)))
    params["decoder"]["token_emb"][SP_J.eot] *= 9.0
    feats = (np.random.default_rng(1).standard_normal(
        (6, WDIMS.n_audio_ctx, WDIMS.n_audio_state)) * 0.3).astype(np.float32)
    ckv_j = jwm.precompute_cross_kv(params, WDIMS, feats[[row for row, _ in GREEDY_ROWS]],
                                    quantize=True)
    return {mode: jbeam.beam_decode_features(
        params, WDIMS, ckv_j, jnp.asarray(prompt.numpy(), jnp.int32),
        rules=jrules.DecodeRules(specials=SP_J), beam_size=BEAM_SIZE, max_len=GREEDY_LEN,
        quantize_cache=q, lane_cache=lane) for mode, (q, lane) in BEAM_MODES.items()}


@pytest.mark.parametrize("every", [3, GREEDY_LEN])
@pytest.mark.parametrize("mode", list(BEAM_MODES))
def test_beam_at_the_card_cadence_matches_jax(greedy_setup, beam_refs, mode, every,
                                              monkeypatch):
    model, ckv_t, prompt, _ = greedy_setup
    ref = beam_refs[mode]
    quantize_cache, lane_cache = BEAM_MODES[mode]
    monkeypatch.setattr(tbeam, "STOP_EVERY", every)
    timings = {}
    got = tbeam.beam_decode_features(
        model, ckv_t, prompt, rules=trules.DecodeRules(specials=SP_T),
        beam_size=BEAM_SIZE, max_len=GREEDY_LEN, quantize_cache=quantize_cache,
        lane_cache=lane_cache, graphed=False, timings=timings)
    for field in ("tokens", "lengths", "all_tokens"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(ref, field)))
    # scores: 1e-3 as tests/test_torch_decode.py holds beam search. The int8
    # caches round each step's K/V rows from f32 projections whose last
    # bits differ between torch and XLA; a row that lands on the other
    # side of a .5 moves every later step's scores, which reach 2.7e-3
    # (5e-5 relative) over these 11-13 selections, on the port's previous
    # eager loop as on this one: there the limit adds 1e-4 relative
    rtol = 1e-4 if quantize_cache else 0.0
    for field in ("sum_logprobs", "avg_logprobs", "no_speech_probs", "all_scores"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(ref, field)), atol=1e-3, rtol=rtol)
    # every slot holds a finished hypothesis (an alive fallback has no
    # EOT), and the JAX loop ran n selections: the last item to saturate
    # retired its K-th hypothesis at step n - 1, the longest of the
    # finished sets (one retired at step s holds s sampled tokens, then EOT)
    is_eot = np.asarray(ref.all_tokens)[:, :, prompt.shape[1]:] == SP_J.eot
    assert is_eot.any(-1).all()
    n = int(is_eot.argmax(-1).max()) + 1
    assert n < GREEDY_LEN
    # step 0's forward, then the steps up to the first read of the flag
    # after the n-th selection
    assert timings["decode_forwards"] == 1 + min(-(-(n - 1) // every) * every,
                                                 GREEDY_LEN - 1)
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
    tbuild.capture.record = record = {}
    try:
        tbuild.count_launch(tatt.launch_counts, "cross_attention_int8")
        tbuild.count_launch(tatt.launch_counts, "cross_attention_int8")
        other = threading.Thread(target=tbuild.count_launch,
                                 args=(tquant.launch_counts, "int8_matmul"))
        other.start()
        other.join(timeout=10)
        assert not other.is_alive()
    finally:
        tbuild.capture.record = None
    assert record == {"cross_attention_int8": (tatt.launch_counts, 2)}
    assert tatt.launch_counts["cross_attention_int8"] == 0
    assert tquant.launch_counts["int8_matmul"] == 1
    tbuild.count_launch(tatt.launch_counts, "cross_attention_int8")
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
@pytest.mark.parametrize("mode", list(BEAM_MODES))
def test_cuda_graphed_beam_equals_the_eager_step(cuda_device, mode):
    """Large-v3-turbo's head width (64) at 2 heads and 2 + 2 layers in
    bf16, beam 5 over 4 windows in each self-KV cache mode: every field
    of the graphed loop's result equals the eager step function's bit
    for bit, and the launch counts hold the replays: the graphed run's
    are the eager run's plus its warm-up step."""
    dims = twm.WhisperDims(80, 1500, 128, 2, 2, 51866, 448, 128, 2, 2)
    model = twm.init_params(dims, torch.Generator(cuda_device).manual_seed(0), torch.bfloat16)
    feats = torch.randn((4, 1500, 128), generator=torch.Generator(cuda_device).manual_seed(1),
                        device=cuda_device).to(torch.bfloat16)
    ckv = model.decoder.precompute_cross_kv(feats, quantize=True)
    sp = ttok.special_tokens_for_vocab(dims.n_vocab)
    prompt = torch.tensor([sp.sot_sequence("en")] * 4, device=cuda_device)
    quantize_cache, lane_cache = BEAM_MODES[mode]
    kw = dict(rules=trules.DecodeRules(specials=sp), beam_size=5, max_len=40,
              quantize_cache=quantize_cache, lane_cache=lane_cache)
    runs = {}
    for graphed in (False, True):
        _reset()
        timings = {}
        res = tbeam.beam_decode_features(model, ckv, prompt, graphed=graphed,
                                         timings=timings, **kw)
        torch.cuda.synchronize()
        runs[graphed] = (res, _counts(), timings)
    (eager, eager_counts, eager_t), (graph, graph_counts, timings) = runs[False], runs[True]
    for field in tbeam.BeamResult._fields:
        assert torch.equal(getattr(graph, field), getattr(eager, field)), field
    assert timings["capture_s"] > 0 and eager_t["capture_s"] == 0
    steps = timings["decode_forwards"]
    assert steps == eager_t["decode_forwards"] > 1
    # cross-attention: the prefill's and one call a step, a launch a layer;
    # self-attention over the int8 caches: the steps only (the prefill's
    # is plain torch)
    kernel = {"int8": "self_attention_int8", "lanes": "self_attention_int8_lanes"}.get(mode)
    for counts, n in ((eager_counts, steps), (graph_counts, steps + 1)):
        assert counts["cross_attention_int8"] == 2 * (1 + n), counts
        if kernel:
            assert counts[kernel] == 2 * n, counts


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
