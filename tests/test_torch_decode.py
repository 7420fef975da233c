"""Port decode (turbo_whisper_workspace_tpu_torch/decode) against the JAX
package: token rules, greedy decode at T=0, beam search in its three
self-KV cache modes and language detection on the same weights and
cross-KV, the mel-in helpers greedy_decode and detect_language, and
ops/mel.py:stft_power; sampled decode (T>0) for grammar validity only,
since torch's generator cannot reproduce JAX's rbg draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turbo_whisper_workspace_tpu.decode import beam as jbeam
from turbo_whisper_workspace_tpu.decode import greedy as jgreedy
from turbo_whisper_workspace_tpu.decode import rules as jrules
from turbo_whisper_workspace_tpu.decode import tokenizer as jtok
from turbo_whisper_workspace_tpu.models import whisper as jwm
from turbo_whisper_workspace_tpu.ops import mel as jmel
from turbo_whisper_workspace_tpu_torch.decode import beam as tbeam
from turbo_whisper_workspace_tpu_torch.decode import greedy as tgreedy
from turbo_whisper_workspace_tpu_torch.decode import rules as trules
from turbo_whisper_workspace_tpu_torch.decode import tokenizer as ttok
from turbo_whisper_workspace_tpu_torch.models import convert
from turbo_whisper_workspace_tpu_torch.models import whisper as twm
from turbo_whisper_workspace_tpu_torch.ops import mel as tmel

DIMS = jwm.WhisperDims(80, 1500, 64, 2, 2, 51865, 448, 64, 2, 2)
SP_J = jtok.special_tokens_for_vocab(DIMS.n_vocab)
SP_T = ttok.special_tokens_for_vocab(DIMS.n_vocab)


@pytest.fixture(scope="module")
def setup():
    params = jwm.init_params(DIMS, jax.random.PRNGKey(0))
    model = convert.from_jax_params(jax.tree.map(np.asarray, params),
                                    twm.WhisperDims(**DIMS.__dict__))
    feats = (np.random.default_rng(1).standard_normal(
        (3, DIMS.n_audio_ctx, DIMS.n_audio_state)) * 0.3).astype(np.float32)
    ckv_j = jwm.precompute_cross_kv(params, DIMS, feats, quantize=True)
    ckv_t = model.decoder.precompute_cross_kv(torch.from_numpy(feats), quantize=True)
    return params, model, ckv_j, ckv_t


@pytest.mark.parametrize("timestamps", [True, False])
def test_rules_apply_matches_jax(timestamps):
    rng = np.random.default_rng(0)
    jr = jrules.DecodeRules(specials=SP_J, timestamps=timestamps)
    tr = trules.DecodeRules(specials=SP_T, timestamps=timestamps)
    np.testing.assert_array_equal(tr.static_mask().numpy(), np.asarray(jr.static_mask()))
    np.testing.assert_array_equal(tr.begin_mask().numpy(), np.asarray(jr.begin_mask()))
    tsb = SP_J.timestamp_begin
    # rows: text/text, ts/text, ts/ts, text/ts, and a raised floor
    last = np.array([100, tsb + 5, tsb + 7, 300, tsb + 9], np.int64)
    penult = np.array([200, 150, tsb + 3, tsb + 2, 17], np.int64)
    floor = np.array([tsb, tsb + 5, tsb + 8, tsb + 3, tsb + 40], np.int64)
    logits = rng.standard_normal((5, DIMS.n_vocab)).astype(np.float32) * 3
    logits[1, tsb:] += 4.0                      # timestamp mass wins on row 1
    for is_begin in (True, False):
        ref = np.asarray(jr.apply(
            jnp.asarray(logits), jnp.asarray(is_begin), jnp.asarray(last),
            jnp.asarray(penult), jnp.asarray(floor), jr.static_mask(), jr.begin_mask()))
        got = tr.apply(torch.from_numpy(logits), is_begin, torch.from_numpy(last),
                       torch.from_numpy(penult), torch.from_numpy(floor),
                       tr.static_mask(), tr.begin_mask()).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


def test_update_ts_floor_matches_jax():
    tsb = SP_J.timestamp_begin
    nxt = np.array([tsb + 4, tsb + 4, 300, 300, tsb + 1], np.int64)
    prev = np.array([200, tsb + 2, tsb + 6, 100, tsb + 9], np.int64)
    floor = np.full(5, tsb + 3, np.int64)
    ref = np.asarray(jrules.update_ts_floor(jnp.asarray(floor), jnp.asarray(nxt),
                                            jnp.asarray(prev), SP_J))
    got = trules.update_ts_floor(torch.from_numpy(floor), torch.from_numpy(nxt),
                                 torch.from_numpy(prev), SP_T).numpy()
    np.testing.assert_array_equal(got, ref)


def test_greedy_t0_matches_jax(setup):
    params, model, ckv_j, ckv_t = setup
    prompt = np.array([SP_J.sot_sequence("en")] * 3, np.int32)
    kw = dict(max_len=20)
    ref = jgreedy.greedy_decode_features(
        params, DIMS, ckv_j, jnp.asarray(prompt),
        rules=jrules.DecodeRules(specials=SP_J), **kw)
    got = tgreedy.greedy_decode_features(
        model, ckv_t, torch.from_numpy(prompt).long(),
        rules=trules.DecodeRules(specials=SP_T), **kw)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(ref.lengths))
    for field in ("avg_logprobs", "sum_logprobs", "no_speech_probs"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(ref, field)), atol=1e-3)


def test_detect_language_matches_jax(setup):
    params, model, ckv_j, ckv_t = setup
    args = (SP_J.sot, SP_J.sot + 1, SP_J.n_languages)
    ref = np.asarray(jgreedy.detect_language_features(params, DIMS, ckv_j, *args))
    got = tgreedy.detect_language_features(model, ckv_t, *args).numpy()
    assert got.shape == (3, SP_J.n_languages)
    np.testing.assert_allclose(got, ref, atol=1e-3)
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


def _check_grammar(sampled, sp, suppressed):
    """One row of sampled tokens obeys the timestamp grammar."""
    eot_at = np.flatnonzero(sampled == sp.eot)
    body = sampled[: eot_at[0]] if eot_at.size else sampled
    assert (sampled[body.size:] == sp.eot).all()
    if body.size == 0:
        return
    assert sp.timestamp_begin <= body[0] <= sp.timestamp_begin + 50
    assert not np.isin(body, suppressed).any()
    is_ts = body >= sp.timestamp_begin
    ts = body[is_ts]
    assert (np.diff(ts) >= 0).all()
    for i in range(1, body.size):
        penult_ts = is_ts[i - 2] if i >= 2 else True
        if is_ts[i - 1] and penult_ts:
            assert not is_ts[i], body
        elif is_ts[i - 1]:
            assert is_ts[i] or body[i] >= sp.eot, body


def test_greedy_sampled_obeys_grammar(setup):
    _, model, _, ckv_t = setup
    prompt = torch.tensor([SP_T.sot_sequence("en")] * 3)
    rules = trules.DecodeRules(specials=SP_T)
    res = tgreedy.greedy_decode_features(
        model, ckv_t, prompt, rules=rules, max_len=24, temperature=1.0,
        generator=torch.Generator().manual_seed(7))
    suppressed = rules._static_suppress_ids()
    toks = res.tokens.numpy()[:, prompt.shape[1]:]
    for row in toks:
        _check_grammar(row, SP_T, suppressed)
    again = tgreedy.greedy_decode_features(
        model, ckv_t, prompt, rules=rules, max_len=24, temperature=1.0,
        generator=torch.Generator().manual_seed(7))
    assert torch.equal(res.tokens, again.tokens)


# bf16 (regathered), int8 (regathered), int8 lanes: (quantize_cache, lane_cache)
CACHE_MODES = {"bf16": (False, False), "int8": (True, False), "lanes": (True, True)}


@pytest.mark.parametrize("mode", list(CACHE_MODES))
@pytest.mark.parametrize("beam_size", [3, 5])
def test_beam_t0_matches_jax(setup, beam_size, mode):
    params, model, ckv_j, ckv_t = setup
    quantize_cache, lane_cache = CACHE_MODES[mode]
    prompt = np.array([SP_J.sot_sequence("en")] * 3, np.int32)
    kw = dict(beam_size=beam_size, max_len=10, quantize_cache=quantize_cache,
              lane_cache=lane_cache)
    ref = jbeam.beam_decode_features(
        params, DIMS, ckv_j, jnp.asarray(prompt),
        rules=jrules.DecodeRules(specials=SP_J), **kw)
    got = tbeam.beam_decode_features(
        model, ckv_t, torch.from_numpy(prompt).long(),
        rules=trules.DecodeRules(specials=SP_T), **kw)
    assert got.all_tokens.shape == (3, beam_size, prompt.shape[1] + 10)
    for field in ("tokens", "lengths", "all_tokens"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(ref, field)))
    for field in ("sum_logprobs", "avg_logprobs", "no_speech_probs", "all_scores"):
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(ref, field)), atol=1e-3)


def test_beam1_equals_greedy(setup):
    """Beam 1 over the bf16-layout cache is greedy decode; over the lane
    cache it is beam 1 over the regathered int8 cache."""
    _, model, _, ckv_t = setup
    prompt = torch.tensor([SP_T.sot_sequence("en")] * 3)
    rules = trules.DecodeRules(specials=SP_T)
    g = tgreedy.greedy_decode_features(model, ckv_t, prompt, rules=rules, max_len=12)
    b = tbeam.beam_decode_features(model, ckv_t, prompt, rules=rules, beam_size=1,
                                   max_len=12)
    np.testing.assert_array_equal(b.lengths.numpy(), g.lengths.numpy())
    for i, n in enumerate(g.lengths.tolist()):
        n = prompt.shape[1] + n
        np.testing.assert_array_equal(b.tokens[i, :n].numpy(), g.tokens[i, :n].numpy())
    np.testing.assert_allclose(b.sum_logprobs.numpy(), g.sum_logprobs.numpy(), atol=1e-3)
    lanes, int8 = (tbeam.beam_decode_features(
        model, ckv_t, prompt, rules=rules, beam_size=1, max_len=12, quantize_cache=True,
        lane_cache=lane_cache) for lane_cache in (True, False))
    np.testing.assert_array_equal(lanes.all_tokens.numpy(), int8.all_tokens.numpy())
    np.testing.assert_allclose(lanes.all_scores.numpy(), int8.all_scores.numpy(),
                               atol=1e-5)


def test_beam_batch_independence(setup):
    """Each item's beam search is independent of its neighbours."""
    _, model, _, ckv_t = setup
    prompt = torch.tensor([SP_T.sot_sequence("en")] * 3)
    rules = trules.DecodeRules(specials=SP_T)
    kw = dict(rules=rules, beam_size=3, max_len=10, quantize_cache=True)
    both = tbeam.beam_decode_features(model, ckv_t, prompt, **kw)
    solo = tbeam.beam_decode_features(
        model, {key: x[:, 1:2] for key, x in ckv_t.items()}, prompt[1:2], **kw)
    np.testing.assert_array_equal(both.tokens[1].numpy(), solo.tokens[0].numpy())
    np.testing.assert_array_equal(both.all_tokens[1].numpy(), solo.all_tokens[0].numpy())


def test_top_k_matches_jax_on_ties():
    """Exact ties (dead beams at -1e30, equal log-probs) come out lower
    index first, as jax.lax.top_k orders them."""
    rng = np.random.default_rng(3)
    x = rng.integers(-3, 3, (6, 40)).astype(np.float32)
    x[0] = -1e30
    x[1, ::2] = -1e30
    x[2] = -1e30 + rng.standard_normal(40).astype(np.float32)   # still all -1e30 in f32
    for k in (1, 6, 10):
        ref_v, ref_i = jax.lax.top_k(jnp.asarray(x), k)
        got_v, got_i = tbeam._top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))


@pytest.mark.parametrize("rows,n,k", [(10, 51866, 10), (2, 50, 10), (2, 20, 5)])
def test_top_k_equals_a_stable_sort(rows, n, k):
    """_top_k (one torch.topk over distinct int64 keys, what a CUDA graph
    captures) gives what a stable descending sort's first k give, values
    and indices, at the beam step's widths (B·K rows of the vocabulary,
    then the 2K² merge and the 2K candidates of the finished set): with
    ties, −0.0 beside +0.0, −1e30 rows and both signs' extremes."""
    rng = np.random.default_rng(n)
    x = (rng.integers(-4, 4, (rows, n)) * 0.5).astype(np.float32)
    x[0] = -1e30
    x[1, ::3] = 0.0
    x[1, 1::3] = -0.0
    if rows > 2:
        x[2] = rng.standard_normal(n).astype(np.float32) - 20.0   # log-probs
        x[3, :7] = np.finfo(np.float32).max
        x[3, 7:11] = -np.finfo(np.float32).max
    x = torch.from_numpy(x)
    got_v, got_i = tbeam._top_k(x, k)
    ref_v, ref_i = torch.sort(x, dim=-1, descending=True, stable=True)
    assert torch.equal(got_i, ref_i[:, :k])
    assert torch.equal(got_v, ref_v[:, :k])


@pytest.fixture(scope="module")
def mel():
    """Log-mel features of two 30 s windows of noise and tone, (2, 80, 3000)."""
    rng = np.random.default_rng(2)
    t = np.arange(tmel.N_SAMPLES) / tmel.SAMPLE_RATE
    audio = np.stack([0.1 * rng.standard_normal(t.size),
                      0.3 * np.sin(2 * np.pi * 300 * t) + 0.01 * rng.standard_normal(t.size)])
    return np.array(jmel.log_mel_spectrogram(jnp.asarray(audio, jnp.float32)))


def test_greedy_decode_from_mel_matches_jax(setup, mel):
    """Encoder, dense cross-KV and greedy decode at T = 0 from log-mel
    input: tokens and lengths equal."""
    params, model = setup[:2]
    prompt = np.array([SP_J.sot_sequence("en")] * 2, np.int32)
    ref = jgreedy.greedy_decode(params, DIMS, jnp.asarray(mel), jnp.asarray(prompt),
                                rules=jrules.DecodeRules(specials=SP_J), max_len=12)
    got = tgreedy.greedy_decode(model, torch.from_numpy(mel), torch.from_numpy(prompt).long(),
                                rules=trules.DecodeRules(specials=SP_T), max_len=12)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(ref.lengths))
    np.testing.assert_allclose(got.sum_logprobs.numpy(), np.asarray(ref.sum_logprobs),
                               atol=1e-3)


def test_detect_language_from_mel_matches_jax(setup, mel):
    params, model = setup[:2]
    ref = np.asarray(jgreedy.detect_language(params, DIMS, jnp.asarray(mel), SP_J))
    got = tgreedy.detect_language(model, torch.from_numpy(mel), SP_T).numpy()
    assert got.shape == ref.shape == (2, SP_J.n_languages)
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


@pytest.mark.parametrize("n", [16000, 16000 * 3 + 77])
def test_stft_power_matches_jax(n):
    audio = np.random.default_rng(n).standard_normal((2, n)).astype(np.float32) * 0.1
    ref = np.asarray(jmel.stft_power(jnp.asarray(audio)))
    got = tmel.stft_power(torch.from_numpy(audio)).numpy()
    assert got.shape == ref.shape == (2, tmel.N_FREQS, n // tmel.HOP_LENGTH)
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) <= 1e-5
