"""Port LLM enrichment (turbo_whisper_workspace_tpu_torch/llm and the
pipeline's stage methods) against the JAX package.

Generation at T = 0 must give the JAX package's tokens and lengths on
the same test-tiny weights (dense, int8 and int4, the quantized ones with
the JAX `matmul_any` on its TPU route, as in tests/test_torch_llama.py;
int8 up to a near-tie);
at T > 0 one sampling step fed the same numpy Gumbel noise must pick the
same tokens. The helpers of tests/test_llm_helper.py run on both packages
with the same outputs.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_llama import DIMS, TDIMS, jax_params, jax_tpu_route  # noqa: F401
from turbo_whisper_workspace_tpu.config import LLMConfig as JLLMConfig
from turbo_whisper_workspace_tpu.config import PipelineConfig as JPipelineConfig
from turbo_whisper_workspace_tpu.llm import generate as jgen
from turbo_whisper_workspace_tpu.llm import llm_helper as jlh
from turbo_whisper_workspace_tpu.models import llama as jlm
from turbo_whisper_workspace_tpu.pipeline import audio_pipeline as jpipe
from turbo_whisper_workspace_tpu_torch.config import LLMConfig as TLLMConfig
from turbo_whisper_workspace_tpu_torch.config import PipelineConfig as TPipelineConfig
from turbo_whisper_workspace_tpu_torch.llm import generate as tgen
from turbo_whisper_workspace_tpu_torch.llm import llm_helper as tlh
from turbo_whisper_workspace_tpu_torch.models import convert
from turbo_whisper_workspace_tpu_torch.models import llama as tlm
from turbo_whisper_workspace_tpu_torch.pipeline import audio_pipeline as tpipe


@pytest.fixture(autouse=True)
def reset_llm():
    for lh in (jlh, tlh):
        lh.set_llm(None)
    yield
    for lh in (jlh, tlh):
        lh.set_llm(None)


# ---------------------------------------------------------------------------
# Generation


def assert_same_tokens(got, ref, params, kind: str) -> None:
    """Dense and int4: equal tokens and lengths. int8: its logits are
    1e-2 apart at most (tests/test_torch_llama.py: bf16 roundings that
    fall differently), so the two packages may part at a near-tie; tokens
    must agree up to the first place they part, and there the JAX logits'
    top two must lie within 5% of their spread of each other."""
    got_t, ref_t = got.tokens.numpy(), np.asarray(ref.tokens)
    if kind != "int8" or (got_t == ref_t).all():
        np.testing.assert_array_equal(got_t, ref_t)
        np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(ref.lengths))
        return
    col = int(np.argmax((got_t != ref_t).any(0)))
    for row in np.flatnonzero(got_t[:, col] != ref_t[:, col]):
        logits, _ = jlm.forward(params, DIMS, jnp.asarray(ref_t[row:row + 1, :col]))
        last = np.asarray(logits)[0, -1]
        top = np.sort(last)[-2:]
        assert top[1] - top[0] <= 0.05 * last.std(), (row, col, top, last.std())


@pytest.mark.parametrize("kind", ["dense", "int8", "int4"])
def test_generate_tokens_greedy_matches_jax(kind, jax_tpu_route):
    params = jax_params(kind)
    tparams = convert.llama_from_jax_params(params, TDIMS)
    prompt = np.random.default_rng(5).integers(1, DIMS.n_vocab, (2, 9))
    ref = jgen.generate_tokens(params, DIMS, jnp.asarray(prompt, jnp.int32), max_len=8)
    got = tgen.generate_tokens(tparams, TDIMS, torch.from_numpy(prompt), max_len=8)
    assert_same_tokens(got, ref, params, kind)
    # an EOS case: row 0's third sampled token ends it; the row is then padded
    eos = int(got.tokens[0, 11])
    ref = jgen.generate_tokens(params, DIMS, jnp.asarray(prompt, jnp.int32), max_len=8,
                               eos_tokens=(eos, 1))
    got = tgen.generate_tokens(tparams, TDIMS, torch.from_numpy(prompt), max_len=8,
                               eos_tokens=(eos, 1))
    assert_same_tokens(got, ref, params, kind)
    assert int(got.lengths[0]) <= 2 and (got.tokens[0, 9 + int(got.lengths[0]) + 1:] == eos).all()


def test_generate_stops_when_every_row_is_done(monkeypatch):
    """Once every row has sampled EOS the loop stops: no more forwards."""
    tparams = convert.llama_from_jax_params(jax_params("dense"), TDIMS)
    prompt = torch.from_numpy(np.random.default_rng(6).integers(1, DIMS.n_vocab, (1, 5)))
    first = tgen.generate_tokens(tparams, TDIMS, prompt, max_len=4)
    calls = []
    forward = tlm.forward
    monkeypatch.setattr(tlm, "forward", lambda *a, **k: calls.append(1) or forward(*a, **k))
    timings = {}
    res = tgen.generate_tokens(tparams, TDIMS, prompt, max_len=6,
                               eos_tokens=(int(first.tokens[0, 6]),), timings=timings)
    assert int(res.lengths[0]) == 1 and len(calls) == 2      # prefill and one step
    assert timings["decode_forwards"] == 1 and timings["prefill_s"] > 0
    with pytest.raises(ValueError):
        tgen.generate_tokens(tparams, TDIMS, prompt, max_len=DIMS.max_ctx)


@pytest.mark.parametrize("temperature", [0.3, 1.0])
def test_sampling_step_matches_jax_on_the_same_noise(temperature):
    params = jax_params("dense")
    tparams = convert.llama_from_jax_params(params, TDIMS)
    tokens = np.random.default_rng(7).integers(0, DIMS.n_vocab, (4, 6))
    ref_logits, _ = jlm.forward(params, DIMS, jnp.asarray(tokens))
    got_logits, _ = tlm.forward(tparams, TDIMS, torch.from_numpy(tokens))
    gumbel = np.random.default_rng(8).gumbel(size=(4, DIMS.n_vocab)).astype(np.float32)
    # generate.py's step: argmax(last_logits + T·gumbel)
    ref = jnp.argmax(ref_logits[:, -1] + temperature * jnp.asarray(gumbel), axis=-1)
    got = tgen.sample(got_logits[:, -1], temperature, torch.from_numpy(gumbel))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # the noise matters, and T = 0 is the exact argmax
    assert not torch.equal(got, got_logits[:, -1].argmax(-1))
    assert torch.equal(tgen.sample(got_logits[:, -1], 0.0, None), got_logits[:, -1].argmax(-1))


def test_sampled_generation_is_seeded():
    tparams = convert.llama_from_jax_params(jax_params("dense"), TDIMS)
    prompt = torch.from_numpy(np.random.default_rng(9).integers(1, DIMS.n_vocab, (2, 4)))
    a = tgen.generate_tokens(tparams, TDIMS, prompt, max_len=6, temperature=1.0)
    b = tgen.generate_tokens(tparams, TDIMS, prompt, max_len=6, temperature=1.0)
    c = tgen.generate_tokens(tparams, TDIMS, prompt, max_len=6, temperature=1.0,
                             generator=torch.Generator().manual_seed(1))
    assert torch.equal(a.tokens, b.tokens) and not torch.equal(a.tokens, c.tokens)


def test_torch_llama_generate_matches_tpu_llama():
    params = jax_params("dense")
    ref = jlh.TPULlama(params, DIMS)
    got = tlh.TorchLlama(convert.llama_from_jax_params(params, TDIMS), TDIMS, device="cpu")
    prompt = "Speaker 0: hello there\nSpeaker 1: hi!\nJSON:"
    for stop in ((), ("\n",)):
        assert got.generate(prompt, max_tokens=12, temperature=0.0, stop=stop) == \
            ref.generate(prompt, max_tokens=12, temperature=0.0, stop=stop)
    stats = got.last_generation
    assert stats["prompt_tokens"] == len(prompt.encode()) and stats["new_tokens"] <= 12


def test_torch_llama_needs_the_device_it_names():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError):
        tlh.TorchLlama({}, TDIMS)                      # device="cuda" by default


# ---------------------------------------------------------------------------
# get_llm on a transformers checkpoint


def test_get_llm_loads_checkpoint_like_jax(tmp_path, monkeypatch):
    transformers = pytest.importorskip("transformers")
    cfg = transformers.LlamaConfig(
        vocab_size=DIMS.n_vocab, hidden_size=DIMS.d_model,
        num_hidden_layers=DIMS.n_layer, num_attention_heads=DIMS.n_head,
        num_key_value_heads=DIMS.n_kv_head, intermediate_size=DIMS.d_ff,
        rope_theta=DIMS.rope_theta, rms_norm_eps=DIMS.norm_eps,
        max_position_embeddings=DIMS.max_ctx, tie_word_embeddings=False)
    torch.manual_seed(4)
    path = tmp_path / "ckpt"
    transformers.LlamaForCausalLM(cfg).save_pretrained(path)
    assert (path / "model.safetensors").exists()
    monkeypatch.setenv("LLM_MODEL_PATH", str(path))
    monkeypatch.chdir(tmp_path)
    config = json.loads((path / "config.json").read_text())
    ref = jlh.get_llm(JLLMConfig(model="none"))
    got = tlh.get_llm(TLLMConfig(model="none"), device="cpu")
    assert isinstance(got, tlh.TorchLlama) and got.device.type == "cpu"
    assert got.dims.n_vocab == config["vocab_size"] and got.dims.n_layer == DIMS.n_layer
    # the Q4 point: int4 body and int8 head, bit-equal to the JAX loader's;
    # q|k|v and gate|up fused, the JAX loader's projections side by side
    assert "w_q4" in got.params["blocks"][0]["qkv"] and "w_q" in got.params["lm_head"]
    for li, block in enumerate(got.params["blocks"]):
        for name, proj in block.items():
            for key, val in proj.items():
                want = [np.asarray(ref.params["blocks"][n][key][li], np.float32)
                        for n in tlm.SIBLINGS.get(name, (name,))]
                np.testing.assert_array_equal(val.float().numpy(), np.concatenate(want, -1))
    tokens = np.random.default_rng(10).integers(0, DIMS.n_vocab, (1, 12))
    ref_logits, _ = jlm.forward(ref.params, ref.dims, jnp.asarray(tokens))
    got_logits, _ = tlm.forward(got.params, got.dims, torch.from_numpy(tokens))
    # bf16 weights: one bf16 rounding per op apart (the CPU routes differ too)
    rel = np.linalg.norm(got_logits.numpy() - np.asarray(ref_logits)) / np.linalg.norm(
        np.asarray(ref_logits))
    assert rel <= 5e-2, rel
    assert tlh.get_llm() is got                     # cached


def test_get_llm_without_checkpoint_needs_no_device(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("LLM_MODEL_PATH", raising=False)
    assert tlh.get_llm().is_dummy                   # device="cuda" is never touched


# ---------------------------------------------------------------------------
# tests/test_llm_helper.py on both packages

SEGMENTS = [
    {"speaker": "Speaker 0", "text": "Hey Alex, how was the weekend?"},
    {"speaker": "Speaker 1", "text": "Pretty good! I'm Alex by the way, "
                                     "we met at the studio."},
    {"speaker": "Speaker 0", "text": "Right! My name is Chris. We talked "
                                     "about the new microphone setup."},
    {"speaker": "Speaker 1", "text": "Yes, the audio quality on the "
                                     "recording was great. The microphone "
                                     "really helped."},
]

both = pytest.mark.parametrize("lh", [jlh, tlh], ids=["jax", "torch"])


class FakeLLM:
    is_dummy = False

    def __init__(self, reply):
        self.reply = reply
        self.prompts = []

    def generate(self, prompt, **kw):
        self.prompts.append(prompt)
        return self.reply


@both
def test_fallback_names(lh):
    names = lh.identify_speaker_names_fallback(SEGMENTS)
    assert names == {"Speaker 0": "Chris", "Speaker 1": "Alex"}
    segs = [{"speaker": "Speaker 0", "text": "I'm Sam."},
            {"speaker": "Speaker 1", "text": "I'm Sam too!"}]
    names = lh.identify_speaker_names_fallback(segs)
    assert len(set(names.values())) == len(names)
    assert lh.identify_speaker_names_fallback(
        [{"speaker": "Speaker 0", "text": "My name is Zxqwv."}]) == {}


@both
def test_json_repair_ladder(lh):
    assert lh._extract_json('junk {"a": "b"} junk') == {"a": "b"}
    assert lh._extract_json("{'a': 'b'}") == {"a": "b"}
    assert lh._extract_json('{"a": "b",}') == {"a": "b"}
    assert lh._extract_json("no json here") is None
    assert lh._extract_json('x {"a": {"b": 1}, "c": 2} y') == {"a": {"b": 1}, "c": 2}
    assert lh._extract_json('{"a": "curly } brace", "b": "{"}') == {
        "a": "curly } brace", "b": "{"}
    assert lh._extract_json('{"a": "say \\"hi\\""}') == {"a": 'say "hi"'}
    assert lh._extract_json("{ unterminated") is None


@both
def test_llm_naming_with_fake_llm(lh):
    fake = FakeLLM('Here you go: {"Speaker 0": "Chris", "Speaker 1": "Alex"}')
    assert lh.identify_speaker_names_llm(SEGMENTS, llm=fake) == {
        "Speaker 0": "Chris", "Speaker 1": "Alex"}
    assert "Speaker 0" in fake.prompts[0]
    assert lh.identify_speaker_names_llm(
        SEGMENTS, llm=FakeLLM('{"Speaker 0": "Zxqwv", "Speaker 9": "Alex"}')) == {}
    assert lh.identify_speaker_names(SEGMENTS, llm=lh.DummyLLM()).get("Speaker 0") == "Chris"


@both
def test_summary_and_topics(lh):
    out = lh.summarize_conversation(SEGMENTS, llm=lh.DummyLLM())
    assert "Speaker" in out and len(out) > 20
    fake = FakeLLM("They discussed weekend plans and studio gear.")
    assert lh.summarize_conversation(SEGMENTS, llm=fake) == fake.reply
    fake = FakeLLM(" Microphones\n2. Weekend plans\n3. Audio quality")
    assert lh.extract_topics(SEGMENTS, llm=fake) == [
        "Microphones", "Weekend plans", "Audio quality"]
    assert "microphone" in lh.extract_topics(SEGMENTS, llm=lh.DummyLLM())


def test_helpers_give_the_same_prompts_and_outputs():
    prompts = {}
    for lh in (jlh, tlh):
        fake = FakeLLM('{"Speaker 0": "Chris"} 1. x')
        out = (lh.identify_speaker_names(SEGMENTS, llm=fake),
               lh.summarize_conversation(SEGMENTS, llm=fake),
               lh.extract_topics(SEGMENTS, llm=fake),
               lh.summarize_conversation(SEGMENTS, llm=lh.DummyLLM()),
               lh.extract_topics(SEGMENTS, llm=lh.DummyLLM()))
        prompts[lh.__name__] = (fake.prompts, out)
    assert prompts[jlh.__name__] == prompts[tlh.__name__]


@both
def test_dummy_llm_from_get_llm(lh, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    llm = lh.get_llm()
    assert llm.is_dummy and llm.generate("anything") == ""


# ---------------------------------------------------------------------------
# The pipeline's stage methods


def _stage_outputs(pipe):
    return (pipe.identify_speaker_names(SEGMENTS), pipe.generate_summary(SEGMENTS),
            pipe.extract_topics(SEGMENTS))


def test_pipeline_stages_with_an_injected_llm():
    results = []
    for lh, pipe in ((jlh, jpipe.AudioProcessingPipeline(JPipelineConfig())),
                     (tlh, tpipe.AudioProcessingPipeline(TPipelineConfig(), device="cpu"))):
        fake = FakeLLM('{"Speaker 0": "Chris", "Speaker 1": "Alex"}\n2. Audio')
        lh.set_llm(fake)
        results.append((_stage_outputs(pipe), fake.prompts))
        lh.set_llm(lh.DummyLLM())
        results.append(_stage_outputs(pipe))
    assert results[0] == results[2] and results[1] == results[3]
    assert results[0][0][0] == {"Speaker 0": "Chris", "Speaker 1": "Alex"}


def test_pipeline_stages_run_the_model():
    """TorchLlama through the stage methods at T = 0 gives the JAX
    pipeline's outputs with TPULlama on the same weights."""
    params = jax_params("dense")
    llm_cfg = dict(max_tokens_names=6, max_tokens_summary=6, max_tokens_topics=6,
                   temperature_names=0.0, temperature_summary=0.0)
    jlh.set_llm(jlh.TPULlama(params, DIMS))
    ref = _stage_outputs(jpipe.AudioProcessingPipeline(
        JPipelineConfig(llm=JLLMConfig(**llm_cfg))))
    llm = tlh.TorchLlama(convert.llama_from_jax_params(params, TDIMS), TDIMS, device="cpu")
    tlh.set_llm(llm)
    got = _stage_outputs(tpipe.AudioProcessingPipeline(
        TPipelineConfig(llm=TLLMConfig(**llm_cfg)), device="cpu"))
    assert got == ref
    assert llm.last_generation["new_tokens"] <= 6
