"""Port transcriber and pipeline entry (turbo_whisper_workspace_tpu_torch/
pipeline) against the JAX package, end to end on the CPU: the same tiny
random weights, the committed golden clip and a synthesized long-form
clip, greedy or beam-5 (int8 lane self-KV cache) at T=0 only (random
weights would otherwise send windows into the sampled fallback retries,
whose draws differ by design)."""

import pathlib
import struct

import jax
import numpy as np
import pytest
import torch

from turbo_whisper_workspace_tpu.audio import io as jio
from turbo_whisper_workspace_tpu.config import PipelineConfig as JPipelineConfig
from turbo_whisper_workspace_tpu.config import TranscriptionConfig as JConfig
from turbo_whisper_workspace_tpu.decode import longform as jlongform
from turbo_whisper_workspace_tpu.models import whisper as jwm
from turbo_whisper_workspace_tpu.pipeline import audio_pipeline as jpipe
from turbo_whisper_workspace_tpu.pipeline import diarizer as jdiar
from turbo_whisper_workspace_tpu.pipeline import transcriber as jtr
from turbo_whisper_workspace_tpu_torch.audio import io as tio
from turbo_whisper_workspace_tpu_torch.config import PipelineConfig
from turbo_whisper_workspace_tpu_torch.config import TranscriptionConfig as TConfig
from turbo_whisper_workspace_tpu_torch.decode import longform as tlongform
from turbo_whisper_workspace_tpu_torch.models import convert
from turbo_whisper_workspace_tpu_torch.models import whisper as twm
from turbo_whisper_workspace_tpu_torch.pipeline import audio_pipeline as tpipe
from turbo_whisper_workspace_tpu_torch.pipeline import diarizer as tdiar
from turbo_whisper_workspace_tpu_torch.pipeline import transcriber as ttr
from tests.test_torch_pipeline import one_thread  # noqa: F401  (a fixture)

GOLDEN = pathlib.Path(__file__).resolve().parent.parent / "examples" / "golden"
DIMS = jwm.WhisperDims(80, 1500, 64, 2, 2, 51865, 448, 64, 2, 2)


@pytest.fixture(scope="module")
def pair():
    params = jwm.init_params(DIMS, jax.random.PRNGKey(0))
    model = convert.from_jax_params(jax.tree.map(np.asarray, params),
                                    twm.WhisperDims(**DIMS.__dict__))
    return params, model


def _long_clip(seconds=48.0, seed=0):
    """Tone bursts over noise with a silent stretch in the middle, so the
    VAD gate drops a window."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    audio = 0.3 * np.sin(2 * np.pi * 220 * t) * (np.sin(2 * np.pi * 0.5 * t) > 0)
    audio += 0.01 * rng.standard_normal(t.size)
    audio[int(20 * 16000):int(40 * 16000)] = 0.0
    return audio.astype(np.float32)


@pytest.mark.parametrize("beam_size", [1, 5])
@pytest.mark.parametrize("initial_prompt", [None, "hello there"])
def test_transcriber_matches_jax(pair, monkeypatch, initial_prompt, beam_size, one_thread):
    params, model = pair
    monkeypatch.setattr(jtr, "FALLBACK_TEMPERATURES", (0.0,))
    monkeypatch.setattr(ttr, "FALLBACK_TEMPERATURES", (0.0,))
    golden, _ = jio.read_audio_file(str(GOLDEN / "conversation.wav"))
    audios = [golden, _long_clip()]
    kw = dict(batch_size=4, max_decode_len=24, beam_size=beam_size)
    jt = jtr.load_transcriber(params, DIMS, JConfig(**kw))
    tt = ttr.load_transcriber(model, TConfig(**kw), device="cpu")
    ref = jt.transcribe(audios, initial_prompt=initial_prompt)
    got = tt.transcribe(audios, initial_prompt=initial_prompt)
    assert tt.last_n_windows == jt.last_n_windows
    for r, g in zip(ref, got):
        assert sorted(g) == sorted(r)
        assert g["language"] == r["language"]
        assert g["duration"] == r["duration"]
        assert [(s["text"], s["start"], s["end"]) for s in g["segments"]] == \
            [(s["text"], s["start"], s["end"]) for s in r["segments"]]
        assert g["chunks"] == r["chunks"]


def test_pipeline_transcribe_returns_result_schema(pair, monkeypatch):
    _, model = pair
    monkeypatch.setattr(ttr, "FALLBACK_TEMPERATURES", (0.0,))
    tt = ttr.load_transcriber(model, TConfig(max_decode_len=8, language="en"),
                              device="cpu")
    pipe = tpipe.AudioProcessingPipeline(PipelineConfig(), transcriber=tt, device="cpu")
    result = pipe.transcribe(str(GOLDEN / "conversation.wav"))
    assert sorted(result) == ["chunks", "duration", "language", "processing_times",
                              "segments", "text"]
    assert result["language"] == "en"
    assert result["duration"] == pytest.approx(15.0, abs=0.01)


@pytest.mark.parametrize("task, config_task, want", [
    ("translate", "transcribe", "translate"),
    ("transcribe", "translate", "transcribe"),
    (None, "translate", "translate"),
    (None, "transcribe", "transcribe"),
])
def test_task_reaches_sot_rows(pair, monkeypatch, tmp_path, task, config_task, want):
    """A per-call task reaches every SOT row the decoder is given, through
    process_batch; without one the transcription config's task does (the
    JAX pipeline drops the per-call task, a recorded deviation)."""
    _, model = pair
    monkeypatch.setattr(ttr, "FALLBACK_TEMPERATURES", (0.0,))
    rows = []
    decode = ttr.greedy_mod.greedy_decode_features

    def spy(model, cross_kv, prompt, **kw):
        rows.extend(prompt.tolist())
        return decode(model, cross_kv, prompt, **kw)

    monkeypatch.setattr(ttr.greedy_mod, "greedy_decode_features", spy)
    tt = ttr.load_transcriber(model, TConfig(batch_size=1, max_decode_len=4, language="en",
                                             task=config_task), device="cpu")
    sp = tt.tokenizer.specials
    path = str(tmp_path / "a.wav")
    tio.write_wav(path, _long_clip(4.0))
    pipe = tpipe.AudioProcessingPipeline(PipelineConfig(), transcriber=tt, device="cpu")
    pipe.process_batch([path], task=task, num_speakers=1, enrich=False)
    token = sp.translate if want == "translate" else sp.transcribe
    assert rows and all(r[:3] == [sp.sot, sp.language_tokens["en"], token] for r in rows)


def test_task_transcribe_matches_jax_pipeline(pair, monkeypatch):
    """task="transcribe" passed through the port's process_batch gives the
    JAX pipeline's results on the same weights and file."""
    params, model = pair
    monkeypatch.setattr(jtr, "FALLBACK_TEMPERATURES", (0.0,))
    monkeypatch.setattr(ttr, "FALLBACK_TEMPERATURES", (0.0,))
    kw = dict(batch_size=1, max_decode_len=12, language="en")
    path = str(GOLDEN / "conversation.wav")
    ref = jpipe.AudioProcessingPipeline(
        JPipelineConfig(), transcriber=jtr.load_transcriber(params, DIMS, JConfig(**kw))
    ).process_batch([path], task="transcribe", num_speakers=2, enrich=False)[0]
    got = tpipe.AudioProcessingPipeline(
        PipelineConfig(), transcriber=ttr.load_transcriber(model, TConfig(**kw), device="cpu"),
        device="cpu").process_batch([path], task="transcribe", num_speakers=2,
                                    enrich=False)[0]
    for key in ("text", "chunks", "language", "merged_segments", "diarization_segments"):
        assert got[key] == ref[key], key


def test_encode_windows_passes_int16_through(pair):
    """An int16 batch is PCM already: it is not rescaled (the JAX copy
    multiplies it by 32768 again)."""
    _, model = pair
    tt = ttr.load_transcriber(model, TConfig(), device="cpu")
    rng = np.random.default_rng(3)
    wave = (rng.standard_normal((1, 480000)) * 0.05).astype(np.float32)
    pcm = np.clip(wave * 32768.0, -32768, 32767).astype(np.int16)
    a = tt._encode_windows(wave)
    b = tt._encode_windows(pcm)
    for key in a:
        torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)


def test_gather_kv_takes_rows_of_axis_1():
    kv = {"k_q": torch.arange(2 * 3 * 4).reshape(2, 3, 4),
          "v_scale": torch.arange(6.0).reshape(2, 3)}
    out = ttr._gather_kv(kv, np.array([2, 0, 0]))
    torch.testing.assert_close(out["k_q"], kv["k_q"][:, [2, 0, 0]])
    torch.testing.assert_close(out["v_scale"], kv["v_scale"][:, [2, 0, 0]])


def test_entry_points_default_to_cuda(pair, monkeypatch):
    _, model = pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpipe.AudioProcessingPipeline()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttr.load_transcriber(model)


def test_longform_and_vad_match_jax():
    audio = _long_clip(70.0, seed=1)
    np.testing.assert_array_equal(tdiar.energy_vad(audio), jdiar.energy_vad(audio))
    plans_t = tlongform.plan_chunks(len(audio), 0)
    plans_j = jlongform.plan_chunks(len(audio), 0)
    assert [p.__dict__ for p in plans_t] == [p.__dict__ for p in plans_j]
    gated_t = tlongform.gate_plans_by_vad(plans_t, tdiar.energy_vad(audio))
    gated_j = jlongform.gate_plans_by_vad(plans_j, jdiar.energy_vad(audio))
    assert [p.start for p in gated_t] == [p.start for p in gated_j]
    segs = [[{"start": 1.0, "end": 3.0, "text": "a"}, {"start": 27.0, "end": 29.5,
                                                       "text": "b"}]] * len(plans_t)
    assert tlongform.merge_chunk_segments(segs, plans_t, 70.0) == \
        jlongform.merge_chunk_segments(segs, plans_j, 70.0)


def test_opus_buffer_counts_pre_skip():
    """The pre-skip is read from OpusHead (RFC 7845) and sized into the
    decode buffer."""
    head = b"OpusHead" + bytes([1, 2]) + struct.pack("<H", 12000) + bytes(7)
    page = b"OggS" + bytes(22) + bytes([1, len(head)]) + head
    assert tio._is_ogg_opus(page)
    assert tio._opus_pre_skip(page) == 12000
