"""Port master flow (turbo_whisper_workspace_tpu_torch/pipeline/audio_pipeline.py:
process_audio / process_batch, get_pipeline, load_diarizer,
get_device_memory_info; the CLI) against the JAX package on the CPU.

The golden clip goes through both pipelines on the same tiny random
Whisper (JAX init from seed 0, converted), f32, greedy at T = 0 only
(random weights would otherwise send windows into the sampled fallback
retries, whose draws differ by design): the result schema exactly, the
diarization and merged segments and the text equal. The enrichment
keys come from DummyLLM in both packages and must be equal.
"""

import contextlib
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from turbo_whisper_workspace_tpu import __main__ as jcli
from turbo_whisper_workspace_tpu.audio import io as jio
from turbo_whisper_workspace_tpu.config import PipelineConfig as JPipelineConfig
from turbo_whisper_workspace_tpu.config import TranscriptionConfig as JTConfig
from turbo_whisper_workspace_tpu.llm import llm_helper as jllm
from turbo_whisper_workspace_tpu.models import whisper as jwm
from turbo_whisper_workspace_tpu.pipeline import audio_pipeline as jpipe
from turbo_whisper_workspace_tpu.pipeline import transcriber as jtr
from turbo_whisper_workspace_tpu_torch import __main__ as tcli
from turbo_whisper_workspace_tpu_torch.config import DiarizationConfig, PipelineConfig
from turbo_whisper_workspace_tpu_torch.config import TranscriptionConfig as TConfig
from turbo_whisper_workspace_tpu_torch.llm import llm_helper as tllm
from turbo_whisper_workspace_tpu_torch.models import convert
from turbo_whisper_workspace_tpu_torch.models import whisper as twm
from turbo_whisper_workspace_tpu_torch.pipeline import audio_pipeline as tpipe
from turbo_whisper_workspace_tpu_torch.pipeline import diarizer as tdz
from turbo_whisper_workspace_tpu_torch.pipeline import transcriber as ttr
from tests.test_pipeline import FakeTranscriber as _JFakeTranscriber
from tests.test_pipeline import _write_two_speaker_wav

GOLDEN = pathlib.Path(__file__).resolve().parent.parent / "examples" / "golden"


class FakeTranscriber(_JFakeTranscriber):
    """The JAX tests' fake, also taking the port pipeline's per-call task."""

    def transcribe(self, audios, languages=None, initial_prompt=None, task=None):
        return super().transcribe(audios, languages, initial_prompt)


@contextlib.contextmanager
def torch_on_one_thread():
    """Torch's CPU ops on one thread for the block. Under xdist each
    worker's ops would start a pool of a thread a core; on these small
    models an op then waits at its pool's barrier for threads that the
    other workers hold (~40 ms an op, six workers on eight cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture
def one_thread():
    with torch_on_one_thread():
        yield


@pytest.fixture(autouse=True)
def dummy_llms():
    jllm.set_llm(jllm.DummyLLM())
    tllm.set_llm(tllm.DummyLLM())
    yield
    jllm.set_llm(None)
    tllm.set_llm(None)


@pytest.fixture(scope="module")
def golden_pair():
    """process_audio on the golden clip in both packages, tiny Whisper
    from seed 0 as tests/test_golden_e2e.py builds it."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jtr, "FALLBACK_TEMPERATURES", (0.0,))
    mp.setattr(ttr, "FALLBACK_TEMPERATURES", (0.0,))
    try:
        with torch_on_one_thread():
            dims = jwm.WHISPER_CONFIGS["tiny"]
            params = jwm.init_params(dims, jax.random.PRNGKey(0))
            kw = dict(batch_size=2, max_decode_len=24, language="en")
            jt = jtr.load_transcriber(params, dims, JTConfig(**kw))
            model = convert.from_jax_params(jax.tree.map(np.asarray, params),
                                            twm.WHISPER_CONFIGS["tiny"])
            tt = ttr.load_transcriber(model, TConfig(**kw), device="cpu")
            path = str(GOLDEN / "conversation.wav")
            ref = jpipe.AudioProcessingPipeline(JPipelineConfig(), transcriber=jt).process_audio(
                path, num_speakers=2, enrich=False)
            got = tpipe.AudioProcessingPipeline(PipelineConfig(), transcriber=tt,
                                                device="cpu").process_audio(
                path, num_speakers=2, enrich=False)
    finally:
        mp.undo()
    return ref, got, json.loads((GOLDEN / "expected.json").read_text())


def test_golden_schema(golden_pair):
    ref, got, expected = golden_pair
    assert sorted(got) == expected["result_keys"] == sorted(ref)
    assert sorted(got["processing_times"]) == expected["processing_time_keys"]
    if got["segments"]:
        assert sorted(got["segments"][0]) == expected["segment_keys"]
    assert got["duration"] == ref["duration"]
    assert abs(got["duration"] - expected["duration_s"]) < 0.01


def test_golden_diarization_matches_jax_and_expected(golden_pair):
    ref, got, expected = golden_pair
    assert got["diarization_segments"] == ref["diarization_segments"]
    want = expected["diarization_segments"]
    assert len(got["diarization_segments"]) == len(want)
    for g, w in zip(got["diarization_segments"], want):
        assert g["speaker"] == w["speaker"]
        assert abs(g["start"] - w["start"]) <= 0.5 and abs(g["end"] - w["end"]) <= 0.5
    assert len({s["speaker"] for s in got["diarization_segments"]}) == \
        expected["num_speakers_detected"]


def test_golden_text_and_merge_match_jax(golden_pair):
    ref, got, _ = golden_pair
    assert got["text"] == ref["text"]
    assert got["language"] == ref["language"]
    assert got["chunks"] == ref["chunks"]
    assert [(s["text"], s["start"], s["end"]) for s in got["segments"]] == \
        [(s["text"], s["start"], s["end"]) for s in ref["segments"]]
    assert got["merged_segments"] == ref["merged_segments"]


_SEGS = [
    {"text": " Hi there, I'm Chris.", "start": 0.2, "end": 2.8},
    {"text": " Hey Chris, my name is Alex.", "start": 4.2, "end": 6.8},
    {"text": " Good to see you Alex.", "start": 8.2, "end": 10.8},
    {"text": " Likewise!", "start": 12.2, "end": 14.5},
]


def test_enrichment_keys_match_jax(tmp_path):
    path, audio = _write_two_speaker_wav(tmp_path)
    ref = jpipe.AudioProcessingPipeline(
        JPipelineConfig(), transcriber=FakeTranscriber([_SEGS])).process_audio(
        path, num_speakers=2)
    got = tpipe.AudioProcessingPipeline(
        PipelineConfig(), transcriber=FakeTranscriber([_SEGS]), device="cpu").process_audio(
        path, num_speakers=2)
    assert sorted(got) == sorted(ref)
    assert sorted(got["processing_times"]) == sorted(ref["processing_times"])
    assert "llm" in got["processing_times"]
    assert set(got["speaker_names"].values()) == {"Chris", "Alex"}
    for key in ("speaker_names", "summary", "topics", "merged_segments",
                "diarization_segments", "text", "duration"):
        assert got[key] == ref[key], key
    assert abs(got["duration"] - len(audio) / 16000) < 0.01


@pytest.mark.parametrize("num_speakers", [0, 2])
def test_process_batch_matches_jax(tmp_path, num_speakers):
    p1, _ = _write_two_speaker_wav(tmp_path, "a.wav")
    p2 = str(tmp_path / "b.wav")
    jio.write_wav(p2, np.concatenate([np.zeros(16000, np.float32),
                                      jio.read_audio_file(p1)[0][: 9 * 16000]]), 16000)
    segs = [{"text": " hello world.", "start": 0.5, "end": 2.0}]
    ref = jpipe.AudioProcessingPipeline(
        JPipelineConfig(), transcriber=FakeTranscriber([segs, segs])).process_batch(
        [p1, p2], num_speakers=num_speakers, enrich=False)
    got = tpipe.AudioProcessingPipeline(
        PipelineConfig(), transcriber=FakeTranscriber([segs, segs]),
        device="cpu").process_batch([p1, p2], num_speakers=num_speakers, enrich=False)
    assert [g["audio_path"] for g in got] == [p1, p2]
    for r, g in zip(ref, got):
        assert "speaker_names" not in g
        assert sorted(g) == sorted(r)
        for key in ("diarization_segments", "merged_segments", "duration"):
            assert g[key] == r[key], key


def test_diarize_stage_matches_jax(tmp_path):
    path, _ = _write_two_speaker_wav(tmp_path)
    ref = jpipe.AudioProcessingPipeline(JPipelineConfig()).diarize(path, num_speakers=0)
    got = tpipe.AudioProcessingPipeline(PipelineConfig(), device="cpu").diarize(
        path, num_speakers=0)
    assert got == ref and got


def test_get_pipeline_cache(monkeypatch):
    monkeypatch.setattr(tpipe, "_PIPELINE_CACHE", {})
    cfg = PipelineConfig(transcription=TConfig(model="tiny"))
    a = tpipe.get_pipeline(cfg, device="cpu")
    assert tpipe.get_pipeline(cfg, device="cpu") is a
    assert a.device == torch.device("cpu")
    beam = tpipe.get_pipeline(PipelineConfig(transcription=TConfig(model="tiny", beam_size=5)),
                              device="cpu")
    assert beam is not a
    assert set(tpipe._PIPELINE_CACHE) == {("tiny", 1, "cpu"), ("tiny", 5, "cpu")}
    # a CUDA caller never gets the CPU pipeline: without a card it raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpipe.get_pipeline(cfg)


def test_device_memory_info_cpu():
    info = tpipe.AudioProcessingPipeline.get_device_memory_info(device="cpu")
    assert sorted(info) == sorted(jpipe.AudioProcessingPipeline.get_device_memory_info())
    assert info["platform"] == "cpu" and info["device"] == "cpu"


def test_load_diarizer_rules(tmp_path):
    cfg = PipelineConfig(models_dir=str(tmp_path))
    injected = tdz.SpeakerDiarizer(DiarizationConfig(), device="cpu")
    pipe = tpipe.AudioProcessingPipeline(cfg, diarizer=injected, device="cpu")
    assert pipe.load_diarizer() is injected
    # explicit names that match what the injection was built for
    assert pipe.load_diarizer(segmentation_model=cfg.diarization.segmentation_model) is injected
    # other names: built from the registry (nothing on disk → fallback tier), cached
    other = pipe.load_diarizer(segmentation_model="revai-reverb-diarization-v1")
    assert other is not injected and other.seg_params is None
    assert other.segmentation_model == "revai-reverb-diarization-v1"
    assert other.device == torch.device("cpu")
    assert pipe.load_diarizer(segmentation_model="revai-reverb-diarization-v1") is other


def test_load_diarizer_reads_checkpoints_from_models_dir(tmp_path):
    """A port-written checkpoint under models_dir gives the neural tier."""
    import dataclasses

    from turbo_whisper_workspace_tpu_torch.models import embedding as temb
    from turbo_whisper_workspace_tpu_torch.models import segmentation as tseg

    gen = torch.Generator().manual_seed(0)
    seg_dims = tseg.SegmentationDims(d_model=32, n_head=2, n_layer=1)
    emb_dims = temb.EmbeddingDims(channels=32, n_blocks=1, embed_dim=16)
    convert.save_params(str(tmp_path / "seg-pyannote-segmentation-3.0.npz"),
                        tseg.init_params(seg_dims, gen), meta=dataclasses.asdict(seg_dims))
    convert.save_params(str(tmp_path / "emb-eres2net-sv.npz"),
                        temb.init_params(emb_dims, gen), meta=dataclasses.asdict(emb_dims))
    pipe = tpipe.AudioProcessingPipeline(PipelineConfig(models_dir=str(tmp_path)),
                                         device="cpu")
    d = pipe.load_diarizer()
    assert d.seg_dims == seg_dims and d.emb_dims == emb_dims
    assert d.seg_params.conv1.weight.dtype == torch.bfloat16
    assert d.emb_params.stem.weight.dtype == torch.bfloat16
    path, audio = _write_two_speaker_wav(tmp_path)
    for seg in pipe.diarize(path, num_speakers=2):
        assert 0.0 <= seg["start"] < seg["end"] <= len(audio) / 16000


def test_cli_models_list_matches_jax(capsys):
    jcli.main(["models", "list"])
    ref = json.loads(capsys.readouterr().out)
    tcli.main(["models", "list"])
    assert json.loads(capsys.readouterr().out) == ref


def test_cli_models_check(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    tcli.main(["models", "check"])
    out = json.loads(capsys.readouterr().out)
    assert sorted(out) == ["embedding", "llm", "segmentation", "whisper"]
    assert not any(v["present"] for v in out.values())


def test_cli_transcribe_json(tmp_path, capsys, monkeypatch, one_thread):
    """`transcribe --model tiny --device cpu --json` runs the master flow
    on a random-init tiny Whisper (no checkpoint under models/). The
    config the CLI builds goes to `get_pipeline` with max_decode_len 24,
    as the golden clip's pipelines decode: random weights never stop
    early, and 224 steps a call only lengthen the run."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tpipe, "_PIPELINE_CACHE", {})
    monkeypatch.setattr(ttr, "FALLBACK_TEMPERATURES", (0.0,))
    get_pipeline, configs = tpipe.get_pipeline, []

    def short_decodes(config, device):
        config.transcription.max_decode_len = 24
        configs.append(config)
        return get_pipeline(config, device=device)

    monkeypatch.setattr(tpipe, "get_pipeline", short_decodes)
    path, audio = _write_two_speaker_wav(tmp_path)
    tcli.main(["transcribe", "-i", path, "--model", "tiny", "--device", "cpu",
               "--language", "en", "--json"])
    res = json.loads(capsys.readouterr().out)
    assert set(res) >= {"audio_path", "chunks", "diarization_segments", "duration",
                        "language", "merged_segments", "processing_times", "segments",
                        "text"}
    assert res["language"] == "en"
    assert abs(res["duration"] - len(audio) / 16000) < 0.01
    # the weight-free diarizer, as the JAX package's on the same file
    ref = jpipe.AudioProcessingPipeline(JPipelineConfig()).diarize(path, num_speakers=2)
    assert res["diarization_segments"] == ref
    assert {"transcription", "diarization", "merge", "total"} <= set(res["processing_times"])
    # the conversation form of the same flow (cached pipeline, no --json)
    tcli.main(["transcribe", "-i", path, "--model", "tiny", "--device", "cpu",
               "--language", "en", "--no-enrich"])
    out = capsys.readouterr().out
    assert "speaker_names" not in res
    assert out.strip() == tdz.SpeakerDiarizer.format_as_conversation(
        res["merged_segments"]).strip()
    assert [(c.transcription.model, c.transcription.language) for c in configs] == \
        [("tiny", "en")] * 2
