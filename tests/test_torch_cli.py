"""Port CLI (turbo_whisper_workspace_tpu_torch/__main__.py): the cases of
tests/test_cli.py (info, diagnose, preprocess, security --bar --test)
through the port's `main`, against the JAX CLI's output on the same
file, check-gpu exiting non-zero without a GPU, the serving and batch
commands in the help, and `batch --device cpu` on a tiny model."""

import json

import numpy as np
import pytest
import torch

from turbo_whisper_workspace_tpu import __main__ as jcli
from turbo_whisper_workspace_tpu.audio import io as jio
from turbo_whisper_workspace_tpu.llm import llm_helper as jllm
from turbo_whisper_workspace_tpu_torch import __main__ as tcli
from turbo_whisper_workspace_tpu_torch.audio import io as tio
from turbo_whisper_workspace_tpu_torch.llm import llm_helper as tllm


@pytest.fixture
def wav(tmp_path):
    rng = np.random.default_rng(0)
    t = np.arange(3 * 16000) / 16000
    x = 0.2 * np.sin(2 * np.pi * 220 * t) * (np.sin(2 * np.pi * 0.7 * t) > 0)
    x = (x + 0.02 * rng.standard_normal(t.size)).astype(np.float32)
    p = str(tmp_path / "x.wav")
    tio.write_wav(p, x)
    return p


def _both(capsys, args_t, args_j):
    tcli.main(args_t)
    got = capsys.readouterr().out
    jcli.main(args_j)
    return got, capsys.readouterr().out


def test_info_matches_jax(wav, capsys):
    got, ref = _both(capsys, ["info", "-i", wav], ["info", "-i", wav])
    assert json.loads(got) == json.loads(ref)
    assert json.loads(got)["duration"] == pytest.approx(3.0)


def test_diagnose_matches_jax(wav, capsys):
    got, ref = _both(capsys, ["diagnose", "-i", wav], ["diagnose", "-i", wav])
    assert got == ref and "AUDIO DIAGNOSTIC REPORT" in got


@pytest.mark.parametrize("flags", [
    ["--normalize"],
    ["--dynamic", "--window", "1.0"],
    ["--denoise", "0.5", "--normalize", "--effects"],
], ids=["normalize", "dynamic", "denoise_effects"])
def test_preprocess_matches_jax(wav, tmp_path, capsys, flags):
    out_t, out_j = str(tmp_path / "t.wav"), str(tmp_path / "j.wav")
    got, ref = _both(capsys, ["preprocess", "-i", wav, "-o", out_t, *flags, "--device", "cpu"],
                     ["preprocess", "-i", wav, "-o", out_j, *flags])
    assert got == f"wrote {out_t}\n" and ref == f"wrote {out_j}\n"
    a_t, _ = tio.read_audio_file(out_t, normalize=False)
    a_j, _ = jio.read_audio_file(out_j, normalize=False)
    # int16 files: the float results may round to neighbouring codes
    np.testing.assert_allclose(a_t, a_j, atol=1.5 / 32768)
    if flags == ["--normalize"]:
        assert abs(20 * np.log10(np.sqrt((a_t**2).mean())) + 16.0) < 1.5


def test_security_mock_matches_jax(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    tllm.set_llm(tllm.DummyLLM())
    jllm.set_llm(jllm.DummyLLM())
    try:
        got, ref = _both(
            capsys,
            ["security", "-i", "ignored", "--bar", "--test", "-o", str(tmp_path / "t"),
             "--device", "cpu"],
            ["security", "-i", "ignored", "--bar", "--test", "-o", str(tmp_path / "j")])
    finally:
        tllm.set_llm(None)
        jllm.set_llm(None)
    assert "underage" in got
    # the report's lines after the timestamp are equal
    assert got.splitlines()[4:] == ref.splitlines()[4:]


def test_check_gpu_without_a_gpu_exits_nonzero(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        tcli.main(["check-gpu"])
    assert e.value.code not in (0, None)
    assert "no CUDA device" in str(e.value.code)


def test_unknown_command_exits():
    with pytest.raises(SystemExit):
        tcli.main(["frobnicate"])


@pytest.mark.parametrize("argv,want", [
    (["--help"], ["api", "ui", "batch"]),
    (["api", "--help"], ["--host", "--port", "--device"]),
    (["ui", "--help"], ["--host", "--port", "--device"]),
    (["batch", "--help"], ["--input", "--files-per-call", "--no-enrich", "--device"]),
], ids=["main", "api", "ui", "batch"])
def test_help_lists_serving_and_batch(capsys, argv, want):
    with pytest.raises(SystemExit) as e:
        tcli.main(argv)
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert all(w in out for w in want), out


def test_batch_on_cpu(tmp_path, capsys, monkeypatch):
    """`batch --model tiny --device cpu` through get_pipeline: a tiny
    random Whisper (d 64, 8 decode steps) stands in the pipeline cache
    under tiny's key, so the command runs its real driver and pipeline."""
    from turbo_whisper_workspace_tpu_torch.config import PipelineConfig, TranscriptionConfig
    from turbo_whisper_workspace_tpu_torch.models import whisper as twm
    from turbo_whisper_workspace_tpu_torch.pipeline import audio_pipeline as tpipe
    from turbo_whisper_workspace_tpu_torch.pipeline import transcriber as ttr

    monkeypatch.setattr(ttr, "FALLBACK_TEMPERATURES", (0.0,))
    dims = twm.WhisperDims(n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=2,
                           n_audio_layer=2, n_vocab=51865, n_text_ctx=448,
                           n_text_state=64, n_text_head=2, n_text_layer=2)
    tr = ttr.load_transcriber(twm.init_params(dims, torch.Generator().manual_seed(0)),
                              TranscriptionConfig(batch_size=2, max_decode_len=8,
                                                  language="en"), device="cpu")
    key = ("tiny", PipelineConfig().transcription.beam_size, "cpu")
    monkeypatch.setitem(tpipe._PIPELINE_CACHE, key, tpipe.AudioProcessingPipeline(
        PipelineConfig(), transcriber=tr, device="cpu"))
    audio_dir = tmp_path / "audio"
    audio_dir.mkdir()
    for i in range(3):
        tio.write_wav(str(audio_dir / f"c{i}.wav"),
                      0.1 * np.sin(np.arange(16000 * (i + 1)) / 16000 * 2 * np.pi * 300)
                      .astype(np.float32))
    out = tmp_path / "out"
    tcli.main(["batch", "-i", str(audio_dir), "-o", str(out), "--model", "tiny",
               "--device", "cpu", "--no-enrich", "--files-per-call", "2"])
    stats = json.loads(capsys.readouterr().out)
    assert stats["processed"] == 3 and stats["failed"] == 0
    assert stats["audio_seconds"] == pytest.approx(6.0)
    assert sorted(p.name for p in out.iterdir()) == [
        "c0.json", "c1.json", "c2.json", "manifest_host0.json"]
    assert json.loads((out / "c2.json").read_text())["duration"] == pytest.approx(3.0)
