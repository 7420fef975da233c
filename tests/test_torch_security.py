"""Port security monitors (turbo_whisper_workspace_tpu_torch/analysis:
security_monitor, bar_security_monitor) against the JAX package: every
case of tests/test_security.py through both packages on the same
transcripts, the report files, the directory batch, and end to end on a
tiny Whisper carried over with from_jax_params (same weights, same file).
"""

import json
import os
import pathlib

import jax
import numpy as np
import pytest

from turbo_whisper_workspace_tpu.analysis import bar_security_monitor as jbar
from turbo_whisper_workspace_tpu.analysis import security_monitor as jsec
from turbo_whisper_workspace_tpu.config import PipelineConfig as JPipelineConfig
from turbo_whisper_workspace_tpu.config import TranscriptionConfig as JTConfig
from turbo_whisper_workspace_tpu.llm import llm_helper as jllm
from turbo_whisper_workspace_tpu.models import whisper as jwm
from turbo_whisper_workspace_tpu.pipeline import audio_pipeline as jpipe
from turbo_whisper_workspace_tpu.pipeline import transcriber as jtr
from turbo_whisper_workspace_tpu_torch.analysis import bar_security_monitor as tbar
from turbo_whisper_workspace_tpu_torch.analysis import security_monitor as tsec
from turbo_whisper_workspace_tpu_torch.audio import io as tio
from turbo_whisper_workspace_tpu_torch.config import PipelineConfig
from turbo_whisper_workspace_tpu_torch.config import TranscriptionConfig as TConfig
from turbo_whisper_workspace_tpu_torch.llm import llm_helper as tllm
from turbo_whisper_workspace_tpu_torch.models import convert
from turbo_whisper_workspace_tpu_torch.models import whisper as twm
from turbo_whisper_workspace_tpu_torch.pipeline import audio_pipeline as tpipe
from turbo_whisper_workspace_tpu_torch.pipeline import transcriber as ttr
from tests.test_torch_pipeline import one_thread  # noqa: F401  (a fixture)

GOLDEN = pathlib.Path(__file__).resolve().parent.parent / "examples" / "golden"


@pytest.fixture(autouse=True)
def dummy_llms():
    jllm.set_llm(jllm.DummyLLM())
    tllm.set_llm(tllm.DummyLLM())
    yield
    jllm.set_llm(None)
    tllm.set_llm(None)


def _segs(*texts):
    return [
        {"speaker": f"Speaker {i % 2}", "text": t, "start": float(i),
         "end": float(i + 1)}
        for i, t in enumerate(texts)
    ]


def _same(got, ref) -> None:
    """Incidents equal apart from their timestamps (or both None)."""
    assert (got is None) == (ref is None)
    if ref is None:
        return
    g, r = got.to_dict(), ref.to_dict()
    g.pop("timestamp")
    r.pop("timestamp")
    assert g == r
    assert str(got).splitlines()[4:] == str(ref).splitlines()[4:]


# every transcript of tests/test_security.py, with its monitor
CASES = {
    "benign": ("plain", ("Nice weather today.", "Yes, lovely!")),
    "weapon": ("plain", ("He has a gun in his jacket.", "Call the police now.")),
    "capped": ("plain", ("Give me the money or I'll kill you, I have a gun and "
                         "some cocaine to sell, want to fight?",)),
    "context": ("plain", ("First line.", "Second line.", "He pulled a knife!",
                          "Fourth line.", "Fifth line.")),
    "verbal": ("plain", ("I'll kill you.",)),
    "fallback": ("plain", ("He has a knife.",)),
    "bar_underage": ("bar", ("That kid used a fake ID, he's underage.",)),
    "bar_intoxication": ("bar", ("He's totally wasted and can't walk straight.",
                                 "Yeah he's been slurring and stumbling all night.")),
    "bar_robbery": ("bar", ("Empty the register, this is a stick up.",)),
}


def _monitors(kind, tmp_path):
    jcls, tcls = (jsec.SecurityMonitor, tsec.SecurityMonitor) if kind == "plain" else \
        (jbar.BarSecurityMonitor, tbar.BarSecurityMonitor)
    return (jcls(output_dir=str(tmp_path / "jax")),
            tcls(output_dir=str(tmp_path / "torch"), device="cpu"))


@pytest.mark.parametrize("name", sorted(CASES))
def test_analyze_transcript_matches_jax(name, tmp_path):
    kind, texts = CASES[name]
    jmon, tmon = _monitors(kind, tmp_path)
    segs = _segs(*texts)
    ref = jmon._analyze_transcript(segs, "x.wav")
    got = tmon._analyze_transcript(segs, "x.wav")
    _same(got, ref)
    if name == "benign":
        assert got is None
    else:
        assert got.threat_level >= 1 and got.summary


@pytest.mark.parametrize("floor", [0, 1, 5])
def test_min_threat_level_override_matches_jax(floor, tmp_path):
    jmon, tmon = _monitors("plain", tmp_path)
    segs = _segs("He has a knife.")
    _same(tmon._analyze_transcript(segs, "x.wav", min_threat_level=floor),
          jmon._analyze_transcript(segs, "x.wav", min_threat_level=floor))


def test_report_files_and_collisions(tmp_path):
    jmon, tmon = _monitors("plain", tmp_path)
    segs = _segs("I'll kill you.")
    ref = jmon._analyze_transcript(segs, "x.wav")
    got = tmon._analyze_transcript(segs, "x.wav")
    got.timestamp = ref.timestamp
    paths = [tmon._save_incident_report(got) for _ in range(3)]
    jpaths = [jmon._save_incident_report(ref) for _ in range(3)]
    # the collision counter: three files in one second, none overwritten
    assert len({jp for jp, _ in paths}) == 3
    for pair, ref_pair in zip(paths, jpaths):
        jp, tp, rjp, rtp = map(pathlib.Path, pair + ref_pair)
        assert json.loads(jp.read_text()) == json.loads(rjp.read_text())
        assert tp.read_text() == rtp.read_text()
        assert "SECURITY INCIDENT REPORT" in tp.read_text()


def test_fallback_summary_matches_jax(tmp_path):
    jmon, tmon = _monitors("plain", tmp_path)
    inc = tmon._analyze_transcript(_segs("He has a knife."), "x.wav")
    assert inc.summary == jmon._analyze_transcript(_segs("He has a knife."), "x.wav").summary
    assert "weapon" in inc.summary


def test_mock_harness_matches_jax(tmp_path):
    got = tbar.run_mock_analysis(
        monitor=tbar.BarSecurityMonitor(output_dir=str(tmp_path), device="cpu"))
    _same(got, jbar.run_mock_analysis(
        monitor=jbar.BarSecurityMonitor(output_dir=str(tmp_path))))
    assert got.audio_file == "<mock>" and got.incident_type == "underage_drinking"
    p = str(tmp_path / "mock.json")
    (tmp_path / "mock.json").write_text(json.dumps(_segs("All quiet tonight.")))
    assert tbar.run_mock_analysis(p) is None and jbar.run_mock_analysis(p) is None


def test_monitor_directory_one_batch_call(tmp_path):
    calls = []

    class FakePipeline:
        def process_batch(self, files, **kw):
            calls.append(list(files))
            return [{"merged_segments": _segs("He has a gun.")} for _ in files]

    for name in ("a.wav", "b.wav", "notes.txt"):
        tio.write_wav(str(tmp_path / name), np.zeros(1600, np.float32))
    got = tsec.SecurityMonitor(pipeline=FakePipeline(), output_dir=str(tmp_path / "t"),
                               device="cpu").monitor_directory(str(tmp_path))
    ref = jsec.SecurityMonitor(pipeline=FakePipeline(),
                               output_dir=str(tmp_path / "j")).monitor_directory(str(tmp_path))
    assert calls[0] == calls[1] == [str(tmp_path / "a.wav"), str(tmp_path / "b.wav")]
    assert len(got) == len(ref) == 2
    for g, r in zip(got, ref):
        _same(g, r)
    assert len(os.listdir(tmp_path / "t")) == 4


def test_default_pipeline_is_on_the_monitors_device(monkeypatch):
    seen = []
    monkeypatch.setattr(tpipe, "get_pipeline", lambda *a, **k: seen.append(k) or "pipe")
    assert tsec.SecurityMonitor(device="cpu").pipeline == "pipe"
    assert seen == [{"device": "cpu"}]


def test_process_audio_file_matches_jax_end_to_end(tmp_path, monkeypatch, one_thread):
    """The golden clip through both monitors' full pipelines on the same
    tiny Whisper (JAX init from seed 0, converted), f32, greedy at T = 0,
    weight-free diarization; min_threat_level 0 keeps the incident (and
    with it the transcript) even when nothing matches."""
    monkeypatch.setattr(jtr, "FALLBACK_TEMPERATURES", (0.0,))
    monkeypatch.setattr(ttr, "FALLBACK_TEMPERATURES", (0.0,))
    dims = jwm.WHISPER_CONFIGS["tiny"]
    params = jwm.init_params(dims, jax.random.PRNGKey(0))
    kw = dict(batch_size=2, max_decode_len=24, language="en")
    jt = jtr.load_transcriber(params, dims, JTConfig(**kw))
    model = convert.from_jax_params(jax.tree.map(np.asarray, params),
                                    twm.WHISPER_CONFIGS["tiny"])
    tt = ttr.load_transcriber(model, TConfig(**kw), device="cpu")
    jmon = jsec.SecurityMonitor(
        pipeline=jpipe.AudioProcessingPipeline(JPipelineConfig(), transcriber=jt),
        output_dir=str(tmp_path / "jax"))
    tmon = tsec.SecurityMonitor(
        pipeline=tpipe.AudioProcessingPipeline(PipelineConfig(), transcriber=tt,
                                               device="cpu"),
        output_dir=str(tmp_path / "torch"), device="cpu")
    path = str(GOLDEN / "conversation.wav")
    ref = jmon.process_audio_file(path, min_threat_level=0)
    got = tmon.process_audio_file(path, min_threat_level=0)
    assert got is not None
    _same(got, ref)
    assert len(os.listdir(tmp_path / "torch")) == 2
