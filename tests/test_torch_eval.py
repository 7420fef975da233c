"""Port accuracy-gate runner (turbo_whisper_workspace_tpu_torch/utils/
evaluate.py) against the JAX package: RTTM parsing, corpus WER and DER
aggregation from injected results (the reports must be equal), a missing
reference warned and not fatal, and the CLI's `eval` with a fake
pipeline."""

import json
import logging
import os

import numpy as np
import pytest

from turbo_whisper_workspace_tpu.utils import evaluate as jeval
from turbo_whisper_workspace_tpu_torch import __main__ as tcli
from turbo_whisper_workspace_tpu_torch.audio.io import write_wav
from turbo_whisper_workspace_tpu_torch.pipeline import audio_pipeline as tpipe
from turbo_whisper_workspace_tpu_torch.utils import evaluate as teval


class FakePipeline:
    """Canned transcripts/diarizations keyed by file stem."""

    def __init__(self, canned):
        self.canned = canned
        self.calls = []

    def process_batch(self, files, **kw):
        self.calls.append((list(files), kw))
        return [self.canned[os.path.splitext(os.path.basename(p))[0]] for p in files]


def _result(text, diar, duration=10.0):
    return {"text": text, "segments": [], "diarization_segments": diar,
            "duration": duration}


CANNED = {
    "a": _result("the quick brown cat jumps", [
        {"start": 0.0, "end": 5.0, "speaker": "Speaker 1"},
        {"start": 5.0, "end": 10.0, "speaker": "Speaker 0"}]),
    "b": _result("hello world", [{"start": 0.0, "end": 5.0, "speaker": "Speaker 0"}]),
}


@pytest.fixture
def fixture_dir(tmp_path):
    audio, ref, rttm = (tmp_path / d for d in ("audio", "ref", "rttm"))
    for d in (audio, ref, rttm):
        d.mkdir()
    for stem in ("a", "b"):
        write_wav(str(audio / f"{stem}.wav"), np.zeros(16000, np.float32), 16000)
    (audio / "notes.txt").write_text("not audio")
    (ref / "a.txt").write_text("the quick brown fox jumps")
    (ref / "b.txt").write_text("hello world")
    (rttm / "a.rttm").write_text(
        ";; comment line\n"
        "SPEAKER a 1 0.00 5.00 <NA> <NA> X <NA> <NA>\n"
        "SPEAKER a 1 5.00 5.00 <NA> <NA> Y <NA> <NA>\n")
    (rttm / "b.rttm").write_text("SPEAKER b 1 0.00 10.00 <NA> <NA> Z <NA> <NA>\n")
    return audio, ref, rttm


def test_parse_rttm_matches_jax(fixture_dir):
    _, _, rttm = fixture_dir
    for stem in ("a", "b"):
        path = str(rttm / f"{stem}.rttm")
        assert teval.parse_rttm(path) == jeval.parse_rttm(path)
    assert teval.parse_rttm(str(rttm / "a.rttm")) == [
        {"start": 0.0, "end": 5.0, "speaker": "X"},
        {"start": 5.0, "end": 10.0, "speaker": "Y"}]


@pytest.mark.parametrize("gates", ["wer", "der", "both"])
@pytest.mark.parametrize("collar", [0.0, 0.25])
def test_corpus_report_matches_jax(fixture_dir, gates, collar):
    audio, ref, rttm = fixture_dir
    kw = dict(ref_dir=str(ref) if gates != "der" else None,
              rttm_dir=str(rttm) if gates != "wer" else None, collar_s=collar)
    want = jeval.evaluate_corpus(str(audio), pipeline=FakePipeline(CANNED), **kw)
    pipe = FakePipeline(CANNED)
    got = teval.evaluate_corpus(str(audio), pipeline=pipe, device="cpu", **kw)
    assert got == want
    assert pipe.calls == [([str(audio / "a.wav"), str(audio / "b.wav")],
                           {"num_speakers": 0, "enrich": False})]
    if gates != "der":
        assert got["wer"] == round(1 / 7, 4) and got["wer_ref_words"] == 7
    if gates != "wer" and collar == 0.0:
        assert got["files"]["a"]["der"] == 0.0
        assert got["der"] == pytest.approx(0.25, abs=0.01)


def test_precomputed_results_skip_inference(fixture_dir):
    audio, ref, _ = fixture_dir
    results = [CANNED["a"], CANNED["b"]]
    got = teval.evaluate_corpus(str(audio), ref_dir=str(ref), results=results)
    assert got == jeval.evaluate_corpus(str(audio), ref_dir=str(ref), results=results)


def test_missing_reference_is_warned_not_fatal(fixture_dir, caplog):
    audio, ref, rttm = fixture_dir
    os.remove(str(ref / "b.txt"))
    os.remove(str(rttm / "a.rttm"))
    with caplog.at_level(logging.WARNING, logger=teval.logger.name):
        got = teval.evaluate_corpus(str(audio), ref_dir=str(ref), rttm_dir=str(rttm),
                                    pipeline=FakePipeline(CANNED), device="cpu")
    want = jeval.evaluate_corpus(str(audio), ref_dir=str(ref), rttm_dir=str(rttm),
                                 pipeline=FakePipeline(CANNED))
    assert got == want
    assert got["files"]["b"]["wer"] is None and got["files"]["a"]["der"] is None
    messages = [r.getMessage() for r in caplog.records]
    assert "no reference transcript for b" in messages
    assert "no reference RTTM for a" in messages


def test_empty_directory_raises(tmp_path):
    with pytest.raises(ValueError, match="no audio files"):
        teval.evaluate_corpus(str(tmp_path), ref_dir=str(tmp_path), device="cpu")


def test_cli_eval(fixture_dir, capsys, monkeypatch):
    audio, ref, rttm = fixture_dir
    pipe = FakePipeline(CANNED)
    seen = []
    monkeypatch.setattr(tpipe, "get_pipeline", lambda *a, **k: seen.append(k) or pipe)
    tcli.main(["eval", "--audio", str(audio), "--ref", str(ref), "--rttm", str(rttm),
               "--collar", "0.0", "--device", "cpu"])
    rep = json.loads(capsys.readouterr().out)
    assert seen == [{"device": "cpu"}]
    assert rep == json.loads(json.dumps(jeval.evaluate_corpus(
        str(audio), ref_dir=str(ref), rttm_dir=str(rttm), pipeline=FakePipeline(CANNED),
        collar_s=0.0)))
    assert rep["n_files"] == 2


def test_cli_eval_needs_a_gate(fixture_dir):
    audio, _, _ = fixture_dir
    with pytest.raises(SystemExit):
        tcli.main(["eval", "--audio", str(audio), "--device", "cpu"])
