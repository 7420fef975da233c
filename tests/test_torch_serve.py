"""Port serving (turbo_whisper_workspace_tpu_torch/serve/): the cases of
tests/test_serve.py, tests/test_concurrency.py and the client self-boot
of tests/test_features_client.py against the port's server and client
(fake pipelines, device "cpu"), and the whole slice: the port's
/api/transcribe response on a tiny Whisper equals the JAX server's on
the same WAV, and two concurrent requests equal the lone one."""

import importlib.util
import io
import json
import socket
import threading
import urllib.error
import urllib.request
import wave

import jax
import numpy as np
import pytest

from turbo_whisper_workspace_tpu.config import PipelineConfig as JPipelineConfig
from turbo_whisper_workspace_tpu.config import TranscriptionConfig as JTConfig
from turbo_whisper_workspace_tpu.llm import llm_helper as jllm
from turbo_whisper_workspace_tpu.models import whisper as jwm
from turbo_whisper_workspace_tpu.pipeline import audio_pipeline as jpipe
from turbo_whisper_workspace_tpu.pipeline import transcriber as jtr
from turbo_whisper_workspace_tpu.serve import api as japi
from turbo_whisper_workspace_tpu_torch.audio import io as tio
from turbo_whisper_workspace_tpu_torch.config import PipelineConfig, TranscriptionConfig
from turbo_whisper_workspace_tpu_torch.llm import llm_helper as tllm
from turbo_whisper_workspace_tpu_torch.models import convert
from turbo_whisper_workspace_tpu_torch.models import whisper as twm
from turbo_whisper_workspace_tpu_torch.pipeline import audio_pipeline as tpipe
from turbo_whisper_workspace_tpu_torch.pipeline import transcriber as ttr
from turbo_whisper_workspace_tpu_torch.serve import api as api_mod
from turbo_whisper_workspace_tpu_torch.serve.client import (APIClient,
                                                            ensure_api_server_running)


class FakePipeline:
    def process_audio(self, path, **kw):
        audio, sr = tio.read_audio_file(path)
        return {
            "text": " hello world",
            "segments": [{"text": " hello world", "start": 0.0, "end": 1.0}],
            "chunks": [{"timestamp": [0.0, 1.0], "text": " hello world"}],
            "merged_segments": [
                {"speaker": "Speaker 0", "text": " hello world", "start": 0.0, "end": 1.0}],
            "diarization_segments": [],
            "duration": len(audio) / sr,
            "processing_times": {"total": 0.1},
            "kwargs_seen": kw,
        }


def _start(module, pipeline):
    module._singletons.clear()
    module.set_pipeline(pipeline)
    kw = {"device": "cpu"} if module is api_mod else {}
    httpd = module.serve("127.0.0.1", 0, **kw)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def server():
    httpd, url = _start(api_mod, FakePipeline())
    yield url
    httpd.shutdown()
    api_mod._singletons.clear()


def _multipart(fields: dict) -> tuple[bytes, str]:
    boundary = "testboundary123"
    out = b""
    for name, val in fields.items():
        out += f"--{boundary}\r\n".encode()
        if isinstance(val, bytes):
            out += (f'Content-Disposition: form-data; name="{name}"; '
                    f'filename="t.wav"\r\n\r\n').encode() + val + b"\r\n"
        else:
            out += f'Content-Disposition: form-data; name="{name}"\r\n\r\n{val}\r\n'.encode()
    out += f"--{boundary}--\r\n".encode()
    return out, f"multipart/form-data; boundary={boundary}"


def _wav_bytes(audio=None):
    if audio is None:
        audio = np.random.default_rng(0).standard_normal(16000) * 0.1
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(audio, -1, 1) * 32767).astype("<i2").tobytes())
    return buf.getvalue()


def _post(url, fields):
    body, ctype = _multipart(fields)
    req = urllib.request.Request(url, data=body, headers={"Content-Type": ctype})
    with urllib.request.urlopen(req) as r:
        return json.loads(r.read())


def test_root_and_models(server):
    with urllib.request.urlopen(server + "/") as r:
        root = json.loads(r.read())
    assert root["name"] == "turbo-whisper-workspace-tpu-torch"
    assert "/api/transcribe" in root["endpoints"]
    with urllib.request.urlopen(server + "/api/models") as r:
        models = json.loads(r.read())
    assert "large-v3-turbo" in models["whisper_models"]
    assert "3dspeaker" in models["embedding_models"]
    assert models == japi.route_models()          # the same registry


def test_transcribe_route(server):
    res = _post(server + "/api/transcribe", {"file": _wav_bytes(), "num_speakers": "3"})
    assert res["text"] == " hello world"
    assert res["kwargs_seen"]["num_speakers"] == 3


def test_security_route(server):
    res = _post(server + "/api/security/analyze",
                {"file": _wav_bytes(), "bar_specific": "false"})
    assert res["incident_detected"] is False


def test_analyze_route(server):
    res = _post(server + "/api/analyze", {"file": _wav_bytes()})
    assert set(res["plots"]) == {"waveform", "spectrogram", "pitch", "chromagram"}
    assert res["audio_info"]["sample_rate"] == 16000


def test_analyze_route_without_matplotlib(server, monkeypatch):
    """Where matplotlib is missing, the audio info still answers."""
    find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "matplotlib" else find_spec(name, *a))
    res = _post(server + "/api/analyze", {"file": _wav_bytes()})
    assert res["plots"] == {} and "matplotlib" in res["plots_error"]
    assert res["audio_info"]["sample_rate"] == 16000


@pytest.mark.parametrize("path,status", [("/api/transcribe", 400), ("/api/nothing", 404)])
def test_errors_are_json(server, path, status):
    fields = {"task": "transcribe"} if status == 400 else {"file": _wav_bytes()}
    body, ctype = _multipart(fields)
    req = urllib.request.Request(server + path, data=body, headers={"Content-Type": ctype})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req)
    assert e.value.code == status and "error" in json.loads(e.value.read())


def test_ui_page(server):
    with urllib.request.urlopen(server + "/ui") as r:
        html = r.read().decode()
    assert "Turbo-Whisper" in html and "/api/transcribe" in html


def test_multipart_parser_roundtrip():
    body, ctype = _multipart({"a": "1", "file": b"\x00\x01bytes"})
    fields = api_mod.parse_multipart(body, ctype)
    assert fields["a"] == "1"
    assert fields["file"] == b"\x00\x01bytes"
    assert fields["file__filename"] == "t.wav"


def test_server_raises_without_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api_mod.serve("127.0.0.1", 0)


# ---------------------------------------------------------------------------
# tests/test_concurrency.py's cases


def test_concurrent_singleton_creation():
    class Pipeline:
        def process_audio(self, path, **kw):
            return {"ok": True}

    api_mod._singletons.clear()
    api_mod.set_pipeline(Pipeline())
    monitors, errs = [], []

    def grab():
        try:
            monitors.append(api_mod.get_monitor(False, "cpu"))
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=grab) for _ in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errs and len(monitors) == 16
    assert all(m is monitors[0] for m in monitors)     # one instance
    api_mod._singletons.clear()


def test_concurrent_api_requests(tmp_path):
    class SlowPipeline:
        def process_audio(self, path, **kw):
            import time

            time.sleep(0.05)
            return {"text": "x", "merged_segments": [], "segments": [], "chunks": [],
                    "diarization_segments": [], "duration": 1.0, "processing_times": {}}

    httpd, url = _start(api_mod, SlowPipeline())
    p = str(tmp_path / "x.wav")
    tio.write_wav(p, np.zeros(1600, np.float32))
    client = APIClient(url)
    results, errs = [], []

    def call():
        try:
            results.append(client.transcribe(p))
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=call) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    httpd.shutdown()
    api_mod._singletons.clear()
    assert not errs
    assert len(results) == 8 and all(r["text"] == "x" for r in results)


def test_llm_cache_thread_safety():
    tllm.set_llm(None)
    got = []
    threads = [threading.Thread(target=lambda: got.append(tllm.get_llm(device="cpu")))
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert len(got) == 8 and all(g is got[0] for g in got)
    tllm.set_llm(None)


def test_api_client_self_boot(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    api_mod._singletons.clear()
    api_mod.set_pipeline(FakePipeline())
    try:
        client = ensure_api_server_running(port=port, device="cpu")
        assert client.health()["name"] == "turbo-whisper-workspace-tpu-torch"
        p = str(tmp_path / "x.wav")
        tio.write_wav(p, np.zeros(1600, np.float32))
        res = client.transcribe(p, num_speakers=1)
        assert res["text"] == " hello world" and res["kwargs_seen"]["num_speakers"] == 1
        assert "whisper_models" in client.models()
        # a second call reuses the live server
        assert ensure_api_server_running(port=port, device="cpu").health() is not None
    finally:
        api_mod.set_pipeline(None)
        api_mod._singletons.clear()


# ---------------------------------------------------------------------------
# the whole slice: a real tiny pipeline behind both servers


DIMS = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=2,
            n_audio_layer=2, n_vocab=51865, n_text_ctx=448, n_text_state=64,
            n_text_head=2, n_text_layer=2)


def _same(got, want, path=""):
    """Equal JSON trees, floats within 1e-4."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _same(a, b, f"{path}[{i}]")
    elif isinstance(want, float):
        assert got == pytest.approx(want, abs=1e-4), path
    else:
        assert got == want, path


def test_transcribe_response_matches_jax_server(monkeypatch):
    """The port's /api/transcribe on the JAX init's tiny Whisper carried
    across by models/convert.py (f32, greedy at T = 0, weight-free
    diarization, DummyLLM) equals the JAX server's on the same WAV,
    processing times and the upload's temp path aside; task="transcribe"
    (a per-call task reaches only the port's prompt, deviation C3). Two
    concurrent requests to the port give the lone request's response."""
    monkeypatch.setattr(jtr, "FALLBACK_TEMPERATURES", (0.0,))
    monkeypatch.setattr(ttr, "FALLBACK_TEMPERATURES", (0.0,))
    params = jwm.init_params(jwm.WhisperDims(**DIMS), jax.random.PRNGKey(0))
    kw = dict(batch_size=2, max_decode_len=8, language="en")
    jt = jtr.load_transcriber(params, jwm.WhisperDims(**DIMS), JTConfig(**kw))
    model = convert.from_jax_params(jax.tree.map(np.asarray, params), twm.WhisperDims(**DIMS))
    tt = ttr.load_transcriber(model, TranscriptionConfig(**kw), device="cpu")
    t = np.arange(3 * 16000) / 16000
    audio = 0.2 * np.sin(2 * np.pi * 200 * t) + 0.02 * np.random.default_rng(4).standard_normal(
        t.size)
    fields = {"file": _wav_bytes(audio), "num_speakers": "2", "task": "transcribe"}
    jllm.set_llm(jllm.DummyLLM())
    tllm.set_llm(tllm.DummyLLM())
    servers = []
    try:
        jhttpd, jurl = _start(japi, jpipe.AudioProcessingPipeline(JPipelineConfig(),
                                                                  transcriber=jt))
        thttpd, turl = _start(api_mod, tpipe.AudioProcessingPipeline(
            PipelineConfig(), transcriber=tt, device="cpu"))
        servers = [jhttpd, thttpd]
        want = _post(jurl + "/api/transcribe", fields)
        got = _post(turl + "/api/transcribe", fields)
        concurrent = [None, None]

        def call(i):
            concurrent[i] = _post(turl + "/api/transcribe", fields)

        threads = [threading.Thread(target=call, args=(i,)) for i in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        for httpd in servers:
            httpd.shutdown()
        jllm.set_llm(None)
        tllm.set_llm(None)
        for module in (japi, api_mod):
            module._singletons.clear()
    for res in (want, got, *concurrent):
        assert res is not None
        res.pop("processing_times")
        res.pop("audio_path")
    _same(got, want)
    for res in concurrent:
        _same(res, got)
