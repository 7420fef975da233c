"""HTTP API server with the reference's route surface.

Port of turbo_whisper_workspace_tpu/serve/api.py: POST /api/transcribe,
POST /api/security/analyze, POST /api/analyze, GET /api/models, GET /
and the browser page at GET /ui; multipart uploads spooled to temp
files and removed after the response, CORS-allow-all, JSON errors 400 /
404 / 500, and module-level pipeline/monitor singletons built under one
lock, on the server's device (CUDA unless `device="cpu"`).

The server is stdlib http.server + a hand-rolled multipart parser;
`run_api_server` prefers FastAPI/uvicorn where both are installed
(`create_fastapi_app()` returns the same surface, imported lazily).
Concurrent requests call the pipeline concurrently, unserialized, as in
the JAX package. /api/analyze draws its four plots with matplotlib;
where matplotlib is not installed it answers with the audio info and
no plots (`plots_error` says why) instead of failing the request.
"""

from __future__ import annotations

import importlib.util
import io
import json
import logging
import os
import re
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from ..pipeline.transcriber import resolve_device

logger = logging.getLogger(__name__)

_singletons: dict = {}
_lock = threading.RLock()  # get_monitor → get_pipeline nests the lock


def get_pipeline(device: torch.device | str = "cuda"):
    with _lock:
        if "pipeline" not in _singletons:
            from ..pipeline.audio_pipeline import get_pipeline as _gp

            _singletons["pipeline"] = _gp(device=device)
        return _singletons["pipeline"]


def get_monitor(bar_specific: bool = False, device: torch.device | str = "cuda"):
    key = "bar_monitor" if bar_specific else "monitor"
    with _lock:
        if key not in _singletons:
            if bar_specific:
                from ..analysis.bar_security_monitor import BarSecurityMonitor

                _singletons[key] = BarSecurityMonitor(pipeline=get_pipeline(device),
                                                      device=device)
            else:
                from ..analysis.security_monitor import SecurityMonitor

                _singletons[key] = SecurityMonitor(pipeline=get_pipeline(device),
                                                   device=device)
        return _singletons[key]


def set_pipeline(p) -> None:
    """Inject a pipeline (tests)."""
    with _lock:
        _singletons.clear()
        _singletons["pipeline"] = p


def parse_multipart(body: bytes, content_type: str) -> dict:
    """Minimal multipart/form-data parser → {name: bytes|str}."""
    m = re.search(r'boundary="?([^";]+)"?', content_type)
    if not m:
        raise ValueError("no multipart boundary")
    boundary = m.group(1).encode()
    parts = body.split(b"--" + boundary)
    fields: dict = {}
    for part in parts[1:-1]:
        part = part.lstrip(b"\r\n")
        if not part or part == b"--":
            continue
        head, _, payload = part.partition(b"\r\n\r\n")
        # exactly one CRLF separates payload from the next boundary —
        # rstrip would eat legitimate trailing bytes of binary payloads
        if payload.endswith(b"\r\n"):
            payload = payload[:-2]
        name_m = re.search(rb'name="([^"]+)"', head)
        if not name_m:
            continue
        name = name_m.group(1).decode()
        if b"filename=" in head:
            fields[name] = payload
            fn = re.search(rb'filename="([^"]*)"', head)
            fields[f"{name}__filename"] = fn.group(1).decode() if fn else ""
        else:
            fields[name] = payload.decode("utf-8", "replace")
    return fields


def _save_upload_tmp(data: bytes, filename: str = "upload.wav") -> str:
    """Spool an upload to a temp file (vocalis/api/main.py:67-75)."""
    suffix = os.path.splitext(filename)[1] or ".wav"
    fd, path = tempfile.mkstemp(suffix=suffix, prefix="twt_upload_")
    with os.fdopen(fd, "wb") as f:
        f.write(data)
    return path


# ---------------------------------------------------------------------------
# Route implementations (shared by stdlib server and FastAPI app)


def route_root() -> dict:
    from .. import __version__

    return {"name": "turbo-whisper-workspace-tpu-torch", "version": __version__,
            "endpoints": ["/api/transcribe", "/api/security/analyze",
                          "/api/analyze", "/api/models"]}


def route_models() -> dict:
    """GET /api/models (vocalis/api/main.py:233-247)."""
    from ..models.whisper import WHISPER_CONFIGS
    from ..utils.registry import (
        embedding2models, get_local_embedding_models,
        get_local_segmentation_models, speaker_segmentation_models,
    )

    return {
        "whisper_models": sorted(WHISPER_CONFIGS),
        "segmentation_models": speaker_segmentation_models(),
        "embedding_models": embedding2models(),
        "local_segmentation_models": get_local_segmentation_models(),
        "local_embedding_models": get_local_embedding_models(),
    }


def route_transcribe(file_bytes: bytes, filename: str, form: dict,
                     device: torch.device | str = "cuda") -> dict:
    """POST /api/transcribe (vocalis/api/main.py:89-131). Request-level
    segmentation/embedding model selection reaches the diarizer, matching
    the reference's TranscriptionRequest fields (`:49-54,110-117`)."""
    path = _save_upload_tmp(file_bytes, filename)
    try:
        return get_pipeline(device).process_audio(
            path,
            task=form.get("task", "transcribe"),
            num_speakers=int(form.get("num_speakers", 2)),
            threshold=float(form.get("threshold", 0.5)),
            segmentation_model=form.get("segmentation_model") or None,
            embedding_model=form.get("embedding_model") or None,
        )
    finally:
        os.unlink(path)


def route_security(file_bytes: bytes, filename: str, form: dict,
                   device: torch.device | str = "cuda") -> dict:
    """POST /api/security/analyze (vocalis/api/main.py:133-173), honoring
    the request's min_threat_level (`:56-58`)."""
    bar = str(form.get("bar_specific", "false")).lower() in ("1", "true", "yes")
    mtl = form.get("min_threat_level")
    mtl = int(mtl) if mtl not in (None, "") else None
    path = _save_upload_tmp(file_bytes, filename)
    try:
        incident = get_monitor(bar, device).process_audio_file(
            path, min_threat_level=mtl
        )
        if incident is None:
            return {"incident_detected": False}
        return {"incident_detected": True, "incident": incident.to_dict()}
    finally:
        os.unlink(path)


def route_analyze(file_bytes: bytes, filename: str, form: dict) -> dict:
    """POST /api/analyze (vocalis/api/main.py:175-231): audio info + the
    four plots (returned as base64 PNGs); without matplotlib, no plots
    and `plots_error`."""
    import base64

    from ..analysis import audio_info as ai
    from ..analysis import visualizer as vz
    from ..audio.io import read_audio_file

    path = _save_upload_tmp(file_bytes, filename)
    try:
        info = ai.get_audio_info(path)
        if importlib.util.find_spec("matplotlib") is None:
            return {"audio_info": info, "plots": {},
                    "plots_error": "matplotlib is not installed"}
        audio, sr = read_audio_file(path)
        plots = {}
        for name, fig in (
            ("waveform", vz.plot_waveform(audio, sr)),
            ("spectrogram", vz.plot_spectrogram(audio, sr)),
            ("pitch", vz.plot_pitch_track(audio, sr)),
            ("chromagram", vz.plot_chromagram(audio, sr)),
        ):
            buf = io.BytesIO()
            fig.savefig(buf, format="png", dpi=60)
            plots[name] = base64.b64encode(buf.getvalue()).decode()
            import matplotlib.pyplot as plt

            plt.close(fig)
        return {"audio_info": info, "plots": plots}
    finally:
        os.unlink(path)


# ---------------------------------------------------------------------------
# stdlib server


class Handler(BaseHTTPRequestHandler):
    """Routes a request to the route functions on the server's device
    (`serve` sets `server.device`)."""

    server_version = "twt-torch/0.1"

    def _json(self, obj, status: int = 200):
        data = json.dumps(obj, default=str).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.send_header("Access-Control-Allow-Origin", "*")  # CORS-allow-all
        self.end_headers()
        self.wfile.write(data)

    def do_OPTIONS(self):
        self.send_response(204)
        self.send_header("Access-Control-Allow-Origin", "*")
        self.send_header("Access-Control-Allow-Methods", "GET, POST, OPTIONS")
        self.send_header("Access-Control-Allow-Headers", "*")
        self.end_headers()

    def do_GET(self):
        if self.path == "/":
            return self._json(route_root())
        if self.path == "/api/models":
            return self._json(route_models())
        if self.path in ("/ui", "/ui/"):
            from .ui import INDEX_HTML

            data = INDEX_HTML.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)
            return
        self._json({"error": "not found"}, 404)

    def do_POST(self):
        try:
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length)
            form = parse_multipart(body, self.headers.get("Content-Type", ""))
            file_bytes = form.get("file")
            if not isinstance(file_bytes, bytes):
                return self._json({"error": "missing file field"}, 400)
            filename = form.get("file__filename", "upload.wav")
            device = self.server.device
            if self.path == "/api/transcribe":
                return self._json(route_transcribe(file_bytes, filename, form, device))
            if self.path == "/api/security/analyze":
                return self._json(route_security(file_bytes, filename, form, device))
            if self.path == "/api/analyze":
                return self._json(route_analyze(file_bytes, filename, form))
            self._json({"error": "not found"}, 404)
        except Exception as e:  # degrade per-request, never crash the server
            logger.exception("request failed")
            self._json({"error": str(e)}, 500)

    def log_message(self, fmt, *args):
        logger.info("%s - %s", self.address_string(), fmt % args)


def serve(host: str = "0.0.0.0", port: int = 8000,
          device: torch.device | str = "cuda") -> ThreadingHTTPServer:
    """A stdlib server (not yet serving: call serve_forever) whose
    requests run the pipeline on `device`."""
    device = resolve_device(device)
    httpd = ThreadingHTTPServer((host, port), Handler)
    httpd.device = device
    logger.info("API listening on %s:%d (%s)", host, port, httpd.device)
    return httpd


def run_api_server(host: str = "0.0.0.0", port: int = 8000,
                   device: torch.device | str = "cuda") -> None:
    try:
        import fastapi  # noqa: F401
        import uvicorn

        uvicorn.run(create_fastapi_app(device), host=host, port=port)
        return
    except ImportError:
        pass
    serve(host, port, device).serve_forever()


def create_fastapi_app(device: torch.device | str = "cuda"):
    """Same surface as the reference FastAPI app, when fastapi exists."""
    from fastapi import FastAPI, File, Form, UploadFile
    from fastapi.middleware.cors import CORSMiddleware

    device = resolve_device(device)
    app = FastAPI(title="turbo-whisper-workspace-tpu-torch")
    app.add_middleware(
        CORSMiddleware, allow_origins=["*"], allow_methods=["*"],
        allow_headers=["*"],
    )

    @app.get("/")
    def root():
        return route_root()

    @app.get("/api/models")
    def models():
        return route_models()

    @app.post("/api/transcribe")
    async def transcribe(file: UploadFile = File(...),
                         task: str = Form("transcribe"),
                         num_speakers: int = Form(2),
                         threshold: float = Form(0.5),
                         segmentation_model: str = Form(""),
                         embedding_model: str = Form("")):
        data = await file.read()
        return route_transcribe(data, file.filename or "upload.wav", {
            "task": task, "num_speakers": num_speakers, "threshold": threshold,
            "segmentation_model": segmentation_model,
            "embedding_model": embedding_model,
        }, device)

    @app.post("/api/security/analyze")
    async def security(file: UploadFile = File(...),
                       bar_specific: bool = Form(False),
                       min_threat_level: int = Form(None)):
        data = await file.read()
        return route_security(data, file.filename or "upload.wav",
                              {"bar_specific": bar_specific,
                               "min_threat_level": min_threat_level}, device)

    @app.post("/api/analyze")
    async def analyze(file: UploadFile = File(...)):
        data = await file.read()
        return route_analyze(data, file.filename or "upload.wav", {})

    return app
