"""HTTP API client + server self-boot.

Port of turbo_whisper_workspace_tpu/serve/client.py (stdlib only; the
self-booted server runs the pipeline on the caller's device). Rebuilds
app_api.py's two-process pattern: a thin client that talks to
the API over HTTP (`app_api.py:108-136`) and `ensure_api_server_running`
which probes the server and spawns it in-process when absent
(`app_api.py:66-105`). Useful for driving a long-lived serving process
from scripts and notebooks without importing the heavy pipeline.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
import urllib.error
import urllib.request
import uuid

logger = logging.getLogger(__name__)

DEFAULT_BASE_URL = os.environ.get("TWT_API_URL", "http://127.0.0.1:8000")


class APIClient:
    def __init__(self, base_url: str = DEFAULT_BASE_URL, timeout: float = 600.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    def _post_file(self, route: str, path: str, fields: dict | None = None):
        boundary = f"twt{uuid.uuid4().hex}"
        with open(path, "rb") as f:
            payload = f.read()
        body = b""
        for k, v in (fields or {}).items():
            body += (f"--{boundary}\r\nContent-Disposition: form-data; "
                     f'name="{k}"\r\n\r\n{v}\r\n').encode()
        body += (f"--{boundary}\r\nContent-Disposition: form-data; "
                 f'name="file"; filename="{os.path.basename(path)}"\r\n\r\n'
                 ).encode() + payload + b"\r\n"
        body += f"--{boundary}--\r\n".encode()
        req = urllib.request.Request(
            self.base_url + route, data=body,
            headers={"Content-Type": f"multipart/form-data; boundary={boundary}"},
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as r:
            return json.loads(r.read())

    def health(self) -> dict | None:
        try:
            with urllib.request.urlopen(self.base_url + "/", timeout=3) as r:
                return json.loads(r.read())
        except Exception:
            return None

    def models(self) -> dict:
        with urllib.request.urlopen(self.base_url + "/api/models",
                                    timeout=30) as r:
            return json.loads(r.read())

    def transcribe(self, path: str, task: str = "transcribe",
                   num_speakers: int = 2, threshold: float = 0.5) -> dict:
        return self._post_file("/api/transcribe", path, {
            "task": task, "num_speakers": num_speakers, "threshold": threshold,
        })

    def security_analyze(self, path: str, bar_specific: bool = False) -> dict:
        return self._post_file("/api/security/analyze", path,
                               {"bar_specific": str(bar_specific).lower()})

    def analyze(self, path: str) -> dict:
        return self._post_file("/api/analyze", path)


def ensure_api_server_running(
    host: str = "127.0.0.1", port: int = 8000, wait_s: float = 30.0,
    device: str = "cuda",
) -> APIClient:
    """Probe the API; start an in-process server thread on `device` when
    absent (app_api.py:66-105 semantics)."""
    client = APIClient(f"http://{host}:{port}")
    if client.health() is not None:
        return client
    from .api import serve

    httpd = serve(host, port, device)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    deadline = time.time() + wait_s
    while time.time() < deadline:
        if client.health() is not None:
            logger.info("API server self-booted on %s:%d", host, port)
            return client
        time.sleep(0.2)
    raise RuntimeError("API server failed to start")
