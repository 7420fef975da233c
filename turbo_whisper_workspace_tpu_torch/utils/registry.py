"""Port copy of turbo_whisper_workspace_tpu/utils/registry.py with one
deviation: `MODELS_DIR` is a plain default, not read from the
`TWT_MODELS_DIR` environment variable. Every function that looks on disk
takes `models_dir` (callers pass `PipelineConfig.models_dir`).

Model registry: catalogs, local scanning, resolution ladders.

Rebuilds the registry half of vocalis/core/model.py: UI-facing catalogs
(`speaker_segmentation_models` :479, `embedding2models` :484-499), local
model discovery with a 60 s TTL cache (legacy model.py:659-677), and a
resolution ladder that prefers local files and degrades to defaults
(model.py:237-426). Downloading is gated: there is no egress, so
`download_models` records what *would* be fetched and the converter
(models/convert.py) ingests checkpoints placed locally.
"""

from __future__ import annotations

import logging
import os
import time

logger = logging.getLogger(__name__)

MODELS_DIR = "models"

# catalog of supported upstream checkpoints (conversion targets)
SEGMENTATION_MODELS = [
    "pyannote-segmentation-3.0",
    "revai-reverb-diarization-v1",
]

EMBEDDING_MODELS = {
    "3dspeaker": ["eres2net-sv", "campplus-sv"],
    "nemo": ["titanet-large", "titanet-small"],
    "wespeaker": ["resnet-ecapa", "campplus-voxceleb"],
}

WHISPER_DEFAULT = "large-v3-turbo"
SEGMENTATION_DEFAULT = SEGMENTATION_MODELS[0]
EMBEDDING_DEFAULT = "eres2net-sv"


def speaker_segmentation_models() -> list[str]:
    return list(SEGMENTATION_MODELS)


def embedding2models() -> dict[str, list[str]]:
    return {k: list(v) for k, v in EMBEDDING_MODELS.items()}


_scan_cache: dict = {}
_SCAN_TTL_S = 60.0  # legacy model.py:659-677


def _scan_local(suffixes: tuple, key: str, models_dir: str) -> list[str]:
    now = time.time()
    key = (key, models_dir)
    if key in _scan_cache and now - _scan_cache[key][0] < _SCAN_TTL_S:
        return _scan_cache[key][1]
    found = []
    if os.path.isdir(models_dir):
        for name in sorted(os.listdir(models_dir)):
            if name.endswith(suffixes) or os.path.isdir(
                os.path.join(models_dir, name)
            ):
                found.append(name)
    _scan_cache[key] = (now, found)
    return found


def get_local_segmentation_models(models_dir: str = MODELS_DIR) -> list[str]:
    return [m for m in _scan_local((".npz", ".onnx", ".tar.bz2"), "seg", models_dir)
            if "seg" in m.lower() or "pyannote" in m.lower()
            or "reverb" in m.lower()]


def get_local_embedding_models(models_dir: str = MODELS_DIR) -> list[str]:
    return [m for m in _scan_local((".npz", ".onnx"), "emb", models_dir)
            if any(t in m.lower() for t in
                   ("eres2net", "campplus", "titanet", "ecapa", "embed"))]


def resolve_model_path(name: str, kind: str = "whisper",
                       models_dir: str | None = None) -> str | None:
    """Local resolution ladder (model.py:237-252 semantics): exact path →
    models/<name> dir → models/<kind>-<name>.npz → None."""
    base = models_dir or MODELS_DIR
    candidates = [
        name,
        os.path.join(base, name),
        os.path.join(base, f"{kind}-{name}"),
        os.path.join(base, f"{kind}-{name}.npz"),
        os.path.join(base, f"{name}.npz"),
    ]
    for c in candidates:
        if os.path.exists(c):
            return c
    return None


def download_models(names=None, models_dir: str = MODELS_DIR) -> dict:
    """Offline-gated downloader (reference: download_models.py + hub
    fallbacks in model.py:66-192). With no egress it reports the plan."""
    plan = {
        "whisper": [WHISPER_DEFAULT],
        "segmentation": list(SEGMENTATION_MODELS),
        "embedding": [m for v in EMBEDDING_MODELS.values() for m in v],
        "llm": ["llama-3.1-8b"],
    }
    if names:
        plan = {k: [n for n in v if n in names] for k, v in plan.items()}
    logger.warning(
        "no network egress in this environment — place HF snapshots under "
        "%s/ and they will be converted on first load", models_dir,
    )
    return plan


def check_models(models_dir: str = MODELS_DIR) -> dict:
    """Verify expected model files (reference check_models.py:18-25)."""
    expected = {
        "whisper": resolve_model_path(WHISPER_DEFAULT, "whisper", models_dir),
        "segmentation": resolve_model_path(SEGMENTATION_DEFAULT, "seg", models_dir),
        "embedding": resolve_model_path(EMBEDDING_DEFAULT, "emb", models_dir),
        "llm": resolve_model_path("llama-3.1-8b", "llm", models_dir),
    }
    return {k: {"path": v, "present": v is not None}
            for k, v in expected.items()}
