"""Port copy of turbo_whisper_workspace_tpu/config.py, unchanged but for
one field: `TranscriptionConfig.cross_attention_s8`, the observable form
of the JAX package's trace-time `TWW_CROSS_S8=1` switch (the port routes
no kernel by environment variable).

Central configuration tree.

The reference scatters tuning constants across modules (chunking at
vocalis/core/audio_pipeline.py:349-358, LLM knobs at
vocalis/llm/llm_helper.py:67-73, diarization defaults at
vocalis/core/audio_pipeline.py:567-570). Here every knob lives in one
dataclass tree with the same defaults of record, overridable from CLI
flags and environment variables (reference env vars: LLM_MODEL at
vocalis/llm/llm_helper.py:40, HF_TOKEN via scripts/manage.sh:82-88).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any


@dataclass
class TranscriptionConfig:
    """ASR stage knobs (reference: vocalis/core/audio_pipeline.py:323-369)."""

    model: str = "large-v3-turbo"
    task: str = "transcribe"          # "transcribe" | "translate"
    language: str | None = None       # None = detect
    # Long-form chunking. The reference passes chunk_length_s=60 to the HF
    # pipeline (vocalis/core/audio_pipeline.py:351-358); Whisper's encoder
    # window is 30 s, so the effective window is 30 s — we chunk at the
    # native window size with the same 5 s stride overlap.
    chunk_length_s: float = 30.0
    stride_length_s: float = 5.0
    batch_size: int = 32              # utterances per device batch
    beam_size: int = 1                # 1 = greedy; reference beam retries 10/15
    return_timestamps: bool = True
    temperature: float = 0.0
    max_decode_len: int = 224         # max new tokens per 30 s window
    # Text conditioning: encoded as <|startofprev|> tokens before the SOT
    # sequence, mirroring the reference's retry ladder which passes
    # initial_prompt to the HF pipeline (dynamic_bar_audio.py:513-525).
    initial_prompt: str | None = None
    # VAD-gated chunk planning: all-silent 30 s windows are dropped from
    # the decode batch before batching (BASELINE config #2, "batched
    # greedy + VAD chunking"); at least one window per file survives
    vad_filter: bool = True
    dtype: str = "bfloat16"
    # int8 cross-attention K/V: halves the dominant decode-step HBM read
    # (-33% decode time measured); per-head symmetric quantization with
    # negligible logit error (tests/test_attention_kernel.py)
    quantize_cross_kv: bool = True
    # int8 self-attention KV cache for BEAM decode: the per-step beam
    # reorder of the cache is the largest beam cost; int8 payload +
    # per-(position, head) scales cut it 4.2x (profile_beam_ops.py)
    quantize_self_kv: bool = True
    # int8 cross-KV decoding through the s8×s8 cross-attention kernel
    # (query and softmax weights quantized per row to int8), the opt-in
    # route the JAX package takes with TWW_CROSS_S8=1 at trace time
    # (turbo_whisper_workspace_tpu/models/whisper.py:641-645); off by default
    cross_attention_s8: bool = False


@dataclass
class DiarizationConfig:
    """Diarization stage (reference: vocalis/core/model.py:432-475,
    vocalis/core/audio_pipeline.py:567-570)."""

    segmentation_model: str = "pyannote-segmentation-3.0"
    embedding_model: str = "eres2net-sv"
    num_speakers: int = 2             # 0 = auto-estimate
    clustering_threshold: float = 0.5
    min_duration_on: float = 0.3      # legacy model.py:510-515
    min_duration_off: float = 0.5
    window_s: float = 10.0            # segmentation sliding window
    step_s: float = 1.0
    max_speakers: int = 10            # auto-estimate cap (diar.py:172-176)
    # device-batch caps for the bucketed segmentation-window / embedding-
    # crop forwards (power-of-two bucketing keeps compiled shapes O(log))
    seg_batch: int = 128
    emb_batch: int = 128


@dataclass
class LLMConfig:
    """LLM enrichment stage (reference: vocalis/llm/llm_helper.py:30-108)."""

    model: str = field(
        default_factory=lambda: os.environ.get("LLM_MODEL", "llama-3.1-8b")
    )
    context_length: int = 4096        # n_ctx=4096 llm_helper.py:67-73
    max_tokens_names: int = 200       # llm_helper.py:470-475
    max_tokens_summary: int = 256     # llm_helper.py:646-651
    max_tokens_topics: int = 256
    temperature_names: float = 0.1
    temperature_summary: float = 0.3
    seed: int = 42                    # llm_helper.py:171-185
    max_segments: int = 20            # legacy cap audio_pipeline.py:575,603
    enabled: bool = True
    # weight quantization: 4 matches the reference's Q4_K_M GGUF serving
    # point (vocalis/llm/llm_helper.py:67-73) — grouped int4 body with an
    # int8 lm_head (ops/quant.py); 8 = int8 everywhere; 0 = bf16
    quantize_bits: int = 4


@dataclass
class MeshConfig:
    """Device mesh layout for SPMD execution (new capability; the reference
    is single-GPU, device="cuda:0" at vocalis/core/audio_pipeline.py:191)."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = -1           # -1 = all remaining devices
    model_parallel: int = 1


@dataclass
class SecurityConfig:
    """Security monitoring (reference: vocalis/security/security_monitor.py)."""

    min_threat_level: int = 2
    output_dir: str = "security_incidents"
    bar_specific: bool = False


@dataclass
class ServeConfig:
    """API/UI serving (reference: vocalis/api/main.py, vocalis/ui/app.py)."""

    host: str = "0.0.0.0"
    port: int = 8000
    ui_port: int = 7860


@dataclass
class PipelineConfig:
    """Top-level configuration for the full audio pipeline."""

    transcription: TranscriptionConfig = field(default_factory=TranscriptionConfig)
    diarization: DiarizationConfig = field(default_factory=DiarizationConfig)
    llm: LLMConfig = field(default_factory=LLMConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    security: SecurityConfig = field(default_factory=SecurityConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)
    models_dir: str = field(
        default_factory=lambda: os.environ.get("TWT_MODELS_DIR", "models")
    )

    def replace(self, **kwargs: Any) -> "PipelineConfig":
        return dataclasses.replace(self, **kwargs)


def default_config() -> PipelineConfig:
    return PipelineConfig()
