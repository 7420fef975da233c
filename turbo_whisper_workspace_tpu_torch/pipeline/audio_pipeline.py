"""End-to-end audio pipeline: transcribe → diarize → merge → enrich.

Port of turbo_whisper_workspace_tpu/pipeline/audio_pipeline.py. Public
surface and result schema are the JAX package's:

    AudioProcessingPipeline.process_audio(audio_path, task,
        segmentation_model, embedding_model, num_speakers, threshold)
    → {"audio_path", "text", "segments", "chunks", "language",
       "diarization_segments", "merged_segments", "duration",
       "processing_times"[, "speaker_names", "summary", "topics"]}

plus the stage methods (transcribe, diarize, identify_speaker_names,
generate_summary, extract_topics), `process_batch` (all files' windows
share the transcriber's batches, all files' segmentation windows and
embedding crops the diarizer's), and the module-level `get_pipeline`
cache. Its key is (model, beam size, device): the JAX key plus the
device, so a CPU pipeline is never handed to a CUDA caller.

Spans (`utils/profiling.py`): `pipeline.transcribe` over a single-file
request, `audio.read` over each file's read and decode, and `llm.stage`
over each enrichment stage (names, summary or topics), the outermost
span of an LLM call.

The Whisper model runs in bf16, as the JAX pipeline loads it. Weights
come from `<models_dir>/whisper-<name>.npz` (the JAX package's
checkpoint format) or the HF snapshot directory `<models_dir>/whisper-<name>/`
when present; otherwise from a random init seeded with 0, which is
functional but untrained. Diarization models resolve by name under
`models_dir` (SpeakerDiarizer.from_names), else the weight-free tier.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Sequence

import torch

from ..audio import io as audio_io
from ..config import PipelineConfig
from ..llm import llm_helper
from ..models import convert
from ..models import whisper as wm
from ..utils import profiling
from .diarizer import SpeakerDiarizer
from .transcriber import Transcriber, load_transcriber, resolve_device

logger = logging.getLogger(__name__)

INIT_SEED = 0

_PIPELINE_CACHE: dict = {}


def _read_audio(path: str):
    """`audio_io.read_audio_file`'s samples, under the span `audio.read`."""
    with profiling.span("audio.read"):
        audio, _ = audio_io.read_audio_file(path)
    return audio


def get_pipeline(config: PipelineConfig | None = None,
                 device: torch.device | str = "cuda") -> "AudioProcessingPipeline":
    """Module-level cache keyed on the transcription model, its beam
    size and the device (reference _PIPELINE_CACHE semantics)."""
    config = config or PipelineConfig()
    device = resolve_device(device)
    key = (config.transcription.model, config.transcription.beam_size, str(device))
    if key not in _PIPELINE_CACHE:
        _PIPELINE_CACHE[key] = AudioProcessingPipeline(config, device=device)
    return _PIPELINE_CACHE[key]


class AudioProcessingPipeline:
    """Lazy-loading pipeline; an injected transcriber or diarizer
    (tests) wins. Runs on CUDA unless `device="cpu"` is passed."""

    def __init__(
        self,
        config: PipelineConfig | None = None,
        transcriber: Transcriber | None = None,
        diarizer: SpeakerDiarizer | None = None,
        device: torch.device | str = "cuda",
    ):
        self.config = config or PipelineConfig()
        self.device = resolve_device(device)
        self._transcriber = transcriber
        self._diarizer = diarizer
        self._diarizer_cache: dict = {}

    def load_transcription_model(self) -> Transcriber:
        """Whisper weights from a local checkpoint when present, in the
        JAX pipeline's order: `<models_dir>/whisper-<name>.npz`, then the
        HF snapshot directory `<models_dir>/whisper-<name>/` (whose
        `config.json` gives the dims, so its name need not be in
        WHISPER_CONFIGS); random init otherwise."""
        if self._transcriber is not None:
            return self._transcriber
        name = self.config.transcription.model
        dims = wm.WHISPER_CONFIGS.get(name)
        model = None
        npz = os.path.join(self.config.models_dir, f"whisper-{name}.npz")
        snapshot = os.path.join(self.config.models_dir, f"whisper-{name}")
        for cand in (npz, snapshot):
            try:
                if cand == npz and dims is not None and os.path.exists(cand):
                    model = convert.from_jax_params(
                        convert.load_params(cand), dims, dtype=torch.bfloat16,
                        device=self.device)
                    break
                if cand == snapshot and os.path.isdir(cand):
                    model, dims = convert.load_hf_snapshot(
                        cand, dtype=torch.bfloat16, device=self.device)
                    break
            except (OSError, KeyError, RuntimeError, ValueError) as e:
                logger.warning("checkpoint load failed from %s: %s", cand, e)
        if model is None:
            if dims is None:
                raise ValueError(f"unknown whisper model {name!r}")
            logger.warning("no local weights for %s — random init (untrained)", name)
            generator = torch.Generator(self.device).manual_seed(INIT_SEED)
            model = wm.init_params(dims, generator, dtype=torch.bfloat16,
                                   device=self.device)
        self._transcriber = load_transcriber(
            model, self.config.transcription,
            vocab_dir=os.path.join(self.config.models_dir, "tokenizer"),
            device=self.device,
        )
        return self._transcriber

    def load_diarizer(
        self,
        segmentation_model: str | None = None,
        embedding_model: str | None = None,
    ) -> SpeakerDiarizer:
        """Diarizer for the requested model pair on the pipeline's device,
        cached per (seg, emb). An injected diarizer wins when no names are
        asked for, or when the names match what it was built for."""
        if self._diarizer is not None and segmentation_model is None \
                and embedding_model is None:
            return self._diarizer
        cfg = self.config.diarization
        seg = segmentation_model or cfg.segmentation_model
        emb = embedding_model or cfg.embedding_model
        if self._diarizer is not None:
            if (getattr(self._diarizer, "segmentation_model", seg) == seg
                    and getattr(self._diarizer, "embedding_model", emb) == emb):
                return self._diarizer
        key = (seg, emb)
        if key not in self._diarizer_cache:
            self._diarizer_cache[key] = SpeakerDiarizer.from_names(
                cfg, segmentation_model=seg, embedding_model=emb,
                models_dir=self.config.models_dir, device=self.device,
            )
        return self._diarizer_cache[key]

    @staticmethod
    def get_device_memory_info(device: torch.device | str = "cuda") -> dict:
        """{"device", "platform", "bytes_in_use", "bytes_limit"} of the
        device: "gpu" with the bytes PyTorch holds there and the card's
        total, or "cpu" with no byte counts."""
        device = resolve_device(device)
        if device.type != "cuda":
            return {"device": str(device), "platform": "cpu",
                    "bytes_in_use": None, "bytes_limit": None}
        return {"device": f"{device} ({torch.cuda.get_device_name(device)})",
                "platform": "gpu",
                "bytes_in_use": torch.cuda.memory_allocated(device),
                "bytes_limit": torch.cuda.mem_get_info(device)[1]}

    def transcribe(self, audio_path: str, task: str | None = None,
                   initial_prompt: str | None = None) -> dict:
        """Single-file ASR: {"text", "chunks", "segments", "language",
        "duration", "processing_times"}. initial_prompt → <|startofprev|>
        conditioning; task ("transcribe" or "translate") reaches the
        prompt's task token (None: the transcription config's task)."""
        with profiling.span("pipeline.transcribe"):
            t = self.load_transcription_model()
            audio = _read_audio(audio_path)
            return t.transcribe([audio], initial_prompt=initial_prompt, task=task)[0]

    def diarize(self, audio_path: str, num_speakers: int = 2,
                threshold: float | None = None,
                segmentation_model: str | None = None,
                embedding_model: str | None = None) -> list[dict]:
        """Speaker turns (vocalis/core/audio_pipeline.py:371-430);
        num_speakers=0 → auto-estimate (`:393-397`)."""
        d = self.load_diarizer(segmentation_model=segmentation_model,
                               embedding_model=embedding_model)
        audio = _read_audio(audio_path)
        if num_speakers == 0:
            num_speakers = d.estimate_num_speakers(audio)
        segs = d.process_audio(audio, num_speakers=num_speakers,
                               threshold=threshold)
        return [s.to_dict() for s in segs]

    # -- LLM enrichment: the LLM is loaded on the pipeline's device (an
    # injected one, llm_helper.set_llm, wins)
    def identify_speaker_names(self, merged_segments) -> dict:
        with profiling.span("llm.stage"):
            return llm_helper.identify_speaker_names(
                merged_segments, llm=llm_helper.get_llm(self.config.llm, self.device),
                config=self.config.llm)

    def generate_summary(self, merged_segments) -> str:
        with profiling.span("llm.stage"):
            return llm_helper.summarize_conversation(
                merged_segments, llm=llm_helper.get_llm(self.config.llm, self.device),
                config=self.config.llm)

    def extract_topics(self, merged_segments) -> list[str]:
        with profiling.span("llm.stage"):
            return llm_helper.extract_topics(
                merged_segments, llm=llm_helper.get_llm(self.config.llm, self.device),
                config=self.config.llm)

    # -- master flow ------------------------------------------------------
    def process_audio(
        self,
        audio_path: str,
        task: str | None = None,
        segmentation_model: str | None = None,
        embedding_model: str | None = None,
        num_speakers: int = 2,
        threshold: float = 0.5,
        enrich: bool | None = None,
        initial_prompt: str | None = None,
    ) -> dict:
        """The six-step master flow (vocalis/core/audio_pipeline.py:567-688)."""
        return self.process_batch(
            [audio_path], task=task, num_speakers=num_speakers,
            threshold=threshold, enrich=enrich, initial_prompt=initial_prompt,
            segmentation_model=segmentation_model,
            embedding_model=embedding_model,
        )[0]

    def process_batch(
        self,
        audio_paths: Sequence[str],
        task: str | None = None,
        num_speakers: int = 2,
        threshold: float = 0.5,
        enrich: bool | None = None,
        initial_prompt: str | None = None,
        segmentation_model: str | None = None,
        embedding_model: str | None = None,
    ) -> list[dict]:
        """Batched master flow: all files' windows share the
        transcriber's batches, all files' diarization windows and crops
        the diarizer's; merge and enrichment run per file. `task`
        ("transcribe" or "translate"; None: the transcription config's)
        reaches the transcriber's prompt, as the original system passes
        it to its transcribe step; the JAX package accepts it and leaves
        the config's task to decide (a recorded deviation)."""
        enrich = self.config.llm.enabled if enrich is None else enrich
        times_total0 = time.time()

        audios = [_read_audio(p) for p in audio_paths]

        # 1) transcription (all files at once)
        t0 = time.time()
        transcriber = self.load_transcription_model()
        asr = transcriber.transcribe(audios, initial_prompt=initial_prompt, task=task)
        t_transcribe = time.time() - t0

        # 2) diarization: one batched call
        t0 = time.time()
        diarizer = self.load_diarizer(
            segmentation_model=segmentation_model,
            embedding_model=embedding_model,
        )
        diar_all = [
            [s.to_dict() for s in segs]
            for segs in diarizer.process_batch(
                audios, num_speakers=num_speakers, threshold=threshold
            )
        ]
        t_diarize = time.time() - t0

        # 3) merge + 4-6) enrich, per file
        out = []
        for path, audio, asr_res, diar in zip(audio_paths, audios, asr, diar_all):
            t0 = time.time()
            merged = SpeakerDiarizer.create_transcript_with_speakers(
                asr_res["segments"], diar
            )
            t_merge = time.time() - t0

            result = {
                "audio_path": path,
                "text": asr_res["text"],
                "segments": asr_res["segments"],
                "chunks": asr_res["chunks"],
                "language": asr_res.get("language"),
                "diarization_segments": diar,
                "merged_segments": merged,
                "duration": len(audio) / audio_io.TARGET_SR,
                "processing_times": {
                    "transcription": t_transcribe,
                    "diarization": t_diarize,
                    "merge": t_merge,
                },
            }

            if enrich and merged:
                t0 = time.time()
                names = self.identify_speaker_names(merged)
                if names:
                    result["speaker_names"] = names
                    for seg in merged:
                        if seg["speaker"] in names:
                            seg["speaker"] = names[seg["speaker"]]
                result["summary"] = self.generate_summary(merged)
                result["topics"] = self.extract_topics(merged)
                result["processing_times"]["llm"] = time.time() - t0

            result["processing_times"]["total"] = time.time() - times_total0
            out.append(result)
        return out
