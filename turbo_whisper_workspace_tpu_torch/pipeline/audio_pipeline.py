"""Pipeline entry: single-file transcription and the LLM enrichment stages.

Part of a port of turbo_whisper_workspace_tpu/pipeline/audio_pipeline.py:
`AudioProcessingPipeline.__init__`, `load_transcription_model`,
`transcribe`, and the LLM enrichment stages `identify_speaker_names`,
`generate_summary` and `extract_topics`, which take the merged
{"speaker", "text", ...} segments. Diarization and `process_audio` /
`process_batch` are later slices.

The model runs in bf16, as the JAX pipeline loads it. Weights come from
`<models_dir>/whisper-<name>.npz` (the JAX package's checkpoint format)
or the HF snapshot directory `<models_dir>/whisper-<name>/` when present;
otherwise from a random init seeded with 0, which is functional but
untrained.
"""

from __future__ import annotations

import logging
import os

import torch

from ..audio import io as audio_io
from ..config import PipelineConfig
from ..llm import llm_helper
from ..models import convert
from ..models import whisper as wm
from .transcriber import Transcriber, load_transcriber, resolve_device

logger = logging.getLogger(__name__)

INIT_SEED = 0


class AudioProcessingPipeline:
    """Lazy-loading pipeline; an injected transcriber (tests) wins.
    Runs on CUDA unless `device="cpu"` is passed."""

    def __init__(
        self,
        config: PipelineConfig | None = None,
        transcriber: Transcriber | None = None,
        device: torch.device | str = "cuda",
    ):
        self.config = config or PipelineConfig()
        self.device = resolve_device(device)
        self._transcriber = transcriber

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

    def transcribe(self, audio_path: str, task: str = "transcribe",
                   initial_prompt: str | None = None) -> dict:
        """Single-file ASR: {"text", "chunks", "segments", "language",
        "duration", "processing_times"}. initial_prompt → <|startofprev|>
        conditioning."""
        t = self.load_transcription_model()
        audio, _ = audio_io.read_audio_file(audio_path)
        return t.transcribe([audio], initial_prompt=initial_prompt)[0]

    # -- LLM enrichment: the LLM is loaded on the pipeline's device (an
    # injected one, llm_helper.set_llm, wins)
    def identify_speaker_names(self, merged_segments) -> dict:
        return llm_helper.identify_speaker_names(
            merged_segments, llm=llm_helper.get_llm(self.config.llm, self.device),
            config=self.config.llm)

    def generate_summary(self, merged_segments) -> str:
        return llm_helper.summarize_conversation(
            merged_segments, llm=llm_helper.get_llm(self.config.llm, self.device),
            config=self.config.llm)

    def extract_topics(self, merged_segments) -> list[str]:
        return llm_helper.extract_topics(
            merged_segments, llm=llm_helper.get_llm(self.config.llm, self.device),
            config=self.config.llm)
