"""Batched Whisper transcriber: files → 30 s windows → device batches.

Port of turbo_whisper_workspace_tpu/pipeline/transcriber.py. All
windows of all input files are flattened into batches whose size is the
next power of two ≥ the window count (capped at the configured batch
size), padded with silence; each batch is encoded once (mel → encoder →
cross-KV), the language read from that cross-KV with one decoder step,
and decoded greedily, or by beam search when `config.beam_size` > 1
(over the int8 lane self-KV cache when `config.quantize_self_kv`).
Windows that fail openai/whisper's quality thresholds are decoded again
greedily at rising temperatures from their gathered cross-KV rows,
without re-running the encoder. Results are merged back per file. With
`config.cross_attention_s8` every decoder call (language detection,
greedy, beam, retries) reads the int8 cross-KV through the s8×s8
cross-attention kernel; the model itself is not changed, so
transcribers with either setting may share one.

Audio reaches the device as int16 PCM (converted on the device in the
mel frontend), all batches' copies issued from pinned memory before the
compute loop so they overlap it. One deliberate deviation from the JAX
package: `_encode_windows` rescales only float arrays; an int16 array
passes as it is (the JAX copy rescales it as if it were float). A
second: `transcribe` takes a per-call `task`, which the SOT rows use
before `config.task` (the JAX copy has no such argument, so its
pipeline's `task` never reaches the prompt).

Spans (`utils/profiling.py`), under `transcriber.transcribe`
(`windows`): `transcriber.plan` (the chunk plans, the VAD gate, the
stack and the staged copies), `transcriber.encode` per batch,
`transcriber.detect`, and per temperature `transcriber.decode` and
`transcriber.postprocess` (the copy to the host, the text, the
thresholds and the gather for the retry), then `transcriber.merge`.
"""

from __future__ import annotations

import time
import zlib
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from ..config import TranscriptionConfig
from ..decode import beam as beam_mod
from ..decode import greedy as greedy_mod
from ..decode import longform
from ..decode.rules import DecodeRules
from ..decode.tokenizer import LANGUAGES, WhisperTokenizer
from ..models import whisper as wm
from ..ops import mel as mel_ops
from ..utils import profiling

LOGPROB_THRESHOLD = -1.0
COMPRESSION_RATIO_THRESHOLD = 2.4
NO_SPEECH_THRESHOLD = 0.6
FALLBACK_TEMPERATURES = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)


def compression_ratio(text: str) -> float:
    data = text.encode("utf-8")
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))


def resolve_device(device: torch.device | str = "cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks
    for the CPU. Raises when CUDA is asked for and there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return device


def stage_pcm(batch: np.ndarray, device: torch.device) -> torch.Tensor:
    """Float waveforms (B, N) → int16 PCM on its way to `device`: on CUDA
    copied from pinned memory without blocking, so the copies of later
    batches overlap the compute of earlier ones."""
    pcm = torch.from_numpy(np.clip(batch * 32768.0, -32768, 32767).astype(np.int16))
    if device.type == "cuda":
        pcm = pcm.pin_memory()
    return pcm.to(device, non_blocking=True)


def _gather_kv(cross_kv: dict, rows: np.ndarray) -> dict:
    """Gather batch rows (axis 1 of every (L, B, ...) leaf) of a
    precomputed cross-KV dict — temperature retries re-decode failed rows
    without re-running the encoder."""
    some = next(iter(cross_kv.values()))
    idx = torch.as_tensor(rows, dtype=torch.long, device=some.device)
    return {k: v.index_select(1, idx) for k, v in cross_kv.items()}


@dataclass
class Transcriber:
    model: wm.Whisper
    tokenizer: WhisperTokenizer
    config: TranscriptionConfig = field(default_factory=TranscriptionConfig)
    device: torch.device | str = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.model = self.model.to(self.device)
        self.dims = self.model.dims
        self.rules = DecodeRules(
            specials=self.tokenizer.specials,
            timestamps=self.config.return_timestamps,
        )

    # -- prompts ----------------------------------------------------------
    def _prompt_prefix(self, initial_prompt: str | None) -> list[int]:
        """<|startofprev|> + encoded prompt text, capped at half the text
        context (openai/whisper's prompt window) and so that prefix + SOT
        sequence + max_decode_len fits n_text_ctx. Conditioned on during
        prefill but never scored."""
        if not initial_prompt:
            return []
        sp = self.tokenizer.specials
        toks = self.tokenizer.encode(" " + initial_prompt.strip())
        cap = min(
            self.dims.n_text_ctx // 2 - 1,
            self.dims.n_text_ctx - self.config.max_decode_len - 8,
        )
        return [sp.sot_prev] + toks[-max(cap, 0):]

    def _prompt_row(
        self, language: str | None, prefix: list[int] | None = None,
        task: str | None = None,
    ) -> list[int]:
        return (prefix or []) + self.tokenizer.specials.sot_sequence(
            language=language or self.config.language or "en",
            task=task or self.config.task,
            timestamps=self.config.return_timestamps,
        )

    # -- one fixed-shape batch of windows ---------------------------------
    @torch.no_grad()
    def _encode_windows(self, audio_batch) -> dict:
        """Waveforms (B, N_SAMPLES) → cross-KV, encoded ONCE per batch
        (language detection and every temperature retry reuse it).
        Takes float or int16 numpy arrays, or an int16 tensor already
        on its way to the device."""
        if isinstance(audio_batch, np.ndarray):
            if not np.issubdtype(audio_batch.dtype, np.integer):
                audio_batch = np.clip(
                    audio_batch * 32768.0, -32768, 32767).astype(np.int16)
            audio_batch = torch.from_numpy(audio_batch)
        audio = audio_batch.to(self.device)
        mels = mel_ops.log_mel_spectrogram(audio, num_mels=self.dims.n_mels)
        feats = self.model.encoder(mels)
        return self.model.decoder.precompute_cross_kv(
            feats, quantize=self.config.quantize_cross_kv)

    def _decode_batch(
        self,
        cross_kv: dict,
        languages: Sequence[str | None],
        temperature: float = 0.0,
        beam_size: int | None = None,
        prefix: list[int] | None = None,
        task: str | None = None,
    ):
        beam_size = beam_size if beam_size is not None else self.config.beam_size
        prompt = torch.tensor(
            [self._prompt_row(l, prefix, task) for l in languages], dtype=torch.long,
            device=self.device)
        sot_index = len(prefix) if prefix else 0
        if beam_size > 1 and temperature == 0.0:
            res = beam_mod.beam_decode_features(
                self.model, cross_kv, prompt, rules=self.rules, beam_size=beam_size,
                max_len=self.config.max_decode_len, sot_index=sot_index,
                quantize_cache=self.config.quantize_self_kv,
                cross_s8=self.config.cross_attention_s8,
            )
            return res, prompt.shape[1]
        generator = None
        if temperature > 0:
            generator = torch.Generator(self.device).manual_seed(
                int(temperature * 1000) + 1)
        res = greedy_mod.greedy_decode_features(
            self.model, cross_kv, prompt, rules=self.rules,
            max_len=self.config.max_decode_len, temperature=float(temperature),
            generator=generator, sot_index=sot_index,
            cross_s8=self.config.cross_attention_s8,
        )
        return res, prompt.shape[1]

    # -- window postprocess ----------------------------------------------
    def _window_segments(self, sampled_tokens: np.ndarray) -> list[dict]:
        tk = self.tokenizer
        if self.config.return_timestamps:
            segs = tk.split_timestamps(sampled_tokens)
            for s in segs:
                s["text"] = tk.decode_text(s.pop("tokens"))
            return segs
        text = tk.decode_text(sampled_tokens)
        return [{"start": 0.0, "end": None, "text": text}] if text else []

    def _detect_language_rows(self, cross_kv: dict) -> list[str]:
        """Language ID for every row of an already-encoded batch (one
        decoder step on the cached cross-KV; the encoder is not re-run)."""
        sp = self.tokenizer.specials
        with profiling.span("transcriber.detect"):
            probs = greedy_mod.detect_language_features(
                self.model, cross_kv, sp.sot, sp.sot + 1, sp.n_languages,
                cross_s8=self.config.cross_attention_s8)
            return [LANGUAGES[int(i)] for i in probs.argmax(-1).tolist()]

    def detect_languages(self, first_windows: np.ndarray) -> list[str]:
        """Batched language ID on each file's first window."""
        sp = self.tokenizer.specials
        if not sp.multilingual:
            return ["en"] * len(first_windows)
        return self._detect_language_rows(self._encode_windows(first_windows))

    # -- public API -------------------------------------------------------
    def transcribe(
        self,
        audios: Sequence[np.ndarray],
        languages: Sequence[str] | None = None,
        initial_prompt: str | None = None,
        task: str | None = None,
    ) -> list[dict]:
        """Transcribe a list of waveforms (16 kHz mono float32).

        Returns one result dict per file: {"text", "chunks", "segments",
        "language", "duration", "processing_times"}. initial_prompt
        conditions the decoder via <|startofprev|> tokens; task
        ("transcribe" or "translate") picks the SOT sequence's task
        token, `config.task` when None.
        """
        t0 = time.time()
        cfg = self.config
        sp = self.tokenizer.specials
        prefix = self._prompt_prefix(
            initial_prompt if initial_prompt is not None else cfg.initial_prompt
        )
        with profiling.span("transcriber.transcribe") as call:
            with profiling.span("transcriber.plan"):
                plans: list[longform.ChunkPlan] = []
                for fi, audio in enumerate(audios):
                    f_plans = longform.plan_chunks(
                        len(audio), fi, chunk_s=cfg.chunk_length_s,
                        stride_s=cfg.stride_length_s,
                    )
                    if cfg.vad_filter and len(f_plans) > 1:
                        from .diarizer import FRAME_HZ, energy_vad

                        f_plans = longform.gate_plans_by_vad(
                            f_plans, energy_vad(audio), frame_hz=FRAME_HZ,
                            chunk_s=cfg.chunk_length_s,
                        )
                    plans.extend(f_plans)
                self.last_n_windows = len(plans)  # observability (tests/bench)
                windows = np.stack(
                    [longform.slice_chunk(audios[p.file_index], p) for p in plans]
                )
                n_win = len(plans)
                bsz = min(cfg.batch_size, 1 << (n_win - 1).bit_length() if n_win else 1)
                # start every batch's host→device copy (int16, pinned) before the
                # compute loop so the copies overlap the earlier batches' compute
                staged = []
                for lo in range(0, n_win, bsz):
                    hi = min(lo + bsz, n_win)
                    batch = windows[lo:hi]
                    if hi - lo < bsz:
                        pad = bsz - (hi - lo)
                        batch = np.concatenate(
                            [batch, np.zeros((pad, batch.shape[1]), np.float32)]
                        )
                    staged.append((lo, hi, stage_pcm(batch, self.device)))
            call.set(windows=n_win)

            # per-file language: pinned > detected from each batch's cross-KV
            detect = languages is None and cfg.language is None and sp.multilingual
            if languages is None:
                languages = ([cfg.language or "en"] * len(audios) if not detect
                             else [None] * len(audios))
            languages = list(languages)

            # first window index of each file (plans are file-major)
            first_win: dict[int, int] = {}
            for wi, p in enumerate(plans):
                first_win.setdefault(p.file_index, wi)

            window_results: list[dict | None] = [None] * n_win
            for lo, hi, pcm_dev in staged:
                with profiling.span("transcriber.encode"):
                    cross_kv = self._encode_windows(pcm_dev)
                if detect and any(
                    languages[plans[w].file_index] is None for w in range(lo, hi)
                ):
                    row_langs = self._detect_language_rows(cross_kv)
                    for w in range(lo, hi):
                        fi = plans[w].file_index
                        if languages[fi] is None and first_win[fi] == w:
                            languages[fi] = row_langs[w - lo]
                langs = [languages[plans[w].file_index] or "en"
                         for w in range(lo, hi)]
                langs += ["en"] * (bsz - (hi - lo))
                self._decode_windows_with_fallback(
                    cross_kv, langs, lo, hi, window_results, prefix=prefix, task=task
                )

            # merge windows per file
            with profiling.span("transcriber.merge"):
                out = []
                elapsed = time.time() - t0
                for fi, audio in enumerate(audios):
                    f_plans = [p for p in plans if p.file_index == fi]
                    f_idx = [i for i, p in enumerate(plans) if p.file_index == fi]
                    duration = len(audio) / mel_ops.SAMPLE_RATE
                    segs = longform.merge_chunk_segments(
                        [window_results[i]["segments"] for i in f_idx], f_plans, duration
                    )
                    result = longform.segments_to_result(segs, duration)
                    result["segments"] = segs
                    result["language"] = languages[fi]
                    result["processing_times"] = {"transcription": elapsed}
                    out.append(result)
        return out

    def _decode_windows_with_fallback(
        self, cross_kv, langs, lo, hi, window_results, prefix=None, task=None
    ) -> None:
        """Decode one fixed batch; re-decode failing rows at escalating
        temperatures (openai/whisper's fallback). The initial_prompt
        prefix rides every retry. Retries GATHER the already-encoded
        cross-KV rows instead of re-running mel+encoder."""
        bsz = len(langs)
        pending = np.arange(hi - lo)
        cur_kv, cur_langs = cross_kv, langs
        for t_i, temp in enumerate(FALLBACK_TEMPERATURES):
            with profiling.span("transcriber.decode"):
                res, p_len = self._decode_batch(
                    cur_kv, cur_langs, temperature=temp, prefix=prefix, task=task
                )
            with profiling.span("transcriber.postprocess"):
                tokens = res.tokens[:, p_len:].cpu().numpy()
                lengths = res.lengths.cpu().numpy()
                avg_lp = res.avg_logprobs.cpu().numpy()
                no_sp = res.no_speech_probs.cpu().numpy()

                still_failed = []
                for row, win_i in enumerate(pending):
                    sampled = tokens[row, : lengths[row]]
                    segs = self._window_segments(sampled)
                    text = "".join(s["text"] for s in segs)
                    silent = (
                        no_sp[row] > NO_SPEECH_THRESHOLD
                        and avg_lp[row] < LOGPROB_THRESHOLD
                    )
                    failed = (
                        not silent
                        and t_i < len(FALLBACK_TEMPERATURES) - 1
                        and (
                            avg_lp[row] < LOGPROB_THRESHOLD
                            or compression_ratio(text) > COMPRESSION_RATIO_THRESHOLD
                        )
                    )
                    if failed:
                        still_failed.append((row, win_i))
                        continue
                    window_results[lo + win_i] = {
                        "segments": [] if silent else segs,
                        "avg_logprob": float(avg_lp[row]),
                        "no_speech_prob": float(no_sp[row]),
                        "temperature": temp,
                    }
                if not still_failed:
                    return
                # keep the batch shape: the failed rows' cross-KV gathered to
                # the front, row 0 repeated as padding; row i of the next
                # decode is window pending[i]
                rows = np.array([r for r, _ in still_failed])
                gather_rows = np.zeros(bsz, np.int64)
                gather_rows[: len(rows)] = rows
                cur_langs = [cur_langs[r] for r in rows] + ["en"] * (
                    bsz - len(rows)
                )
                cur_kv = _gather_kv(cur_kv, gather_rows)
                pending = np.array([w for _, w in still_failed])


def load_transcriber(
    model: wm.Whisper, config: TranscriptionConfig | None = None,
    vocab_dir: str | None = None, device: torch.device | str = "cuda",
) -> Transcriber:
    tk = WhisperTokenizer.for_model(model.dims.n_vocab, vocab_dir)
    return Transcriber(model=model, tokenizer=tk,
                       config=config or TranscriptionConfig(), device=device)
