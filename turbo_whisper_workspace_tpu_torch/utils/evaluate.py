"""Accuracy-gate runner: corpus WER / DER in one command.

Port of turbo_whisper_workspace_tpu/utils/evaluate.py, on this package's
metrics; its default pipeline is this package's `get_pipeline` on
`device` (CUDA unless the caller asks for the CPU).

BASELINE.md gates the framework on ≤0.1 absolute WER delta
(LibriSpeech) and DER parity (AMI) against the reference — but no
pretrained checkpoints are reachable offline, so the gates could never
run. This module makes them a one-command affair the day weights
arrive:

    python -m turbo_whisper_workspace_tpu_torch eval \
        --audio fixtures/ --ref transcripts/ [--rttm rttms/] [--device cpu]

* ASR: every audio file in --audio is transcribed through the full
  production pipeline; the matching ``<stem>.txt`` in --ref scores
  corpus WER (Σedits / Σref-words, Whisper-normalized).
* Diarization: matching ``<stem>.rttm`` files (NIST RTTM v1.3 SPEAKER
  lines — the AMI ground-truth format) score DER with the standard
  0.25 s collar and Hungarian speaker mapping.

The reference repo has no equivalent (SURVEY.md §6: no published
numbers); this is net-new gate tooling mandated by BASELINE.md.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Sequence

import torch

from . import metrics

logger = logging.getLogger(__name__)

_AUDIO_EXTS = (".flac", ".wav", ".mp3")


def parse_rttm(path: str) -> list[dict]:
    """NIST RTTM SPEAKER lines → [{"start", "end", "speaker"}].

    Format: SPEAKER <file> <chan> <tbeg> <tdur> <ortho> <stype> <name> …
    Non-SPEAKER lines and comments are skipped.
    """
    segs = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 8 or parts[0].upper() != "SPEAKER":
                continue
            tbeg, tdur = float(parts[3]), float(parts[4])
            segs.append({"start": tbeg, "end": tbeg + tdur,
                         "speaker": parts[7]})
    return segs


def _list_audio(audio_dir: str) -> list[str]:
    out = []
    for name in sorted(os.listdir(audio_dir)):
        if os.path.splitext(name)[1].lower() in _AUDIO_EXTS:
            out.append(os.path.join(audio_dir, name))
    return out


def evaluate_corpus(
    audio_dir: str,
    ref_dir: str | None = None,
    rttm_dir: str | None = None,
    pipeline=None,
    num_speakers: int = 0,
    collar_s: float = 0.25,
    results: Sequence[dict] | None = None,
    device: torch.device | str = "cuda",
) -> dict:
    """Run the production pipeline over a fixture directory and score it.

    ref_dir: directory of <stem>.txt reference transcripts (ASR gate).
    rttm_dir: directory of <stem>.rttm reference diarizations (DER gate).
    pipeline: injectable AudioProcessingPipeline (tests inject fakes at
    the same boundary the serving layer uses); default: get_pipeline on
    `device`.
    results: pre-computed process_batch outputs (skips inference; used
    when the caller already transcribed, e.g. the batch driver).
    """
    files = _list_audio(audio_dir)
    if not files:
        raise ValueError(f"no audio files in {audio_dir}")

    if results is None:
        if pipeline is None:
            from ..pipeline.audio_pipeline import get_pipeline

            pipeline = get_pipeline(device=device)
        results = pipeline.process_batch(
            files, num_speakers=num_speakers, enrich=False
        )

    report: dict = {"n_files": len(files), "files": {}}
    tot_edits = tot_words = 0
    ders, der_speech = [], []
    for path, res in zip(files, results):
        stem = os.path.splitext(os.path.basename(path))[0]
        entry: dict = {}

        if ref_dir is not None:
            txt = os.path.join(ref_dir, stem + ".txt")
            if os.path.exists(txt):
                with open(txt) as f:
                    ref_text = f.read()
                edits, n_ref = metrics.wer_counts(ref_text, res["text"])
                tot_edits += edits
                tot_words += n_ref
                entry["wer"] = round(edits / max(n_ref, 1), 4)
                entry["ref_words"] = n_ref
            else:
                logger.warning("no reference transcript for %s", stem)
                entry["wer"] = None

        if rttm_dir is not None:
            rttm = os.path.join(rttm_dir, stem + ".rttm")
            if os.path.exists(rttm):
                ref_segs = parse_rttm(rttm)
                d = metrics.der(
                    ref_segs, res["diarization_segments"],
                    duration_s=res["duration"], collar_s=collar_s,
                )
                speech = sum(s["end"] - s["start"] for s in ref_segs)
                ders.append(d)
                der_speech.append(max(speech, 1e-9))
                entry["der"] = round(d["der"], 4)
            else:
                logger.warning("no reference RTTM for %s", stem)
                entry["der"] = None

        report["files"][stem] = entry

    if ref_dir is not None:
        report["wer"] = round(tot_edits / max(tot_words, 1), 4)
        report["wer_ref_words"] = tot_words
    if rttm_dir is not None and ders:
        # speech-time-weighted corpus DER (NIST aggregation)
        w = sum(der_speech)
        for k in ("der", "missed", "false_alarm", "confusion"):
            report[k] = round(
                sum(d[k] * s for d, s in zip(ders, der_speech)) / w, 4
            )
    return report


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="WER/DER accuracy gates")
    p.add_argument("--audio", required=True, help="audio fixture dir")
    p.add_argument("--ref", default=None, help="dir of <stem>.txt transcripts")
    p.add_argument("--rttm", default=None, help="dir of <stem>.rttm files")
    p.add_argument("--model", default=None)
    p.add_argument("--num-speakers", type=int, default=0)
    p.add_argument("--collar", type=float, default=0.25)
    p.add_argument("--device", default="cuda",
                   help="torch device the models run on (default: cuda)")
    args = p.parse_args(argv)
    if not args.ref and not args.rttm:
        p.error("at least one of --ref / --rttm is required")

    pipeline = None
    if args.model:
        from ..config import PipelineConfig
        from ..pipeline.audio_pipeline import get_pipeline

        config = PipelineConfig()
        config.transcription.model = args.model
        pipeline = get_pipeline(config, device=args.device)
    report = evaluate_corpus(
        args.audio, ref_dir=args.ref, rttm_dir=args.rttm,
        pipeline=pipeline, num_speakers=args.num_speakers,
        collar_s=args.collar, device=args.device,
    )
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
