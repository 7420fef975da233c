"""Port copy of turbo_whisper_workspace_tpu/utils/metrics.py, unchanged.

Evaluation metrics: WER for ASR, DER for diarization.

The reference has no metric code (SURVEY.md §6: no published numbers);
BASELINE.md gates on ≤0.1 abs WER delta (LibriSpeech) and DER parity
(AMI), so the framework ships its own scorers:

* `wer` — word error rate via Levenshtein alignment, with Whisper-style
  English text normalization (lowercase, punctuation strip, whitespace
  collapse) so comparisons match openai/whisper's evaluation protocol;
* `der` — frame-based diarization error rate (missed speech + false
  alarm + speaker confusion over total reference speech) with optimal
  speaker mapping (Hungarian assignment) and an optional forgiveness
  collar around turn boundaries, the standard NIST formulation.
"""

from __future__ import annotations

import re

import numpy as np


def normalize_text(text: str) -> str:
    """Basic English normalization (whisper's EnglishTextNormalizer core):
    lowercase, strip punctuation/bracketed content, collapse spaces."""
    text = text.lower()
    text = re.sub(r"[\[\(][^\]\)]*[\]\)]", "", text)   # bracketed noise
    text = re.sub(r"[^\w\s']", " ", text)
    text = re.sub(r"\s+", " ", text)
    return text.strip()


def _levenshtein(ref: list, hyp: list) -> int:
    n, m = len(ref), len(hyp)
    if n == 0:
        return m
    prev = np.arange(m + 1)
    for i in range(1, n + 1):
        cur = np.empty(m + 1, dtype=np.int64)
        cur[0] = i
        for j in range(1, m + 1):
            cost = 0 if ref[i - 1] == hyp[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev = cur
    return int(prev[m])


def wer(reference: str, hypothesis: str, normalize: bool = True) -> float:
    """Word error rate (edits / reference words)."""
    edits, n_ref = wer_counts(reference, hypothesis, normalize)
    if n_ref == 0:
        return 0.0 if edits == 0 else 1.0
    return edits / n_ref


def wer_counts(reference: str, hypothesis: str,
               normalize: bool = True) -> tuple[int, int]:
    """(edit count, reference word count) — summable across a corpus so
    corpus WER = Σedits / Σref_words (the standard protocol), instead of
    an average of per-utterance rates."""
    if normalize:
        reference = normalize_text(reference)
        hypothesis = normalize_text(hypothesis)
    ref_words = reference.split()
    hyp_words = hypothesis.split()
    return _levenshtein(ref_words, hyp_words), len(ref_words)


def _frame_labels(segments, n_frames: int, frame_s: float,
                  collar_s: float = 0.0) -> tuple[np.ndarray, np.ndarray]:
    """segments → (speaker-id frame matrix (S, T) bool, scored-frame mask)."""
    speakers = []
    for s in segments:
        sp = s["speaker"] if isinstance(s, dict) else s.speaker
        if sp not in speakers:
            speakers.append(sp)
    act = np.zeros((max(len(speakers), 1), n_frames), bool)
    scored = np.ones(n_frames, bool)
    for s in segments:
        d = s if isinstance(s, dict) else s.to_dict()
        i0 = int(d["start"] / frame_s)
        i1 = min(int(np.ceil(d["end"] / frame_s)), n_frames)
        act[speakers.index(d["speaker"]), i0:i1] = True
        if collar_s > 0:
            c = int(collar_s / frame_s)
            scored[max(i0 - c, 0): min(i0 + c, n_frames)] = False
            scored[max(i1 - c, 0): min(i1 + c, n_frames)] = False
    return act, scored


def der(
    reference_segments,
    hypothesis_segments,
    duration_s: float,
    frame_s: float = 0.01,
    collar_s: float = 0.25,
) -> dict:
    """Diarization error rate with optimal speaker mapping.

    Returns {"der", "missed", "false_alarm", "confusion"} as fractions
    of total reference speech time.
    """
    from scipy.optimize import linear_sum_assignment

    n = int(np.ceil(duration_s / frame_s))
    ref, scored = _frame_labels(reference_segments, n, frame_s, collar_s)
    hyp, _ = _frame_labels(hypothesis_segments, n, frame_s, 0.0)

    ref = ref[:, scored]
    hyp = hyp[:, scored]
    ref_any = ref.any(0)
    hyp_any = hyp.any(0)

    # optimal ref↔hyp speaker mapping by overlap (Hungarian)
    overlap = (ref[:, None, :] & hyp[None, :, :]).sum(-1)  # (R, H)
    r_idx, h_idx = linear_sum_assignment(-overlap)
    correct = np.zeros(ref.shape[1], bool)
    for r, h in zip(r_idx, h_idx):
        correct |= ref[r] & hyp[h]

    total_speech = max(int(ref_any.sum()), 1)
    missed = int((ref_any & ~hyp_any).sum())
    false_alarm = int((~ref_any & hyp_any).sum())
    confusion = int((ref_any & hyp_any & ~correct).sum())
    return {
        "der": (missed + false_alarm + confusion) / total_speech,
        "missed": missed / total_speech,
        "false_alarm": false_alarm / total_speech,
        "confusion": confusion / total_speech,
    }
