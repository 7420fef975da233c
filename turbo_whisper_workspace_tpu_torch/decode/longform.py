"""Port copy of turbo_whisper_workspace_tpu/decode/longform.py (numpy only;
the constants come from this package's ops/mel.py).

Long-form audio: chunk planning and stride-overlap segment merging.

The reference delegates long-form handling to the HF pipeline's
time-domain chunking (chunk_length_s=60, stride_length_s=5, batch 512 at
vocalis/core/audio_pipeline.py:351-358). TPU-native equivalent: fixed
30 s windows (Whisper's native receptive field) with symmetric stride
overlap, every window padded to identical shape so *all* windows of
*all* files in a job batch through one compiled encoder/decoder — the
chunk scheduler is host-side planning only, no device work.

Merging is timestamp-based: each window owns a "core" interval (its
extent minus the stride margins); decoded segments are kept iff their
midpoint falls inside the core, then shifted to absolute time. This is
deterministic, order-independent, and needs no token-level alignment.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..ops.mel import HOP_LENGTH, N_SAMPLES, SAMPLE_RATE


@dataclass(frozen=True)
class ChunkPlan:
    """One 30 s decode window within a longer waveform."""

    file_index: int       # which input file this window belongs to
    start: int            # sample offset of the window start
    core_start_s: float   # absolute seconds: merge keeps segments whose
    core_end_s: float     # midpoint ∈ [core_start_s, core_end_s)

    @property
    def start_s(self) -> float:
        return self.start / SAMPLE_RATE


def plan_chunks(
    n_samples: int,
    file_index: int = 0,
    chunk_s: float = 30.0,
    stride_s: float = 5.0,
) -> list[ChunkPlan]:
    """Window layout for one waveform.

    Windows advance by chunk - 2*stride; the first window's core starts
    at 0 and the last window's core runs to the end (reference stride
    semantics: stride_length_s=5 on both sides except the edges).
    """
    chunk = int(chunk_s * SAMPLE_RATE)
    stride = int(stride_s * SAMPLE_RATE)
    if n_samples <= chunk:
        end_s = n_samples / SAMPLE_RATE
        return [ChunkPlan(file_index, 0, 0.0, max(end_s, 1e-6))]
    step = chunk - 2 * stride
    assert step > 0, "stride too large for chunk size"
    n_chunks = 1 + math.ceil((n_samples - chunk) / step)
    starts = [min(i * step, max(n_samples - chunk, 0)) for i in range(n_chunks)]
    # core boundaries partition [0, end]: window i owns
    # [b_i, b_{i+1}) with b_i = start_i + stride (b_0 = 0, b_n = end).
    # Using the *actual* (possibly clamped) starts keeps the partition
    # valid when the final window is shifted back to fit.
    bounds = (
        [0.0]
        + [s / SAMPLE_RATE + stride_s for s in starts[1:]]
        + [n_samples / SAMPLE_RATE]
    )
    return [
        ChunkPlan(file_index, starts[i], bounds[i], bounds[i + 1])
        for i in range(n_chunks)
    ]


def gate_plans_by_vad(
    plans: list[ChunkPlan],
    speech_mask: np.ndarray,
    frame_hz: float = 10.0,
    chunk_s: float = 30.0,
) -> list[ChunkPlan]:
    """Drop windows whose span contains no speech frames (BASELINE
    config #2's 'batched greedy + VAD chunking'; the reference gets VAD
    only as a post-hoc no-speech filter via the HF pipeline, while its
    diagnostics VAD is never wired to the decode plan —
    audio_diagnostics.py:109-111).

    Keeps at least one window per file so every file yields a result
    row, and never drops the plan partition's integrity: a dropped
    window's core interval is silent, so no segments are lost.
    """
    if len(plans) <= 1:
        return plans
    kept = []
    n = len(speech_mask)
    for p in plans:
        f0 = int(p.start_s * frame_hz)
        f1 = min(int((p.start_s + chunk_s) * frame_hz), n)
        if f1 <= f0 or speech_mask[f0:f1].any():
            kept.append(p)
    return kept or plans[:1]


def slice_chunk(
    audio: np.ndarray, plan: ChunkPlan, n_samples: int = N_SAMPLES
) -> np.ndarray:
    """Extract + zero-pad one window to exactly n_samples (default 30 s)."""
    seg = audio[plan.start : plan.start + n_samples]
    if seg.shape[0] < n_samples:
        seg = np.pad(seg, (0, n_samples - seg.shape[0]))
    return seg.astype(np.float32)


def merge_chunk_segments(
    chunk_segments: list[list[dict]],
    plans: list[ChunkPlan],
    duration_s: float | None = None,
) -> list[dict]:
    """Per-window segments (relative times) → absolute, de-overlapped list.

    chunk_segments[i] are dicts {"start","end","text"} relative to
    window i. A segment is owned by the window whose core contains its
    midpoint, which de-duplicates the stride overlap regions.
    """
    merged: list[dict] = []
    for segs, plan in zip(chunk_segments, plans):
        for s in segs:
            start = plan.start_s + s["start"]
            end = plan.start_s + (s["end"] if s["end"] is not None else 30.0)
            if duration_s is not None:
                # clamp before the ownership test: zero-padded tails of a
                # short final window must not push segments out of core
                end = min(end, duration_s)
                start = min(start, end)
            mid = 0.5 * (start + end)
            if plan.core_start_s <= mid < plan.core_end_s:
                merged.append({**s, "start": start, "end": end})
    merged.sort(key=lambda s: (s["start"], s["end"]))
    return merged


def segments_to_result(segments: list[dict], duration_s: float) -> dict:
    """Reference output schema: {"text", "chunks": [{"timestamp", "text"}]}
    matching examples/Test1/output.json (chunk-level timestamps + text)."""
    return {
        "text": "".join(s.get("text", "") for s in segments),
        "chunks": [
            {"timestamp": [s["start"], s["end"]], "text": s.get("text", "")}
            for s in segments
        ],
        "duration": duration_s,
    }
