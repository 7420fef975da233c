"""Speaker diarization: segmentation → embeddings → clustering → turns,
plus the transcript merge that the whole workspace is built around.

Port of turbo_whisper_workspace_tpu/pipeline/diarizer.py. Every 10 s
window of every file batches through the segmentation module and every
2 s speech crop through the embedding module, in power-of-two buckets
of at most `seg_batch` / `emb_batch` rows padded with silence; audio
reaches the device as int16 PCM staged from pinned memory, as the
transcriber stages its windows. Only the O(turns²) clustering runs on
the host. With no trained checkpoint the weight-free tier takes over:
energy VAD and spectral-statistics embeddings (the spectrum reduced on
the device, standardised across each bucket on the host: the padding
rows and every file's crops included, as in the JAX package).

Clustering is average-linkage agglomerative clustering on cosine
distance, done on scipy as scikit-learn's `AgglomerativeClustering`
does it on unstructured data (scipy's tree, sklearn's `_hc_cut`, its
threshold count), so the labels equal sklearn's, which the JAX package
calls; the port needs no scikit-learn.

Reference semantics preserved:
* segment dict schema {"speaker": "Speaker N", "text", "start", "end"}
  (vocalis/core/diar.py:31-51);
* max-time-overlap speaker assignment with alternating-speaker fallback
  (vocalis/core/diar.py:199-247);
* auto speaker-count heuristic: ~1 speaker / 30 s, min 2, cap 10
  (vocalis/core/diar.py:172-176);
* min_duration_on=0.3 / min_duration_off=0.5 smoothing
  (legacy model.py:510-515);
* markdown conversation formatting (vocalis/core/diar.py:250-279).
"""

from __future__ import annotations

import heapq
import logging
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from ..config import DiarizationConfig
from ..models import embedding as emb_mod
from ..models import segmentation as seg_mod
from ..ops import mel as mel_ops
from .transcriber import resolve_device, stage_pcm

logger = logging.getLogger(__name__)

SR = mel_ops.SAMPLE_RATE
FRAME_HZ = 10.0                      # diarization frame rate
CROP_S = 2.0
CROP_STEP_S = 1.0


@dataclass
class DiarizationSegment:
    """Speaker turn; dict-style access kept for pipeline compatibility
    (vocalis/core/diar.py:41-51)."""

    start: float
    end: float
    speaker: str
    text: str = ""

    def to_dict(self) -> dict:
        return {"start": self.start, "end": self.end,
                "speaker": self.speaker, "text": self.text}

    def __getitem__(self, key):
        return self.to_dict()[key]

    @property
    def duration(self) -> float:
        return self.end - self.start


def energy_vad(audio: np.ndarray, frame_hz: float = FRAME_HZ,
               threshold_db: float = -40.0) -> np.ndarray:
    """Frame-level speech mask from log energy relative to peak
    (same approach as the reference's diagnostics VAD,
    audio_diagnostics.py:109-111)."""
    frame = int(SR / frame_hz)
    n = len(audio) // frame
    if n == 0:
        return np.zeros(0, bool)
    peak = float(np.abs(audio).max())
    if peak < 1e-6:  # digital silence: peak-relative dB is meaningless
        return np.zeros(n, bool)
    frames = audio[: n * frame].reshape(n, frame)
    rms = np.sqrt((frames**2).mean(-1) + 1e-12)
    db = 20 * np.log10(rms / peak + 1e-12)
    return db > threshold_db


def average_linkage_labels(x: np.ndarray, n_clusters: int | None = None,
                           distance_threshold: float | None = None) -> np.ndarray:
    """(n ≥ 2, d) → cluster labels of average-linkage agglomerative
    clustering on cosine distance, equal to scikit-learn's
    `AgglomerativeClustering(metric="cosine", linkage="average")` with
    `n_clusters` or `distance_threshold`: scipy's linkage tree, cut at
    k = n_clusters or k = #(merge heights ≥ threshold) + 1 clusters by
    splitting the highest-numbered node k − 1 times from the root, and
    labelled in the order of that cut's heap (sklearn's `_hc_cut`)."""
    from scipy.cluster import hierarchy

    n = len(x)
    tree = hierarchy.linkage(x, method="average", metric="cosine")
    children = tree[:, :2].astype(np.intp)
    if distance_threshold is not None:
        n_clusters = int(np.count_nonzero(tree[:, 2] >= distance_threshold)) + 1
    nodes = [-(int(children[-1].max()) + 1)]
    for _ in range(n_clusters - 1):
        left, right = children[-nodes[0] - n]
        heapq.heappush(nodes, -int(left))
        heapq.heappushpop(nodes, -int(right))
    labels = np.zeros(n, np.intp)
    for i, node in enumerate(nodes):
        stack = [-node]
        while stack:
            c = stack.pop()
            if c < n:
                labels[c] = i
            else:
                stack.extend(children[c - n])
    return labels


class SpeakerDiarizer:
    """Public API mirrors the reference SpeakerDiarizer
    (vocalis/core/diar.py:57-140): process_file / process_audio /
    estimate_num_speakers / create_transcript_with_speakers /
    format_as_conversation. `seg_params` / `emb_params` hold the port's
    Segmentation / Embedding modules, or None for the weight-free tier.
    Runs on CUDA unless `device="cpu"` is passed; the modules are moved
    to that device."""

    def __init__(
        self,
        config: DiarizationConfig | None = None,
        seg_params: seg_mod.Segmentation | None = None,
        seg_dims: seg_mod.SegmentationDims | None = None,
        emb_params: emb_mod.Embedding | None = None,
        emb_dims: emb_mod.EmbeddingDims | None = None,
        segmentation_model: str | None = None,
        embedding_model: str | None = None,
        device: torch.device | str = "cuda",
    ):
        self.config = config or DiarizationConfig()
        self.device = resolve_device(device)
        self.seg_params = seg_params.to(self.device) if seg_params is not None else None
        self.seg_dims = seg_dims or seg_mod.SegmentationDims()
        self.emb_params = emb_params.to(self.device) if emb_params is not None else None
        self.emb_dims = emb_dims or emb_mod.EmbeddingDims()
        # names of record (what /api/models advertises and requests select)
        self.segmentation_model = segmentation_model or self.config.segmentation_model
        self.embedding_model = embedding_model or self.config.embedding_model

    @classmethod
    def from_names(
        cls,
        config: DiarizationConfig | None = None,
        segmentation_model: str | None = None,
        embedding_model: str | None = None,
        models_dir: str = "models",
        device: torch.device | str = "cuda",
    ) -> "SpeakerDiarizer":
        """Build a diarizer for named segmentation/embedding models.

        Names resolve through the registry's local ladder to converted
        `.npz` checkpoints, loaded in bf16 with their dims from the
        checkpoint's `__meta__`; a name with no local checkpoint, or one
        that fails to load, degrades to the weight-free tier (energy VAD
        + spectral embedding), as the reference degrades on missing
        downloads (vocalis/core/model.py:257-426)."""
        from ..models import convert
        from ..utils import registry

        config = config or DiarizationConfig()
        seg_name = segmentation_model or config.segmentation_model
        emb_name = embedding_model or config.embedding_model
        device = resolve_device(device)

        def _load(name: str, kind: str, dims_cls, build):
            """(module, dims) from a converted .npz; dims fields come from
            the checkpoint's __meta__ so custom geometries round-trip."""
            path = registry.resolve_model_path(name, kind, models_dir=models_dir)
            if path is None or not path.endswith(".npz"):
                return None, None
            try:
                params = convert.load_params(path, dtype=torch.bfloat16)
                meta = convert.load_meta(path)
                dims = dims_cls(**meta) if meta else None
                return build(params, dims or dims_cls(), dtype=torch.bfloat16,
                             device=device), dims
            except Exception as e:  # degrade, never crash
                logger.warning("failed to load %s checkpoint %s: %s", kind, path, e)
                return None, None

        seg_params, seg_dims = _load(seg_name, "seg", seg_mod.SegmentationDims,
                                     convert.segmentation_from_jax_params)
        emb_params, emb_dims = _load(emb_name, "emb", emb_mod.EmbeddingDims,
                                     convert.embedding_from_jax_params)
        return cls(
            config,
            seg_params=seg_params,
            seg_dims=seg_dims,
            emb_params=emb_params,
            emb_dims=emb_dims,
            segmentation_model=seg_name,
            embedding_model=emb_name,
            device=device,
        )

    # -- bucketed device batches -------------------------------------------
    @staticmethod
    def _bucket_spans(n: int, max_batch: int):
        """Fixed power-of-two batch sizes (same discipline as the ASR
        window batching, transcriber.py): every device forward sees one
        of O(log max_batch) shapes regardless of file count or speech
        content."""
        bsz = min(max_batch, 1 << max(n - 1, 0).bit_length()) if n else 0
        return [(lo, min(lo + bsz, n), bsz) for lo in range(0, n, bsz)]

    @torch.no_grad()
    def _embed_crops(self, crops: np.ndarray) -> np.ndarray:
        """(N, crop_samples) waveform crops → (N, emb_dim) embeddings,
        mel + forward in power-of-two buckets padded with zero crops.
        Crops ship host→device as int16 PCM, every bucket's copy issued
        before the first forward so the copies overlap the compute, and
        only the embeddings (or the 80-float spectral specs of the
        fallback) come back."""
        staged = []
        for lo, hi, bsz in self._bucket_spans(len(crops), self.config.emb_batch):
            batch = crops[lo:hi]
            if hi - lo < bsz:
                batch = np.concatenate(
                    [batch, np.zeros((bsz - (hi - lo), crops.shape[1]), np.float32)]
                )
            staged.append((lo, hi, stage_pcm(batch, self.device)))
        out = []
        for lo, hi, pcm in staged:
            if self.emb_params is not None:
                mels = mel_ops.log_mel_spectrogram(
                    pcm, num_mels=80)[:, :, : self.emb_dims.crop_frames]
                embs = self.emb_params(mels).cpu().numpy()
            else:
                spec = emb_mod.spectral_spec_device(
                    pcm, crop_frames=self.emb_dims.crop_frames).cpu().numpy()
                embs = emb_mod.spectral_embedding_from_spec(spec)
            out.append(embs[: hi - lo])
        return np.concatenate(out) if out else np.zeros((0, 1), np.float32)

    # -- frame activity ---------------------------------------------------
    def _seg_window_starts(self, n_samples: int) -> list[int]:
        """Sliding-window starts (window_s / step_s, pyannote semantics —
        reference config at vocalis/core/model.py:432-475)."""
        win = int(self.config.window_s * SR)
        step = int(self.config.step_s * SR)
        return list(range(0, max(n_samples - win, 0) + 1, step))

    @torch.no_grad()
    def _frame_activity_batch(self, audios: Sequence[np.ndarray]) -> list[np.ndarray]:
        """Per-file (T_frames,) speech masks at FRAME_HZ.

        Neural path: ALL files' sliding segmentation windows flatten into
        power-of-two-bucketed device batches; overlapping windows vote by
        averaging per-frame any-speech probability (pyannote's overlap
        aggregation). Energy VAD otherwise (host-side)."""
        if self.seg_params is None:
            return [energy_vad(a) for a in audios]

        win = int(self.config.window_s * SR)
        frames_per_win = seg_mod.FRAMES_PER_WINDOW
        plans: list[tuple[int, int]] = []           # (file_index, start)
        for fi, a in enumerate(audios):
            plans.extend((fi, t) for t in self._seg_window_starts(len(a)))

        n = len(plans)
        totals = [int(len(a) / SR * FRAME_HZ) for a in audios]
        prob_sum = [np.zeros(t, np.float64) for t in totals]
        prob_cnt = [np.zeros(t, np.int32) for t in totals]
        staged = []
        for lo, hi, bsz in self._bucket_spans(n, self.config.seg_batch):
            windows = np.zeros((bsz, win), np.float32)
            for row, (fi, t) in enumerate(plans[lo:hi]):
                chunk = audios[fi][t : t + win]
                windows[row, : len(chunk)] = chunk
            staged.append((lo, hi, stage_pcm(windows, self.device)))
        for lo, hi, pcm in staged:
            mels = mel_ops.log_mel_spectrogram(
                pcm, num_mels=self.seg_dims.n_mels)[:, :, : self.seg_dims.window_frames]
            logits = self.seg_params(mels).cpu().numpy()
            speech_p = seg_mod.powerset_speech_prob(logits)  # (bsz, T_out)
            for row, (fi, t) in enumerate(plans[lo:hi]):
                f0 = int(t / SR * FRAME_HZ)
                f1 = min(f0 + frames_per_win, totals[fi])
                prob_sum[fi][f0:f1] += speech_p[row, : f1 - f0]
                prob_cnt[fi][f0:f1] += 1

        masks = []
        for fi in range(len(audios)):
            cnt = np.maximum(prob_cnt[fi], 1)
            masks.append((prob_sum[fi] / cnt) > 0.5)
        return masks

    # -- main -------------------------------------------------------------
    def _crop_starts(self, audio: np.ndarray, speech: np.ndarray) -> list[int]:
        """2 s crop starts (1 s step) over speech regions. Only
        mostly-speech crops embed cleanly; boundary crops that straddle
        silence (or two speakers) dilute the clusters."""
        crop = int(CROP_S * SR)
        step = int(CROP_STEP_S * SR)
        starts = []
        for t in range(0, max(len(audio) - crop, 0) + 1, step):
            f0, f1 = int(t / SR * FRAME_HZ), int((t + crop) / SR * FRAME_HZ)
            window_speech = speech[f0:max(f1, f0 + 1)]
            if window_speech.size and window_speech.mean() >= 0.6:
                starts.append(t)
        return starts

    def process_audio(self, audio: np.ndarray, num_speakers: int = 0,
                      threshold: float | None = None) -> list[DiarizationSegment]:
        """Waveform (16 kHz mono) → speaker turns."""
        return self.process_batch([audio], num_speakers=num_speakers,
                                  threshold=threshold)[0]

    def process_batch(
        self,
        audios: Sequence[np.ndarray],
        num_speakers: int = 0,
        threshold: float | None = None,
    ) -> list[list[DiarizationSegment]]:
        """Batched waveforms → per-file speaker turns.

        All files share the bucketed device batches: segmentation windows
        flatten across files in `_frame_activity_batch`, embedding crops
        flatten here. Clustering and turn assembly stay host-side (tiny,
        O(turns²))."""
        cfg = self.config
        threshold = threshold if threshold is not None else cfg.clustering_threshold
        masks = self._frame_activity_batch(audios)

        crop = int(CROP_S * SR)
        starts_per_file = [
            self._crop_starts(a, m) if m.any() else []
            for a, m in zip(audios, masks)
        ]
        all_crops = np.zeros((sum(map(len, starts_per_file)), crop), np.float32)
        row = 0
        for audio, starts in zip(audios, starts_per_file):
            for t in starts:
                chunk = audio[t : t + crop]
                all_crops[row, : len(chunk)] = chunk
                row += 1
        embs_all = self._embed_crops(all_crops)

        results: list[list[DiarizationSegment]] = []
        lo = 0
        for audio, speech, crop_starts in zip(audios, masks, starts_per_file):
            if not crop_starts:
                results.append([])
                continue
            embs = embs_all[lo : lo + len(crop_starts)]
            lo += len(crop_starts)
            n = num_speakers
            if n == 0:
                n = self.estimate_num_speakers(audio)
            labels = self._cluster(embs, n, threshold)

            # frame labels by covering-crop majority vote
            total_frames = len(speech)
            votes = np.full((total_frames, int(labels.max()) + 1), 0, np.int32)
            for t, lab in zip(crop_starts, labels):
                f0 = int(t / SR * FRAME_HZ)
                f1 = min(int((t + crop) / SR * FRAME_HZ), total_frames)
                votes[f0:f1, lab] += 1
            frame_label = np.where(
                (votes.sum(-1) > 0) & speech, votes.argmax(-1), -1
            )

            turns = self._smooth(self._frames_to_turns(frame_label))
            results.append([
                DiarizationSegment(start=s, end=e, speaker=f"Speaker {lab}")
                for s, e, lab in turns
            ])
        return results

    def process_file(self, path: str, num_speakers: int = 0,
                     threshold: float | None = None) -> list[DiarizationSegment]:
        from ..audio.io import read_audio_file

        audio, _ = read_audio_file(path)
        return self.process_audio(audio, num_speakers, threshold)

    # -- clustering -------------------------------------------------------
    def _cluster(self, embs: np.ndarray, num_speakers: int,
                 threshold: float) -> np.ndarray:
        n = len(embs)
        if n == 1:
            return np.zeros(1, np.int32)
        if num_speakers and num_speakers > 0:
            labels = average_linkage_labels(embs, n_clusters=min(num_speakers, n))
        else:
            labels = average_linkage_labels(embs, distance_threshold=threshold)
        # cap at max_speakers by merging smallest clusters into nearest
        uniq = np.unique(labels)
        if len(uniq) > self.config.max_speakers:
            sizes = np.array([(labels == u).sum() for u in uniq])
            keep = uniq[np.argsort(sizes)[::-1][: self.config.max_speakers]]
            keep_cent = np.stack([embs[labels == u].mean(0) for u in keep])
            for u in uniq:
                if u not in keep:
                    c = embs[labels == u].mean(0)
                    sims = keep_cent @ c
                    labels[labels == u] = keep[np.argmax(sims)]
        # relabel to dense 0..K-1 by first appearance
        remap = {}
        out = np.empty_like(labels)
        for i, l in enumerate(labels):
            if l not in remap:
                remap[l] = len(remap)
            out[i] = remap[l]
        return out

    # -- turn assembly ----------------------------------------------------
    @staticmethod
    def _frames_to_turns(frame_label: np.ndarray) -> list[tuple[float, float, int]]:
        turns = []
        cur, start = -1, 0
        for i, lab in enumerate(list(frame_label) + [-1]):
            if lab != cur:
                if cur >= 0:
                    turns.append((start / FRAME_HZ, i / FRAME_HZ, cur))
                cur, start = lab, i
        return turns

    def _smooth(self, turns: list[tuple[float, float, int]]):
        """min_duration_on / min_duration_off smoothing
        (legacy model.py:510-515 clustering config)."""
        cfg = self.config
        # fill short gaps between same-speaker turns
        filled: list[tuple[float, float, int]] = []
        for t in turns:
            if (filled and filled[-1][2] == t[2]
                    and t[0] - filled[-1][1] < cfg.min_duration_off):
                filled[-1] = (filled[-1][0], t[1], t[2])
            else:
                filled.append(t)
        # drop too-short turns
        return [t for t in filled if t[1] - t[0] >= cfg.min_duration_on]

    # -- auto speaker count ----------------------------------------------
    def estimate_num_speakers(self, audio: np.ndarray) -> int:
        """Duration heuristic: ~1 speaker per 30 s, min 2, cap max_speakers
        (vocalis/core/diar.py:172-176)."""
        duration = len(audio) / SR
        est = max(2, int(duration / 30.0))
        return min(est, self.config.max_speakers)

    # -- transcript merge -------------------------------------------------
    @staticmethod
    def create_transcript_with_speakers(
        transcript_segments: Sequence[dict],
        diar_segments: Sequence[DiarizationSegment | dict],
    ) -> list[dict]:
        """Assign each transcript segment the speaker with maximum time
        overlap (vocalis/core/diar.py:211-247); alternate speakers when
        diarization is empty (`:199-208`)."""
        out = []
        if not diar_segments:
            for i, seg in enumerate(transcript_segments):
                out.append({
                    "speaker": f"Speaker {i % 2}",
                    "text": seg.get("text", ""),
                    "start": seg.get("start", 0.0),
                    "end": seg.get("end", 0.0),
                })
            return out
        for seg in transcript_segments:
            s, e = seg.get("start", 0.0), seg.get("end", 0.0)
            best, best_overlap = None, 0.0
            for d in diar_segments:
                ds, de = d["start"], d["end"]
                overlap = max(0.0, min(e, de) - max(s, ds))
                if overlap > best_overlap:
                    best, best_overlap = d, overlap
            speaker = best["speaker"] if best is not None else "Speaker 0"
            out.append({"speaker": speaker, "text": seg.get("text", ""),
                        "start": s, "end": e})
        return out

    @staticmethod
    def format_as_conversation(merged_segments: Sequence[dict]) -> str:
        """Group consecutive same-speaker segments into markdown turns
        (vocalis/core/diar.py:250-279)."""
        lines = []
        cur_speaker, cur_text = None, []
        for seg in merged_segments:
            sp = seg.get("speaker", "Speaker 0")
            if sp != cur_speaker:
                if cur_speaker is not None:
                    lines.append(f"**{cur_speaker}**: {' '.join(cur_text).strip()}")
                cur_speaker, cur_text = sp, []
            cur_text.append(seg.get("text", "").strip())
        if cur_speaker is not None:
            lines.append(f"**{cur_speaker}**: {' '.join(cur_text).strip()}")
        return "\n\n".join(lines)
