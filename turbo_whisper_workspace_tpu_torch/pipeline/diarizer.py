"""Energy VAD used by the transcriber's window gating.

Part of a port of turbo_whisper_workspace_tpu/pipeline/diarizer.py: only
`energy_vad`, `FRAME_HZ` and `SR`, which the transcriber's VAD gating
needs. The diarizer itself (segmentation, embeddings, clustering) is a
later slice.
"""

from __future__ import annotations

import numpy as np

from ..ops import mel as mel_ops

SR = mel_ops.SAMPLE_RATE
FRAME_HZ = 10.0                      # diarization frame rate


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
