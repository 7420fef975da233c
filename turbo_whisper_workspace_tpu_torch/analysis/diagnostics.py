"""Audio diagnostics: levels, SNR, VAD methods, reports, strength sweeps.

Port copy of turbo_whisper_workspace_tpu/analysis/diagnostics.py
(numpy); the strength sweep runs this package's spectral_denoise on
`device` (CUDA unless the caller asks for the CPU).

Rebuilds audio_diagnostics.py (RMS/peak/SNR from bottom-5% frames
`:96-105`, energy-VAD speech% at −40 dB `:109-111`, text report with
recommendations `:154-190`) and speech_detection_diagnostic.py (three
VAD methods — energy ×1.5-mean, ZCR ×0.8-mean, combined — `:119-137`,
energy entropy `:108-115`, denoiser strength sweep `:213-340`).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

SR = 16_000
FRAME = 512
HOP = 256


def _frames(audio: np.ndarray, frame: int = FRAME, hop: int = HOP) -> np.ndarray:
    n = max((len(audio) - frame) // hop + 1, 0)
    if n == 0:
        return np.zeros((0, frame), np.float32)
    idx = np.arange(frame)[None, :] + (np.arange(n) * hop)[:, None]
    return audio[idx]


def frame_rms(audio: np.ndarray) -> np.ndarray:
    f = _frames(audio)
    return np.sqrt((f**2).mean(-1) + 1e-12)


def estimate_snr_db(audio: np.ndarray) -> float:
    """Noise floor = mean of the quietest 5% of frames
    (audio_diagnostics.py:96-105)."""
    rms = frame_rms(audio)
    if len(rms) < 4:
        return 0.0
    k = max(1, int(0.05 * len(rms)))
    noise = np.sort(rms)[:k].mean()
    signal = rms.mean()
    return float(20 * np.log10(signal / max(noise, 1e-9)))


def speech_percentage(audio: np.ndarray, threshold_db: float = -40.0) -> float:
    """Energy-VAD speech fraction (audio_diagnostics.py:109-111)."""
    rms = frame_rms(audio)
    if not len(rms):
        return 0.0
    db = 20 * np.log10(rms / (np.abs(audio).max() + 1e-9) + 1e-12)
    return float((db > threshold_db).mean())


# -- the three VAD methods (speech_detection_diagnostic.py:119-137) --------

def vad_energy(audio: np.ndarray) -> np.ndarray:
    rms = frame_rms(audio)
    return rms > 1.5 * rms.mean() if len(rms) else rms.astype(bool)


def vad_zcr(audio: np.ndarray) -> np.ndarray:
    f = _frames(audio)
    if not len(f):
        return np.zeros(0, bool)
    zcr = (np.abs(np.diff(np.sign(f), axis=1)) > 0).mean(-1)
    return zcr < 0.8 * zcr.mean()   # voiced speech has LOW zcr vs noise


def vad_combined(audio: np.ndarray) -> np.ndarray:
    e, z = vad_energy(audio), vad_zcr(audio)
    n = min(len(e), len(z))
    return e[:n] & z[:n]


def energy_entropy(audio: np.ndarray, n_blocks: int = 10) -> float:
    """Entropy of per-frame energy distribution
    (speech_detection_diagnostic.py:108-115). Low entropy ⇒ bursty
    (speech-like), high ⇒ stationary noise."""
    rms = frame_rms(audio)
    if len(rms) < n_blocks:
        return 0.0
    e = rms**2
    p = e / (e.sum() + 1e-12)
    return float(-(p * np.log2(p + 1e-12)).sum() / np.log2(len(p)))


@dataclass
class DiagnosticReport:
    duration_s: float
    peak: float
    rms: float
    rms_db: float
    snr_db: float
    speech_pct: float
    entropy: float
    clipping_pct: float
    recommendations: list = field(default_factory=list)

    def __str__(self) -> str:
        lines = [
            "AUDIO DIAGNOSTIC REPORT",
            f"duration: {self.duration_s:.1f}s  peak: {self.peak:.3f}  "
            f"rms: {self.rms_db:.1f} dBFS",
            f"snr: {self.snr_db:.1f} dB  speech: {self.speech_pct * 100:.0f}%  "
            f"entropy: {self.entropy:.2f}  clipping: {self.clipping_pct * 100:.2f}%",
            "recommendations:",
        ]
        lines += [f"  - {r}" for r in (self.recommendations or ["none"])]
        return "\n".join(lines)


def diagnose(audio: np.ndarray, sr: int = SR) -> DiagnosticReport:
    """Level/SNR/VAD analysis + recommendations
    (audio_diagnostics.py:154-190)."""
    audio = np.asarray(audio, np.float32)
    peak = float(np.abs(audio).max()) if audio.size else 0.0
    rms = float(np.sqrt((audio**2).mean())) if audio.size else 0.0
    rms_db = 20 * np.log10(max(rms, 1e-9))
    rep = DiagnosticReport(
        duration_s=len(audio) / sr,
        peak=peak,
        rms=rms,
        rms_db=rms_db,
        snr_db=estimate_snr_db(audio),
        speech_pct=speech_percentage(audio),
        entropy=energy_entropy(audio),
        clipping_pct=float((np.abs(audio) > 0.999).mean()) if audio.size else 0.0,
    )
    if rep.rms_db < -30:
        rep.recommendations.append(
            "very low level — apply RMS normalization (target −16 dB)"
        )
    if rep.clipping_pct > 0.001:
        rep.recommendations.append("clipping detected — reduce input gain")
    if rep.snr_db < 10:
        rep.recommendations.append(
            "low SNR — enable spectral denoising before transcription"
        )
    if rep.speech_pct < 0.1:
        rep.recommendations.append(
            "little speech detected — verify the recording or VAD threshold"
        )
    return rep


def denoise_strength_sweep(audio: np.ndarray,
                           strengths=(0.0, 0.1, 0.2, 0.3, 0.5, 0.7, 1.0),
                           device="cuda"):
    """Pick the denoiser strength maximizing detected speech
    (speech_detection_diagnostic.py:213-340)."""
    from .preprocess import spectral_denoise

    results = []
    for s in strengths:
        out = spectral_denoise(audio, strength=s, device=device) if s > 0 else audio
        results.append({"strength": s, "speech_pct": speech_percentage(out)})
    best = max(results, key=lambda r: r["speech_pct"])
    return best["strength"], results
