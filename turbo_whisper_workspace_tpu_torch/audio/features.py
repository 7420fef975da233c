"""Audio feature extraction + segmentation utilities.

Port copy of turbo_whisper_workspace_tpu/audio/features.py (numpy; the
mel filter bank from this package's ops/mel.py, the chroma filter bank
from its analysis/visualizer.py).

Rebuilds utils/audio_processor.py: `extract_audio_features` (MFCC /
spectral / chroma summary stats, `:36-107`), `split_audio` (cut segments
by start/end, `:149-188`), `detect_silence` (STFT-energy VAD,
`:190-250`) — on numpy + our own mel/chroma filterbanks instead of
librosa.
"""

from __future__ import annotations

import numpy as np

from ..ops.mel import mel_filter_bank

SR = 16_000


def _power_spec(audio: np.ndarray, n_fft: int = 1024, hop: int = 512):
    n = max((len(audio) - n_fft) // hop + 1, 0)
    if n == 0:
        return np.zeros((n_fft // 2 + 1, 0), np.float32), hop
    idx = np.arange(n_fft)[None, :] + (np.arange(n) * hop)[:, None]
    spec = np.abs(np.fft.rfft(audio[idx] * np.hanning(n_fft), axis=1)) ** 2
    return spec.T.astype(np.float32), hop                     # (bins, T)


def mfcc(audio: np.ndarray, sr: int = SR, n_mfcc: int = 13,
         n_mels: int = 40) -> np.ndarray:
    """MFCC from scratch: power spectrum → mel → log → DCT-II ortho.
    Returns (n_mfcc, T)."""
    spec, _ = _power_spec(audio)
    fb = mel_filter_bank(n_mels, num_freqs=spec.shape[0], sample_rate=sr,
                         fmax=sr / 2)
    logmel = np.log(fb @ spec + 1e-10)                        # (n_mels, T)
    n = n_mels
    basis = np.cos(np.pi / n * (np.arange(n)[None, :] + 0.5)
                   * np.arange(n_mfcc)[:, None])
    basis *= np.sqrt(2.0 / n)
    basis[0] *= np.sqrt(0.5)
    return (basis @ logmel).astype(np.float32)


def extract_audio_features(audio: np.ndarray, sr: int = SR) -> dict:
    """Summary statistics of MFCC / spectral / chroma features
    (utils/audio_processor.py:36-107 schema)."""
    from ..analysis.visualizer import chroma_filterbank

    spec, _ = _power_spec(audio)
    freqs = np.linspace(0, sr / 2, spec.shape[0])
    p = spec + 1e-12
    centroid = (p * freqs[:, None]).sum(0) / p.sum(0)
    m = mfcc(audio, sr)
    chroma = chroma_filterbank(spec.shape[0], sr, 1024) @ spec
    chroma = chroma / (chroma.max(0, keepdims=True) + 1e-9)
    zcr = (np.abs(np.diff(np.sign(audio))) > 0).mean() if len(audio) > 1 else 0.0
    return {
        "mfcc_mean": m.mean(1).tolist(),
        "mfcc_std": m.std(1).tolist(),
        "spectral_centroid_mean": float(centroid.mean()),
        "spectral_centroid_std": float(centroid.std()),
        "chroma_mean": chroma.mean(1).tolist(),
        "zero_crossing_rate": float(zcr),
        "rms": float(np.sqrt((audio**2).mean())) if audio.size else 0.0,
        "duration": len(audio) / sr,
    }


def split_audio(audio: np.ndarray, segments, sr: int = SR) -> list[np.ndarray]:
    """Cut [{"start","end"}] second-ranges into waveform pieces
    (utils/audio_processor.py:149-188)."""
    out = []
    for seg in segments:
        i0 = max(int(seg["start"] * sr), 0)
        i1 = min(int(seg["end"] * sr), len(audio))
        out.append(audio[i0:i1])
    return out


def detect_silence(audio: np.ndarray, sr: int = SR,
                   threshold_db: float = -40.0,
                   min_silence_s: float = 0.3) -> list[dict]:
    """STFT-energy silence regions (utils/audio_processor.py:190-250).
    Returns [{"start","end"}] in seconds."""
    n_fft, hop = 1024, 512
    spec, _ = _power_spec(audio, n_fft, hop)
    if spec.shape[1] == 0:
        return []
    energy = spec.sum(0)
    db = 10 * np.log10(energy / (energy.max() + 1e-12) + 1e-12)
    silent = db < threshold_db
    out = []
    start = None
    times = (np.arange(len(silent)) * hop + n_fft // 2) / sr
    for i, s in enumerate(list(silent) + [False]):
        if s and start is None:
            start = times[min(i, len(times) - 1)]
        elif not s and start is not None:
            end = times[min(i, len(times) - 1)]
            if end - start >= min_silence_s:
                out.append({"start": float(start), "end": float(end)})
            start = None
    return out
