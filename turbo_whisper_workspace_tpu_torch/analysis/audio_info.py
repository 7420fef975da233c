"""Audio file metadata + spectral statistics.

Port copy of turbo_whisper_workspace_tpu/analysis/audio_info.py (numpy,
on this package's audio/io.py decoders).

Rebuilds utils/audio_info.py:9-77 (duration/channels/rate/bitrate via
pydub + RMS/ZCR/spectral centroid/bandwidth/rolloff/contrast via
librosa) on top of our own decoder and numpy spectral math.
"""

from __future__ import annotations

import os

import numpy as np

from ..audio import io as audio_io


def _spectral_stats(audio: np.ndarray, sr: int) -> dict:
    n_fft, hop = 1024, 512
    n = max((len(audio) - n_fft) // hop + 1, 0)
    if n == 0:
        return {}
    idx = np.arange(n_fft)[None, :] + (np.arange(n) * hop)[:, None]
    win = np.hanning(n_fft)
    spec = np.abs(np.fft.rfft(audio[idx] * win, axis=1))      # (F, bins)
    freqs = np.fft.rfftfreq(n_fft, 1 / sr)
    p = spec + 1e-12

    centroid = (p * freqs).sum(1) / p.sum(1)
    bandwidth = np.sqrt(
        (p * (freqs[None] - centroid[:, None]) ** 2).sum(1) / p.sum(1)
    )
    cum = np.cumsum(p, axis=1)
    rolloff_bin = np.argmax(cum >= 0.85 * cum[:, -1:], axis=1)
    rolloff = freqs[rolloff_bin]
    # spectral contrast: peak-to-valley in octave bands
    bands = [(0, 200), (200, 400), (400, 800), (800, 1600),
             (1600, 3200), (3200, 8000)]
    contrast = []
    for lo, hi in bands:
        m = (freqs >= lo) & (freqs < hi)
        if m.sum() < 4:
            continue
        band = np.sort(p[:, m], axis=1)
        k = max(1, int(0.2 * band.shape[1]))
        contrast.append(
            float(np.mean(np.log(band[:, -k:].mean(1) + 1e-12)
                          - np.log(band[:, :k].mean(1) + 1e-12)))
        )
    return {
        "spectral_centroid": float(centroid.mean()),
        "spectral_bandwidth": float(bandwidth.mean()),
        "spectral_rolloff": float(rolloff.mean()),
        "spectral_contrast": float(np.mean(contrast)) if contrast else 0.0,
    }


def get_audio_info(path: str) -> dict:
    """File + signal statistics (utils/audio_info.py:9-77 schema)."""
    with open(path, "rb") as f:
        head = f.read(4)
    size = os.path.getsize(path)

    channels, rate, bits = 1, audio_io.TARGET_SR, 16
    if head == b"fLaC":
        with open(path, "rb") as f:
            info = audio_io.flac_stream_info(f.read())
        channels, rate = info["channels"], info["sample_rate"]
        bits = info["bits_per_sample"]
        fmt = "flac"
    elif head == b"RIFF":
        import wave

        with wave.open(path) as w:
            channels, rate = w.getnchannels(), w.getframerate()
            bits = w.getsampwidth() * 8
        fmt = "wav"
    else:
        fmt = os.path.splitext(path)[1].lstrip(".") or "unknown"

    audio, sr = audio_io.read_audio_file(path, normalize=False)
    duration = len(audio) / sr
    zcr = float((np.abs(np.diff(np.sign(audio))) > 0).mean()) if len(audio) > 1 else 0.0
    info = {
        "filename": os.path.basename(path),
        "format": fmt,
        "duration": duration,
        "channels": channels,
        "sample_rate": rate,
        "bits_per_sample": bits,
        "bitrate": int(size * 8 / duration) if duration else 0,
        "file_size_bytes": size,
        "rms": float(np.sqrt((audio**2).mean())) if audio.size else 0.0,
        "zero_crossing_rate": zcr,
    }
    info.update(_spectral_stats(audio, sr))
    return info
