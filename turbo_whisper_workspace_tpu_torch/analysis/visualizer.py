"""Dark-theme matplotlib visualizations.

Port copy of turbo_whisper_workspace_tpu/analysis/visualizer.py (numpy;
matplotlib is imported only when a figure is drawn).

Rebuilds utils/visualizer.py (331 LoC): waveform (`:26-68`),
spectrogram — STFT n_fft=2048 hop=512, dB, log-y (`:70-130`), pitch
track 80–800 Hz (`:132-190`, librosa piptrack replaced by a per-frame
spectral-peak tracker), chromagram (`:192-254`, chroma filterbank built
from scratch), and the per-speaker diarization timeline (`:256-331`).
All functions return a matplotlib Figure.
"""

from __future__ import annotations

import numpy as np

SR = 16_000
_DARK = {
    "figure.facecolor": "#121212",
    "axes.facecolor": "#121212",
    "axes.edgecolor": "#888888",
    "axes.labelcolor": "#dddddd",
    "text.color": "#dddddd",
    "xtick.color": "#aaaaaa",
    "ytick.color": "#aaaaaa",
}


def _fig(w=10, h=4):
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    with plt.rc_context(_DARK):
        fig, ax = plt.subplots(figsize=(w, h))
        fig.patch.set_facecolor(_DARK["figure.facecolor"])
        ax.set_facecolor(_DARK["axes.facecolor"])
    return fig, ax


def _stft_db(audio: np.ndarray, n_fft: int = 2048, hop: int = 512):
    n = max((len(audio) - n_fft) // hop + 1, 1)
    pad = (n - 1) * hop + n_fft - len(audio)
    if pad > 0:
        audio = np.pad(audio, (0, pad))
    idx = np.arange(n_fft)[None, :] + (np.arange(n) * hop)[:, None]
    spec = np.abs(np.fft.rfft(audio[idx] * np.hanning(n_fft), axis=1)).T
    return 20 * np.log10(spec + 1e-9)


def plot_waveform(audio: np.ndarray, sr: int = SR):
    fig, ax = _fig()
    t = np.arange(len(audio)) / sr
    ax.plot(t, audio, linewidth=0.4, color="#4fc3f7")
    ax.set_xlabel("time (s)")
    ax.set_ylabel("amplitude")
    ax.set_title("Waveform")
    return fig


def plot_spectrogram(audio: np.ndarray, sr: int = SR):
    fig, ax = _fig()
    db = _stft_db(audio)
    extent = [0, len(audio) / sr, 0, sr / 2]
    im = ax.imshow(db, aspect="auto", origin="lower", extent=extent,
                   cmap="magma", vmin=db.max() - 80, vmax=db.max())
    ax.set_yscale("symlog", linthresh=1000)
    ax.set_ylim(20, sr / 2)
    ax.set_xlabel("time (s)")
    ax.set_ylabel("frequency (Hz)")
    ax.set_title("Spectrogram (dB)")
    fig.colorbar(im, ax=ax, label="dB")
    return fig


def pitch_track(audio: np.ndarray, sr: int = SR, fmin: float = 80.0,
                fmax: float = 800.0, n_fft: int = 2048, hop: int = 512):
    """Per-frame dominant frequency within [fmin, fmax]; 0 for quiet
    frames (the reference's piptrack-argmax equivalent)."""
    db = _stft_db(audio, n_fft, hop)
    freqs = np.fft.rfftfreq(n_fft, 1 / sr)
    band = (freqs >= fmin) & (freqs <= fmax)
    sub = db[band]
    pitches = freqs[band][np.argmax(sub, axis=0)]
    energy = sub.max(axis=0)
    pitches[energy < db.max() - 40] = 0.0
    times = (np.arange(db.shape[1]) * hop + n_fft // 2) / sr
    return times, pitches


def plot_pitch_track(audio: np.ndarray, sr: int = SR):
    fig, ax = _fig()
    times, pitches = pitch_track(audio, sr)
    voiced = pitches > 0
    ax.scatter(times[voiced], pitches[voiced], s=4, color="#81c784")
    ax.set_xlabel("time (s)")
    ax.set_ylabel("pitch (Hz)")
    ax.set_ylim(60, 850)
    ax.set_title("Pitch track (80–800 Hz)")
    return fig


def chroma_filterbank(n_freqs: int, sr: int = SR, n_fft: int = 2048):
    """12-bin chroma projection matrix built from scratch: each FFT bin
    contributes to the pitch class of its nearest semitone."""
    freqs = np.fft.rfftfreq(n_fft, 1 / sr)[:n_freqs]
    fb = np.zeros((12, n_freqs), np.float32)
    valid = freqs > 30
    midi = 69 + 12 * np.log2(np.where(valid, freqs, 440.0) / 440.0)
    pitch_class = np.mod(np.round(midi), 12).astype(int)
    weight = np.exp(-0.5 * ((midi - np.round(midi)) / 0.5) ** 2)
    for b in range(n_freqs):
        if valid[b]:
            fb[pitch_class[b], b] = weight[b]
    return fb


def plot_chromagram(audio: np.ndarray, sr: int = SR):
    fig, ax = _fig()
    n_fft, hop = 2048, 512
    db = _stft_db(audio, n_fft, hop)
    power = 10 ** (db / 10)
    chroma = chroma_filterbank(power.shape[0], sr, n_fft) @ power
    chroma = chroma / (chroma.max(axis=0, keepdims=True) + 1e-9)
    im = ax.imshow(chroma, aspect="auto", origin="lower",
                   extent=[0, len(audio) / sr, -0.5, 11.5], cmap="viridis")
    ax.set_yticks(range(12))
    ax.set_yticklabels(["C", "C#", "D", "D#", "E", "F", "F#", "G", "G#",
                        "A", "A#", "B"])
    ax.set_xlabel("time (s)")
    ax.set_title("Chromagram")
    fig.colorbar(im, ax=ax)
    return fig


def plot_speaker_diarization(segments, duration: float):
    """Per-speaker horizontal timeline (utils/visualizer.py:256-331)."""
    fig, ax = _fig(10, 3)
    speakers = []
    for seg in segments:
        sp = seg["speaker"] if isinstance(seg, dict) else seg.speaker
        if sp not in speakers:
            speakers.append(sp)
    palette = ["#4fc3f7", "#81c784", "#ffb74d", "#e57373", "#ba68c8",
               "#90a4ae", "#fff176", "#4db6ac", "#f06292", "#7986cb"]
    for seg in segments:
        d = seg if isinstance(seg, dict) else seg.to_dict()
        i = speakers.index(d["speaker"])
        ax.barh(i, d["end"] - d["start"], left=d["start"], height=0.6,
                color=palette[i % len(palette)])
    ax.set_yticks(range(len(speakers)))
    ax.set_yticklabels(speakers)
    ax.set_xlim(0, max(duration, 1e-3))
    ax.set_xlabel("time (s)")
    ax.set_title("Speaker timeline")
    return fig
