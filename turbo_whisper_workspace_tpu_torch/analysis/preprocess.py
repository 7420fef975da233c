"""Audio preprocessing: dynamic normalization, filters/EQ, denoising.

Port of turbo_whisper_workspace_tpu/analysis/preprocess.py. The two
jitted parts become torch functions on tensors, run on `device` (CUDA
unless the caller asks for the CPU); the entry points keep their
numpy-in, numpy-out signatures:

* `dynamic_normalize`: dynamic_bar_audio.py:212-369: Hann windows
  (default 30 s) with 50% overlap-add, per-window gain toward a target
  RMS dB, gain clamped to [0.1, 10], clip guard;
* `rms_normalize`: normalize_bar_audio.py:64-137: global RMS gain with
  clip guard (numpy, copied);
* `highpass/lowpass/peaking_eq`: dynamic_bar_audio.py:371-488:
  Butterworth HP 80 Hz / LP 12 kHz (filtfilt) and a +3 dB peaking EQ at
  2 kHz (RBJ biquad) (scipy, copied);
* `spectral_denoise`: the DeepFilterNet stage's role
  (dynamic_bar_audio.py:90-210) as spectral gating, with the same
  VAD-adaptive mix: speech regions get half strength (`:160-182`).

Overlap-add sums each output hop-chunk over the frames that cover it in
frame order, the order of a serial scatter-add, without an index tensor
the size of the framed signal. The noise profile's lower quartile sorts
along frames and interpolates linearly as `jnp.quantile` does
(`torch.quantile` refuses inputs above 2^24 elements, fewer than the
frames × bins of a 30-minute file).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..pipeline.transcriber import resolve_device

SR = 16_000


# ---------------------------------------------------------------------------
# Normalization


def rms_normalize(audio: np.ndarray, target_db: float = -16.0) -> np.ndarray:
    """Global RMS → target dBFS with clip guard
    (normalize_bar_audio.py:64-137)."""
    audio = np.asarray(audio, np.float32)
    rms = float(np.sqrt(np.mean(audio**2))) if audio.size else 0.0
    if rms <= 1e-9:
        return audio
    gain = 10 ** (target_db / 20.0) / rms
    out = audio * gain
    peak = np.abs(out).max()
    if peak > 0.99:
        out *= 0.99 / peak
    return out.astype(np.float32)


def _hann(n: int, device) -> torch.Tensor:
    """Periodic Hann window, float32, from the float32 angle's cosine
    rounded once to float32. Near the window's ends 1 - cos cancels, so
    a cosine off by one ulp moves h by a large fraction, and the ends of
    dynamic_normalize divide by h: the correctly rounded cosine keeps
    the port there within 1e-5 of the JAX package."""
    k = torch.arange(n, dtype=torch.float32, device=device)
    c = torch.cos((2.0 * math.pi * k / n).double()).float()
    return 0.5 * (1.0 - c)


def _overlap_add(chunks: torch.Tensor, n_frames: int, length: int) -> torch.Tensor:
    """Overlap-add of frames that start every hop and span r hops, given
    as chunks (n_frames or 1, r, hop) (1: the same frame every time),
    into a signal of `length` samples: zero-padded past the last frame,
    samples past `length` dropped."""
    r, hop = chunks.shape[1:]
    out = chunks.new_zeros(n_frames + r - 1, hop)
    for q in reversed(range(r)):        # frame c-q for q = r-1..0: frame order
        out[q:q + n_frames] += chunks[:, q]
    out = out.reshape(-1)
    return F.pad(out, (0, max(length - out.numel(), 0)))[:length]


def _dynamic_normalize(audio: torch.Tensor, window: int, target_db: float) -> torch.Tensor:
    """audio (n,) float32, window even → normalized (n,)."""
    hop = window // 2
    n = audio.shape[0]
    n_win = (n + hop - 1) // hop  # windows starting every hop
    pad_len = (n_win - 1) * hop + window
    frames = F.pad(audio, (0, pad_len - n)).unfold(0, window, hop)   # (n_win, window)

    rms = torch.sqrt(torch.mean(frames**2, dim=1) + 1e-12)
    target = 10.0 ** (target_db / 20.0)
    gain = torch.clamp(target / torch.clamp(rms, min=1e-6), 0.1, 10.0)
    # silent windows keep unity gain instead of max boost
    gain = torch.where(rms < 1e-4, 1.0, gain)

    hann = _hann(window, audio.device)
    shaped = frames * gain[:, None] * hann[None, :]
    out = _overlap_add(shaped.reshape(n_win, 2, hop), n_win, pad_len)
    wsum = _overlap_add(hann.reshape(1, 2, hop), n_win, pad_len)
    out = (out / torch.clamp(wsum, min=1e-6))[:n]
    # clip guard
    peak = out.abs().max()
    return torch.where(peak > 0.99, out * (0.99 / peak), out)


def dynamic_normalize(
    audio: np.ndarray, window_s: float = 30.0, target_db: float = -16.0,
    sr: int = SR, device: torch.device | str = "cuda",
) -> np.ndarray:
    """Rolling-window loudness normalization (50% overlap-add Hann),
    computed on `device`."""
    device = resolve_device(device)
    window = int(window_s * sr)
    window = min(window, max(len(audio), 2))
    if window % 2:
        window += 1
    x = torch.from_numpy(np.asarray(audio, np.float32)).to(device)
    return _dynamic_normalize(x, window, float(target_db)).cpu().numpy()


# ---------------------------------------------------------------------------
# Filters / EQ (host-side scipy IIR, zero-phase like the reference filtfilt)


def highpass(audio: np.ndarray, cutoff_hz: float = 80.0, sr: int = SR,
             order: int = 4) -> np.ndarray:
    from scipy.signal import butter, filtfilt

    b, a = butter(order, cutoff_hz / (sr / 2), btype="high")
    return filtfilt(b, a, audio).astype(np.float32)


def lowpass(audio: np.ndarray, cutoff_hz: float = 12000.0, sr: int = SR,
            order: int = 4) -> np.ndarray:
    from scipy.signal import butter, filtfilt

    cutoff_hz = min(cutoff_hz, sr / 2 * 0.999)
    b, a = butter(order, cutoff_hz / (sr / 2), btype="low")
    return filtfilt(b, a, audio).astype(np.float32)


def peaking_eq(audio: np.ndarray, center_hz: float = 2000.0,
               gain_db: float = 3.0, q: float = 1.0, sr: int = SR) -> np.ndarray:
    """RBJ peaking biquad (the reference's +3 dB presence boost at 2 kHz)."""
    from scipy.signal import filtfilt

    a_g = 10 ** (gain_db / 40.0)
    w0 = 2 * np.pi * center_hz / sr
    alpha = np.sin(w0) / (2 * q)
    b = np.array([1 + alpha * a_g, -2 * np.cos(w0), 1 - alpha * a_g])
    a = np.array([1 + alpha / a_g, -2 * np.cos(w0), 1 - alpha / a_g])
    return filtfilt(b / a[0], a / a[0], audio).astype(np.float32)


def apply_audio_effects(audio: np.ndarray, sr: int = SR,
                        hp_hz: float = 80.0, lp_hz: float = 12000.0,
                        eq_gain_db: float = 3.0) -> np.ndarray:
    """HP → LP → presence EQ chain (dynamic_bar_audio.py:371-488)."""
    out = highpass(audio, hp_hz, sr)
    out = lowpass(out, lp_hz, sr)
    return peaking_eq(out, 2000.0, eq_gain_db, sr=sr)


# ---------------------------------------------------------------------------
# Denoising (spectral gating with VAD-adaptive strength)


def _moving_average(x: torch.Tensor, k: int) -> torch.Tensor:
    """Centred k-point mean along the last axis, zero-padded at the ends
    (`jnp.convolve(v, ones(k) / k, mode="same")` for odd k)."""
    rows = x.reshape(-1, 1, x.shape[-1])
    kernel = torch.full((1, 1, k), 1.0 / k, dtype=x.dtype, device=x.device)
    return F.conv1d(rows, kernel, padding=k // 2).reshape(x.shape)


def _lower_quartile(x: torch.Tensor) -> torch.Tensor:
    """(F, B) → (1, B) 0.25-quantile along frames, linear interpolation
    with the weights `jnp.quantile` computes (in float32)."""
    n = x.shape[0]
    s = torch.sort(x, dim=0).values
    pos = torch.tensor(0.25 * (n - 1), dtype=torch.float32)
    lo, hi = int(torch.floor(pos)), int(torch.ceil(pos))
    w_hi = (pos - lo).to(x.device)
    return s[lo:lo + 1] * (1.0 - w_hi) + s[hi:hi + 1] * w_hi


def _spectral_gate(audio: torch.Tensor, strength: torch.Tensor,
                   n_fft: int = 512, hop: int = 128) -> torch.Tensor:
    """audio (n,) float32, strength (frames,) → gated audio (n,).
    n_fft must be a multiple of hop. Audio shorter than one frame is
    read as one frame with its last sample repeated."""
    n = audio.shape[0]
    n_frames = max((n - n_fft) // hop + 1, 1)
    if n < n_fft:
        audio = torch.cat([audio, audio[-1:].expand(n_fft - n)])
    window = _hann(n_fft, audio.device)
    frames = audio.unfold(0, n_fft, hop)[:n_frames] * window[None, :]
    spec = torch.fft.rfft(frames, dim=1)                   # (F, n_fft//2+1)
    mag = spec.abs()

    # smooth |S| over time (5 frames) and frequency (3 bins): raw
    # single-frame magnitudes are Rayleigh-spread and gate unreliably
    mag_s = _moving_average(_moving_average(mag.T.contiguous(), 5).T, 3)
    # noise profile: per-bin lower quartile of the smoothed magnitude
    noise = _lower_quartile(mag_s)
    snr = mag_s / torch.clamp(noise, min=1e-9)
    gate = torch.clamp((snr - 1.8) / 1.2, 0.0, 1.0)
    gain = 1.0 - strength[:, None] * (1.0 - gate)
    spec = spec * gain

    rec = torch.fft.irfft(spec, n=n_fft, dim=1) * window[None, :]
    r = n_fft // hop
    out = _overlap_add(rec.reshape(n_frames, r, hop), n_frames, n)
    wsum = _overlap_add((window**2).reshape(1, r, hop), n_frames, n)
    return out / torch.clamp(wsum, min=1e-3)


def spectral_denoise(audio: np.ndarray, strength: float = 0.3,
                     sr: int = SR, device: torch.device | str = "cuda") -> np.ndarray:
    """Spectral-gating noise suppression with the reference's adaptive
    mix: frames classified as speech get strength/2 so voices stay
    untouched (dynamic_bar_audio.py:160-182). The gate runs on
    `device`; the VAD on the host."""
    from ..pipeline.diarizer import energy_vad

    device = resolve_device(device)
    audio = np.asarray(audio, np.float32)
    n_fft, hop = 512, 128
    n_frames = max((len(audio) - n_fft) // hop + 1, 1)
    vad = energy_vad(audio)                              # 10 Hz frames
    frame_t = (np.arange(n_frames) * hop + n_fft // 2) / sr
    vad_idx = np.minimum((frame_t * 10).astype(int), max(len(vad) - 1, 0))
    speech = vad[vad_idx] if len(vad) else np.zeros(n_frames, bool)
    per_frame_strength = np.where(speech, strength / 2.0, strength)
    out = _spectral_gate(
        torch.from_numpy(audio).to(device),
        torch.from_numpy(per_frame_strength.astype(np.float32)).to(device),
        n_fft, hop,
    )
    return out.cpu().numpy().astype(np.float32)
