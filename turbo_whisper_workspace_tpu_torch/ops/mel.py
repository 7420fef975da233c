"""Whisper log-mel spectrogram frontend on torch.

Port of turbo_whisper_workspace_tpu/ops/mel.py. The filter bank and the
windowed DFT bases are the same numpy code. The STFT keeps the JAX
package's form, three hop-deep matrix products over hop-aligned chunks
of the waveform (Σ_i chunk[t+i] @ K_i), computed in float32. The JAX
code asks XLA for `Precision.HIGHEST`; here TF32 is switched off around
the products, so a float32 product on the card is full float32 too.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16_000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH_S = 30
N_SAMPLES = SAMPLE_RATE * CHUNK_LENGTH_S        # 480_000
N_FRAMES = N_SAMPLES // HOP_LENGTH              # 3_000
N_FREQS = N_FFT // 2 + 1                        # 201


def _hz_to_mel_slaney(freq: np.ndarray) -> np.ndarray:
    """Slaney-scale Hz→mel (linear below 1 kHz, log above)."""
    freq = np.asarray(freq, dtype=np.float64)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    mels = freq / f_sp
    log_region = freq >= min_log_hz
    mels = np.where(
        log_region,
        min_log_mel + np.log(np.maximum(freq, min_log_hz) / min_log_hz) / logstep,
        mels,
    )
    return mels


def _mel_to_hz_slaney(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    freqs = mels * f_sp
    log_region = mels >= min_log_mel
    freqs = np.where(
        log_region,
        min_log_hz * np.exp(logstep * (np.maximum(mels, min_log_mel) - min_log_mel)),
        freqs,
    )
    return freqs


@functools.lru_cache(maxsize=4)
def mel_filter_bank(
    num_mels: int = 80,
    num_freqs: int = N_FREQS,
    sample_rate: int = SAMPLE_RATE,
    fmin: float = 0.0,
    fmax: float = 8000.0,
) -> np.ndarray:
    """Slaney-scale, slaney-normalized triangular mel filterbank,
    (num_mels, num_freqs) float32 (librosa.filters.mel(norm="slaney"))."""
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, num_freqs)
    mel_min = _hz_to_mel_slaney(np.array(fmin))
    mel_max = _hz_to_mel_slaney(np.array(fmax))
    mel_pts = np.linspace(mel_min, mel_max, num_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    enorm = 2.0 / (hz_pts[2 : num_mels + 2] - hz_pts[:num_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


@functools.lru_cache(maxsize=2)
def _windowed_dft_kernel(n_fft: int = N_FFT) -> np.ndarray:
    """Hann-windowed real-DFT basis, (2 * n_freqs, 1, n_fft): cosine
    (real) projections first, then -sine (imaginary)."""
    n_freqs = n_fft // 2 + 1
    n = np.arange(n_fft, dtype=np.float64)
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / n_fft))  # periodic Hann
    k = np.arange(n_freqs, dtype=np.float64)[:, None]
    angle = 2.0 * np.pi * k * n[None, :] / n_fft
    cos_basis = np.cos(angle) * window[None, :]
    sin_basis = -np.sin(angle) * window[None, :]
    kernel = np.concatenate([cos_basis, sin_basis], axis=0)[:, None, :]
    return kernel.astype(np.float32)


@functools.lru_cache(maxsize=2)
def _chunked_dft_bases(n_fft: int = N_FFT, hop: int = HOP_LENGTH):
    """The windowed DFT basis split into hop-aligned chunks: a frame
    starting at t*hop covers chunks t, t+1, …, so
    Y[t] = Σ_i chunk[t+i] @ K_i with K_i = basis[:, i*hop:(i+1)*hop]ᵀ
    zero-padded to (hop, 2*n_freqs)."""
    kernel = _windowed_dft_kernel(n_fft)[:, 0, :]        # (402, n_fft)
    n_chunks = -(-n_fft // hop)
    bases = []
    for i in range(n_chunks):
        piece = kernel[:, i * hop : (i + 1) * hop]       # (402, <=hop)
        if piece.shape[1] < hop:
            piece = np.pad(piece, ((0, 0), (0, hop - piece.shape[1])))
        bases.append(piece.T.copy())                     # (hop, 402)
    return tuple(bases)


@contextlib.contextmanager
def full_f32():
    """Full float32 products and convolutions inside (TF32 off for
    matmuls and cuDNN), restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _stft_power_tf(audio: torch.Tensor, n_fft: int = N_FFT,
                   hop_length: int = HOP_LENGTH) -> torch.Tensor:
    """Power spectrogram (B, frames, n_freqs), float32; the final frame
    is dropped, as the reference extractor's ``magnitudes[..., :-1]``."""
    pad = n_fft // 2
    x = F.pad(audio[:, None], (pad, pad), mode="reflect")[:, 0]
    b, p = x.shape
    n_frames = (p - n_fft) // hop_length + 1
    bases = _chunked_dft_bases(n_fft, hop_length)
    # tail zero-pad: the last < hop excess samples only ever meet the
    # zero rows of the final basis piece
    total = (n_frames - 1 + len(bases)) * hop_length
    if total > p:
        x = F.pad(x, (0, total - p))
    c = x.reshape(b, -1, hop_length)
    acc = None
    for i, basis in enumerate(bases):
        y = c[:, i : i + n_frames] @ torch.from_numpy(basis).to(x.device)
        acc = y if acc is None else acc + y
    acc = acc[:, :-1]
    n_freqs = n_fft // 2 + 1
    real, imag = acc[..., :n_freqs], acc[..., n_freqs:]
    return real * real + imag * imag


def stft_power(audio: torch.Tensor, n_fft: int = N_FFT,
               hop_length: int = HOP_LENGTH) -> torch.Tensor:
    """Power spectrogram |STFT|^2 of float audio (B, T), in the
    (B, n_freqs, frames) layout, float32 with full-f32 products."""
    with full_f32():
        return _stft_power_tf(audio.to(torch.float32), n_fft, hop_length).transpose(1, 2)


def log_mel_spectrogram(audio: torch.Tensor, num_mels: int = 80) -> torch.Tensor:
    """Whisper log-mel features: audio (B, T) or (T,), float or int16 PCM
    → (B, num_mels, T//hop) float32 on audio's device.

    Power spectrogram → slaney mel → log10 clamped at 1e-10 → floor at
    the per-clip max-8 → (x+4)/4, as the reference extractor does.
    """
    squeeze = audio.ndim == 1
    if squeeze:
        audio = audio[None]
    if not audio.is_floating_point():
        # int16 PCM off the decoders: converted on the device, so the
        # host→device copy carries half the bytes of float32
        audio = audio.to(torch.float32) * (1.0 / 32768.0)
    audio = audio.to(torch.float32)
    with full_f32():
        power = _stft_power_tf(audio)
        mel_w = torch.from_numpy(mel_filter_bank(num_mels)).to(audio.device)
        mel = torch.einsum("mf,btf->bmt", mel_w, power)
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    floor = log_spec.amax(dim=(1, 2), keepdim=True) - 8.0
    log_spec = torch.maximum(log_spec, floor)
    log_spec = (log_spec + 4.0) / 4.0
    return log_spec[0] if squeeze else log_spec


def pad_or_trim(audio: np.ndarray, length: int = N_SAMPLES) -> np.ndarray:
    """Zero-pad or truncate a waveform to exactly `length` samples
    (whisper's pad_or_trim; the HF extractor does the same before STFT)."""
    audio = np.asarray(audio)
    if audio.shape[-1] >= length:
        return audio[..., :length]
    pad_width = [(0, 0)] * (audio.ndim - 1) + [(0, length - audio.shape[-1])]
    return np.pad(audio, pad_width)
