"""Port analysis and preprocessing (turbo_whisper_workspace_tpu_torch/
analysis: preprocess, diagnostics, audio_info, visualizer; audio/features)
against the JAX package on the CPU, on the same numpy inputs from a seed.

The torch parts (dynamic_normalize, spectral_denoise) are held within
1e-5 relative L2 of the JAX functions (float32 sums in another order);
the numpy and scipy parts, copied, must be equal (features within 1e-5).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turbo_whisper_workspace_tpu.analysis import audio_info as jinfo
from turbo_whisper_workspace_tpu.analysis import diagnostics as jdiag
from turbo_whisper_workspace_tpu.analysis import preprocess as jpp
from turbo_whisper_workspace_tpu.analysis import visualizer as jvis
from turbo_whisper_workspace_tpu.audio import features as jfeat
from turbo_whisper_workspace_tpu_torch.analysis import audio_info as tinfo
from turbo_whisper_workspace_tpu_torch.analysis import diagnostics as tdiag
from turbo_whisper_workspace_tpu_torch.analysis import preprocess as tpp
from turbo_whisper_workspace_tpu_torch.analysis import visualizer as tvis
from turbo_whisper_workspace_tpu_torch.audio import features as tfeat
from turbo_whisper_workspace_tpu_torch.audio import io as tio

SR = 16000
REL_TOL = 1e-5


def rel_err(got, ref) -> float:
    scale = np.linalg.norm(ref)
    return float(np.linalg.norm(got - ref) / scale) if scale else float(np.abs(got).max())


def speechy(seconds: float, seed: int = 0) -> np.ndarray:
    """Tone bursts with noise, alternating with near-silence each second
    (tests/test_analysis_tools.py's signal), cut to `seconds`."""
    rng = np.random.default_rng(seed)
    t = np.arange(SR) / SR
    parts = []
    for i in range(int(np.ceil(seconds))):
        if i % 2 == 0:
            parts.append(0.3 * np.sin(2 * np.pi * 220 * t) + 0.02 * rng.standard_normal(SR))
        else:
            parts.append(0.0005 * rng.standard_normal(SR))
    return np.concatenate(parts)[: int(seconds * SR)].astype(np.float32)


def uneven(seconds: float, seed: int = 1) -> np.ndarray:
    """Quiet noise then loud noise: dynamic normalization has work to do."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    x = rng.standard_normal(n).astype(np.float32)
    x[: n // 2] *= 0.01
    x[n // 2:] *= 0.5
    return x


# ---------------------------------------------------------------------------
# preprocess


@pytest.mark.parametrize("case", ["speech", "quiet", "silence"])
def test_rms_normalize_equal(case):
    x = {"speech": speechy(2.0), "quiet": uneven(1.0) * 0.01,
         "silence": np.zeros(4000, np.float32)}[case]
    np.testing.assert_array_equal(tpp.rms_normalize(x, -16.0), jpp.rms_normalize(x, -16.0))


@pytest.mark.parametrize("audio, window_s", [
    (uneven(4.0), 1.0),                  # many windows
    (uneven(4.0), 1.0000625),            # 16001 samples: an odd window rounds up
    (uneven(1.3), 30.0),                 # audio shorter than the window
    (speechy(3.0), 0.5),
    (np.zeros(12345, np.float32), 0.5),  # silence: unity gains
], ids=["windows", "odd_window", "shorter_than_window", "speech", "silence"])
def test_dynamic_normalize_matches_jax(audio, window_s):
    ref = np.asarray(jpp.dynamic_normalize(audio, window_s=window_s, target_db=-16.0))
    got = tpp.dynamic_normalize(audio, window_s=window_s, target_db=-16.0, device="cpu")
    assert got.shape == ref.shape and got.dtype == np.float32
    assert rel_err(got, ref) <= REL_TOL


@pytest.mark.parametrize("audio, strength", [
    (speechy(4.0), 0.8),
    (uneven(2.0) * 0.1, 0.3),
    (speechy(2.0) + np.float32(0.0), 0.0),
    (np.zeros(SR, np.float32), 0.3),           # silence
    (speechy(2.0)[: 2 * SR + 37], 0.5),        # 247 frames: not a multiple of 4
], ids=["speech", "noise", "strength0", "silence", "frames_not_mult_4"])
def test_spectral_denoise_matches_jax(audio, strength):
    n_frames = (len(audio) - 512) // 128 + 1
    ref = np.asarray(jpp.spectral_denoise(audio, strength=strength))
    got = tpp.spectral_denoise(audio, strength=strength, device="cpu")
    assert got.shape == ref.shape == audio.shape and got.dtype == np.float32
    assert rel_err(got, ref) <= REL_TOL, n_frames


@pytest.mark.parametrize("n", [5, 7, 10, 13, 1001])
def test_lower_quartile_matches_jnp_quantile(n):
    """Linear interpolation between order statistics, at frame counts
    whose quarter position falls between two of them."""
    x = np.random.default_rng(n).standard_normal((n, 9)).astype(np.float32)
    ref = np.asarray(jnp.quantile(jnp.asarray(x), 0.25, axis=0, keepdims=True))
    got = tpp._lower_quartile(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


def test_overlap_add_frame_order():
    """Chunks summed over the frames covering them: a frame of ones over
    r = 4 hops gives 1, 2, 3, 4, ..., 4, 3, 2, 1 per hop chunk."""
    out = tpp._overlap_add(torch.ones(1, 4, 2), 5, 20).numpy()
    np.testing.assert_array_equal(out.reshape(-1, 2)[:, 0], [1, 2, 3, 4, 4, 3, 2, 1, 0, 0])


@pytest.mark.parametrize("fn, kw", [
    ("highpass", {"cutoff_hz": 80.0}), ("lowpass", {"cutoff_hz": 12000.0}),
    ("peaking_eq", {"center_hz": 1000.0, "gain_db": 6.0}), ("apply_audio_effects", {}),
])
def test_filters_equal(fn, kw):
    t = np.arange(2 * SR) / SR
    x = (np.sin(2 * np.pi * 40 * t) + np.sin(2 * np.pi * 1000 * t)).astype(np.float32)
    np.testing.assert_array_equal(getattr(tpp, fn)(x, **kw), getattr(jpp, fn)(x, **kw))


# ---------------------------------------------------------------------------
# diagnostics and audio info


@pytest.mark.parametrize("audio", [speechy(8.0), uneven(1.0) * 1e-3,
                                   np.clip(speechy(2.0) * 5, -1, 1)],
                         ids=["speech", "quiet", "clipped"])
def test_diagnose_equal(audio):
    ref, got = jdiag.diagnose(audio), tdiag.diagnose(audio)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert str(got) == str(ref)
    for name in ("vad_energy", "vad_zcr", "vad_combined"):
        np.testing.assert_array_equal(getattr(tdiag, name)(audio), getattr(jdiag, name)(audio))


def test_strength_sweep_matches_jax():
    x = speechy(3.0)
    strengths = (0.0, 0.5, 1.0)
    best_j, res_j = jdiag.denoise_strength_sweep(x, strengths=strengths)
    best_t, res_t = tdiag.denoise_strength_sweep(x, strengths=strengths, device="cpu")
    assert best_t == best_j
    assert [r["strength"] for r in res_t] == [r["strength"] for r in res_j]
    np.testing.assert_allclose([r["speech_pct"] for r in res_t],
                               [r["speech_pct"] for r in res_j], atol=1e-6)


def test_audio_info_equal(tmp_path):
    p = str(tmp_path / "x.wav")
    tio.write_wav(p, speechy(3.0), SR)
    got, ref = tinfo.get_audio_info(p), jinfo.get_audio_info(p)
    assert got == ref
    assert got["format"] == "wav" and abs(got["duration"] - 3.0) < 0.01


# ---------------------------------------------------------------------------
# features


def test_mfcc_and_features_match_jax():
    x = speechy(3.0, seed=3)
    np.testing.assert_allclose(tfeat.mfcc(x), jfeat.mfcc(x), rtol=1e-5, atol=1e-5)
    got, ref = tfeat.extract_audio_features(x), jfeat.extract_audio_features(x)
    assert sorted(got) == sorted(ref)
    for key in ref:
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-5, atol=1e-5, err_msg=key)


def test_split_audio_and_detect_silence_match_jax():
    x = speechy(6.0, seed=4)
    segs = [{"start": 0.5, "end": 1.5}, {"start": 4.0, "end": 9.0}]
    for g, r in zip(tfeat.split_audio(x, segs), jfeat.split_audio(x, segs)):
        np.testing.assert_array_equal(g, r)
    got, ref = tfeat.detect_silence(x), jfeat.detect_silence(x)
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert g == pytest.approx(r, abs=1e-5)


# ---------------------------------------------------------------------------
# visualizer


def test_visualizer_matches_jax():
    x = speechy(2.0)
    np.testing.assert_array_equal(tvis.chroma_filterbank(1025), jvis.chroma_filterbank(1025))
    for g, r in zip(tvis.pitch_track(x), jvis.pitch_track(x)):
        np.testing.assert_array_equal(g, r)


def test_visualizer_figures():
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    x = speechy(2.0)
    figs = [tvis.plot_waveform(x), tvis.plot_spectrogram(x), tvis.plot_pitch_track(x),
            tvis.plot_chromagram(x),
            tvis.plot_speaker_diarization(
                [{"speaker": "Speaker 0", "start": 0.0, "end": 1.0},
                 {"speaker": "Speaker 1", "start": 1.0, "end": 2.0}], 2.0)]
    for f in figs:
        assert f is not None and f.axes
        plt.close(f)
