"""The one generator that every traffic mix's data file drives.

A mix (`traffic/<name>.json`) holds parameters only. The sizes of its
calls (file lengths, conversation lengths) are drawn from the mix's own
`sizes_seed`, so every run's seed gets the same set of sizes: what the
run's `--seed` changes is the content (the audio, the words), the order
in which the pool of calls is cycled, and the weights.

The window-layout arithmetic is a frozen copy of the port's
`decode/longform.py:plan_chunks` (30 s windows advancing by 20 s).
"""

from __future__ import annotations

import math

import numpy as np
import torch

SAMPLE_RATE = 16_000


# ---------------------------------------------------------------------------
# windows


def window_starts(n_samples: int, chunk_s: float = 30.0, stride_s: float = 5.0,
                  sr: int = SAMPLE_RATE) -> list[int]:
    """Sample offsets of the 30 s windows a file of n_samples is cut into."""
    chunk, stride = int(chunk_s * sr), int(stride_s * sr)
    if n_samples <= chunk:
        return [0]
    step = chunk - 2 * stride
    n = 1 + math.ceil((n_samples - chunk) / step)
    return [min(i * step, n_samples - chunk) for i in range(n)]


def n_windows(n_samples: int, chunk_s: float = 30.0, stride_s: float = 5.0,
              sr: int = SAMPLE_RATE) -> int:
    return len(window_starts(n_samples, chunk_s, stride_s, sr))


def samples_for_windows(w: int, chunk_s: float = 30.0, stride_s: float = 5.0,
                        sr: int = SAMPLE_RATE) -> int:
    """The longest file that is cut into exactly w windows."""
    chunk, stride = int(chunk_s * sr), int(stride_s * sr)
    return chunk + (w - 1) * (chunk - 2 * stride)


def log_uniform(rng: np.random.Generator, lo: float, hi: float) -> float:
    return float(math.exp(rng.uniform(math.log(lo), math.log(hi))))


def batch_calls(mix: dict) -> list[list[int]]:
    """Pool of batch calls, each a list of file lengths in samples: lengths
    log-uniform over mix["file_seconds"], drawn until the call holds
    exactly mix["windows_per_call"] windows, the last file cut to fit."""
    rng = np.random.default_rng(mix["sizes_seed"])
    lo, hi = mix["file_seconds"]
    calls = []
    for _ in range(mix["pool_calls"]):
        files, left = [], mix["windows_per_call"]
        while left:
            n = int(log_uniform(rng, lo, hi) * SAMPLE_RATE)
            if n_windows(n) > left:
                n = samples_for_windows(left)
            files.append(n)
            left -= n_windows(n)
        calls.append(files)
    return calls


def request_lengths(mix: dict) -> list[int]:
    """Pool of single-file requests, lengths in samples at evenly spaced
    quantiles of the log-uniform law over mix["file_seconds"] (a
    stratified draw from the mix's sizes_seed), in the order that seed
    gives."""
    rng = np.random.default_rng(mix["sizes_seed"])
    lo, hi = (math.log(s) for s in mix["file_seconds"])
    n = mix["pool_calls"]
    u = (np.arange(n) + rng.uniform(size=n)) / n
    lengths = [int(math.exp(lo + (hi - lo) * x) * SAMPLE_RATE) for x in u]
    return [lengths[i] for i in rng.permutation(n)]


def cycle_order(n_pool: int, seed: int) -> list[int]:
    """The order in which a run cycles its pool of calls."""
    return [int(i) for i in np.random.default_rng(seed).permutation(n_pool)]


# ---------------------------------------------------------------------------
# arrivals


def arrivals(mix: dict, seconds: float) -> tuple[list[float] | None, int]:
    """(arrival offsets in seconds from the window's start, callers) of
    the mix's mix["arrivals"]:

    * {"process": "closed", "callers": n} (the default, n = 1): None; each
      caller starts a call as its last one returns;
    * {"process": "poisson", "rate_per_s": r, "callers": n, "seed": s}:
      arrivals at rate r over the window, from the mix's own seed s, so
      every run's seed gets the same arrivals (its seed picks which call
      of the pool comes at each); n callers serve them in order of
      arrival."""
    spec = mix.get("arrivals", {"process": "closed"})
    callers = int(spec.get("callers", 1))
    if spec["process"] == "closed":
        return None, callers
    if spec["process"] != "poisson":
        raise ValueError(f"arrival process {spec['process']!r}: closed or poisson")
    rng = np.random.default_rng(spec["seed"])
    out, t = [], 0.0
    while True:
        t += float(rng.exponential(1.0 / spec["rate_per_s"]))
        if t >= seconds:
            return out, callers
        out.append(t)


# ---------------------------------------------------------------------------
# two-speaker speech-like audio


def speech(n_samples: int, params: dict, gen: torch.Generator, device) -> np.ndarray:
    """n_samples of 16 kHz mono float32: two speakers taking turns (a
    harmonic voice at each speaker's pitch under a syllable envelope),
    short pauses between turns, and a noise floor that keeps every
    100 ms frame within 40 dB of the peak, so no window is silent."""
    def uniform(lo, hi, n):
        return lo + (hi - lo) * torch.rand(n, generator=gen, device=device, dtype=torch.float64)

    sr = SAMPLE_RATE
    turn_lo, turn_hi = params["turn_s"]
    pause_lo, pause_hi = params["pause_s"]
    k = int(n_samples / sr / ((turn_lo + pause_lo) / 2)) + 2
    turn = uniform(turn_lo, turn_hi, k) * sr
    pause = uniform(pause_lo, pause_hi, k) * sr
    starts = torch.cumsum(turn + pause, 0) - (turn + pause)
    t = torch.arange(n_samples, device=device, dtype=torch.float64)
    idx = (torch.searchsorted(starts, t, right=True) - 1).clamp_min(0)
    in_turn = (t - starts[idx]) < turn[idx]
    speaker = idx % 2
    f0_lo = torch.tensor([r[0] for r in params["f0_hz"]], device=device, dtype=torch.float64)
    f0_hi = torch.tensor([r[1] for r in params["f0_hz"]], device=device, dtype=torch.float64)
    f0_turn = f0_lo[torch.arange(k, device=device) % 2] + (
        f0_hi - f0_lo)[torch.arange(k, device=device) % 2] * uniform(0, 1, k)
    rate = uniform(3.0, 5.0, k)
    phase0 = uniform(0, math.pi, k)
    f0 = f0_turn[idx] * (1 + 0.03 * torch.sin(2 * math.pi * 0.7 * t / sr + speaker))
    phase = torch.remainder(torch.cumsum(2 * math.pi * f0 / sr, 0), 2 * math.pi).float()
    voice = sum(torch.sin(h * phase) / h for h in range(1, params["harmonics"] + 1))
    env = 0.35 + 0.65 * torch.sin(math.pi * rate[idx] * t / sr + phase0[idx]).float() ** 2
    x = voice * env * in_turn.float()
    x = x / x.abs().max().clamp_min(1e-6) * 0.9
    x = x + params["noise_rms"] * torch.randn(n_samples, generator=gen, device=device)
    return x.clamp(-1.0, 1.0).cpu().numpy().astype(np.float32)


# ---------------------------------------------------------------------------
# conversations for the enrichment stage

CONSONANTS = "b c d f g h j k l m n p r s t v w z br ch cl dr fl gr pl sh st th tr".split()
VOWELS = "a e i o u ai ea ee oo ou".split()


def conversation_sizes(mix: dict) -> list[list[int]]:
    """Pool of conversations, each the byte length of its segments'
    texts: totals evenly spaced over mix["text_bytes"], split over
    mix["segments"] segments by a draw from the mix's sizes_seed."""
    rng = np.random.default_rng(mix["sizes_seed"])
    lo, hi = mix["text_bytes"]
    n = mix["pool_calls"]
    sizes = []
    for i in range(n):
        total = int(round(lo + (hi - lo) * i / max(n - 1, 1)))
        share = rng.uniform(0.5, 1.5, mix["segments"])
        lengths = np.maximum(np.floor(share / share.sum() * total).astype(int), 8)
        lengths[-1] += total - lengths.sum()
        sizes.append([int(x) for x in lengths])
    return [sizes[i] for i in rng.permutation(n)]


def words_text(n_bytes: int, rng: np.random.Generator) -> str:
    """ASCII text of exactly n_bytes: pseudo-words of 1-3 syllables in
    sentences."""
    out, sentence = [], 0
    while sum(len(w) + 1 for w in out) < n_bytes + 1:
        word = "".join(rng.choice(CONSONANTS) + rng.choice(VOWELS)
                       for _ in range(rng.integers(1, 4)))
        sentence += 1
        if sentence == 1:
            word = word.capitalize()
        if sentence >= rng.integers(5, 12):
            word += "."
            sentence = 0
        out.append(word)
    return " ".join(out)[:n_bytes].rstrip().ljust(n_bytes, ".")


def conversation(lengths: list[int], rng: np.random.Generator) -> list[dict]:
    """Merged segments of two speakers taking turns, texts of the given
    byte lengths."""
    segs, speaker, t = [], 0, 0.0
    for i, n in enumerate(lengths):
        if i and rng.uniform() < 0.7:
            speaker = 1 - speaker
        dur = n / 15.0
        segs.append({"speaker": f"Speaker {speaker}", "start": t, "end": t + dur,
                     "text": words_text(n, rng)})
        t += dur
    return segs
