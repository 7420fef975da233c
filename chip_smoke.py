#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (turbo_whisper_workspace_tpu_torch).

    python3 chip_smoke.py        # from the repo root, on a machine with one
                                 # NVIDIA GPU, nvcc and PyTorch built for CUDA

Phases, in order; any failure ends the run with a non-zero exit:

1. environment: the card's name and power limit, torch and CUDA versions;
   TF32 off for float32 products and convolutions;
2. build: compiles the CUDA kernels from csrc/ (one nvcc each, in parallel);
3. kernels against their plain PyTorch versions at large-v3-turbo shapes
   in bf16 (flash_attention B=8 H=20 T=1500 on (B, T, H·64) projections
   viewed as heads, as the encoder calls it; cross_attention_int8 B=8
   H=20 Tq 1 and 4, Tpad 1536): max abs error within 2e-2 and relative
   L2 error within 5e-3 (a kernel that dropped the mask of the keys past
   the sequence would be off by ~1.4e-2; the script prints that reading
   from the plain version), and the median
   of 25 timed runs (CUDA events, L2 flushed before each run) of the
   kernel, the plain version and, where one exists, the one PyTorch call
   computing the same function, beside the least time the card could take;
4. the main path at full large-v3-turbo width (random weights from seed
   0, bf16, default TranscriptionConfig: greedy, int8 cross-KV, language
   detection): first the model is held to its plain-PyTorch twin on one
   window (encoder features and prefill logits), then the launch counts
   are zeroed and the pipeline answers two single-file requests through
   AudioProcessingPipeline.transcribe (the golden clip and a synthesized
   75 s clip) and one batch call of Transcriber.transcribe that fills a
   bucket of 8 windows; the result schema is checked and both kernels
   must have been launched during this phase.

Prints a `kernels` JSON line, then as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero, printing no result, when CUDA is unavailable.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import wave

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "examples", "golden", "conversation.wav")
KERNEL_TOL = 2e-2          # max abs error: bf16 outputs, a few ulps of 2^-8 relative
KERNEL_REL_TOL = 5e-3      # relative L2 error: above two bf16 roundings (~2e-3),
                           # below the loss of the t >= seq_len mask (~1.4e-2)
MODEL_TOL = 5e-2           # relative L2 error of encoder features / logits
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
RUNS = 25


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, flush: torch.Tensor) -> float:
    """Median ms of RUNS calls after 3 warm-up calls; the L2 cache is
    flushed (a 256 MB write) before each timed call."""
    for _ in range(3):
        fn()
    events = []
    for _ in range(RUNS):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_ops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all() and got.shape == ref.shape
    return ((got - ref).norm() / ref.norm()).item()


def compare(name: str, got: torch.Tensor, ref: torch.Tensor, unmasked: torch.Tensor):
    """Max abs and relative L2 error of a kernel against its plain
    version; `unmasked` is the plain version with the keys past the
    sequence left in, the error the relative check must catch."""
    err = (got.float() - ref.float()).abs().max().item()
    rel, miss = rel_err(got, ref), rel_err(unmasked, ref)
    print(f"{name}: max_abs_err {err:.3e} (tolerance {KERNEL_TOL}), rel_l2_err "
          f"{rel:.3e} (tolerance {KERNEL_REL_TOL}; without the key mask {miss:.3e})")
    assert math.isfinite(err) and err <= KERNEL_TOL and rel <= KERNEL_REL_TOL, (err, rel)
    assert miss > KERNEL_REL_TOL, miss
    return err, rel


def check_kernels(att, dev) -> dict:
    """Phase 3: each kernel against its plain version, timed."""
    gen = torch.Generator(dev).manual_seed(0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    stats = {}

    b, h, t, d = 8, 20, 1500, 64
    tpad = 1536
    # the encoder's layout: (B, T, H·64) projections viewed as (B, H, T, 64)
    q, k, v = (torch.randn(b, t, h * d, generator=gen, device=dev).to(torch.bfloat16)
               .view(b, t, h, d).transpose(1, 2) for _ in range(3))
    out = att.flash_attention(q, k, v)
    torch.cuda.synchronize()
    # keys t >= T as the kernel's last tile holds them: zeros
    pad = (0, 0, 0, tpad - t)
    unmasked = att.flash_attention_reference(q, torch.nn.functional.pad(k, pad),
                                             torch.nn.functional.pad(v, pad))
    err, rel = compare(f"flash_attention B={b} H={h} T={t} D={d}", out,
                       att.flash_attention_reference(q, k, v), unmasked)
    del unmasked
    bms, by = bound_ms(nbytes(q, k, v, out), 4 * b * h * t * t * d)
    stats["flash_attention"] = {
        "max_abs_err": err, "rel_l2_err": rel,
        "ms": time_ms(lambda: att.flash_attention(q, k, v), flush),
        "plain_ms": time_ms(lambda: att.flash_attention_reference(q, k, v), flush),
        "bound_ms": bms, "bound_by": by,
        "library_ms": time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v), flush),
    }
    del q, k, v, out

    seq_len = 1500
    kv = att.quantize_cross_kv_int8(
        torch.randn(1, b, h, seq_len, d, generator=gen, device=dev).to(torch.bfloat16),
        torch.randn(1, b, h, seq_len, d, generator=gen, device=dev).to(torch.bfloat16))
    kq, vq, ks, vs = kv["k_q"][0], kv["v_q"][0], kv["k_scale"][0], kv["v_scale"][0]
    errs = {}
    for tq in (1, 4):
        qc = torch.randn(b, h, tq, d, generator=gen, device=dev).to(torch.bfloat16)
        args = (qc, kq, vq, ks, vs)
        out = att.cross_attention_int8(*args, seq_len=seq_len)
        torch.cuda.synchronize()
        errs[tq] = compare(
            f"cross_attention_int8 B={b} H={h} Tq={tq} Tpad={kq.shape[-1]}", out,
            att.cross_attention_int8_reference(*args, seq_len=seq_len),
            att.cross_attention_int8_reference(*args, seq_len=kq.shape[-1]))
        ms = time_ms(lambda: att.cross_attention_int8(*args, seq_len=seq_len), flush)
        plain = time_ms(lambda: att.cross_attention_int8_reference(*args, seq_len=seq_len),
                        flush)
        # the kernel reads K and V only at t < seq_len, each once
        bms, by = bound_ms(nbytes(qc, ks, vs, out) + 2 * b * h * d * seq_len,
                           4 * b * h * tq * seq_len * d)
        print(f"cross_attention_int8 B={b} H={h} Tq={tq}: kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms, bound {bms:.4f} ms ({by})")
        if tq == 1:   # the decode step's shape: the row in the kernels line
            stats["cross_attention_int8"] = {
                "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
                "library_ms": None,
            }
    stats["cross_attention_int8"]["max_abs_err"] = max(e for e, _ in errs.values())
    stats["cross_attention_int8"]["rel_l2_err"] = max(r for _, r in errs.values())
    return stats


def check_model(att, transcriber, audio: np.ndarray) -> None:
    """The full-width model with its kernels against the same model with
    the plain versions, on one window: encoder features and prefill
    logits (with the int8 cross-KV)."""
    from turbo_whisper_workspace_tpu_torch.ops import mel as mel_ops

    model, dev = transcriber.model, transcriber.device
    pcm = np.clip(mel_ops.pad_or_trim(audio) * 32768.0, -32768, 32767).astype(np.int16)
    with torch.no_grad():
        mel = mel_ops.log_mel_spectrogram(torch.from_numpy(pcm[None]).to(dev),
                                          model.dims.n_mels)
        feats = model.encoder(mel)
        cross_kv = model.decoder.precompute_cross_kv(feats, quantize=True)
        prompt = torch.tensor([transcriber._prompt_row("en")], device=dev)
        logits, _ = model.decoder(prompt, cross_kv)
        kernels = (att.flash_attention, att.cross_attention_int8)
        counts = dict(att.launch_counts)
        att.flash_attention = att.flash_attention_reference
        att.cross_attention_int8 = att.cross_attention_int8_reference
        try:
            feats_plain = model.encoder(mel)
            logits_plain, _ = model.decoder(prompt, cross_kv)
        finally:
            att.flash_attention, att.cross_attention_int8 = kernels
        assert att.launch_counts == counts, "the plain run launched a kernel"
    e_feats, e_logits = rel_err(feats, feats_plain), rel_err(logits, logits_plain)
    print(f"full-width model vs its plain twin: encoder features rel err {e_feats:.3e}, "
          f"prefill logits rel err {e_logits:.3e} (tolerance {MODEL_TOL})")
    assert e_feats <= MODEL_TOL and e_logits <= MODEL_TOL


def write_wav(path: str, audio: np.ndarray, sr: int = 16000) -> None:
    pcm = (np.clip(audio, -1.0, 1.0) * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def synth_clip(seconds: float, seed: int) -> np.ndarray:
    """Voiced-like audio: harmonic tones under a syllable-rate envelope,
    over noise, with no silence long enough for the VAD gate to drop a
    window."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    f0 = 120 + 40 * np.sin(2 * np.pi * 0.3 * t)
    phase = 2 * np.pi * np.cumsum(f0) / 16000
    voice = sum(np.sin(k * phase) / k for k in range(1, 6))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t) ** 2
    return (0.2 * voice * env + 0.01 * rng.standard_normal(t.size)).astype(np.float32)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from turbo_whisper_workspace_tpu_torch.audio import io as audio_io
    from turbo_whisper_workspace_tpu_torch.config import PipelineConfig
    from turbo_whisper_workspace_tpu_torch.decode.tokenizer import LANGUAGES
    from turbo_whisper_workspace_tpu_torch.ops import attention as att
    from turbo_whisper_workspace_tpu_torch.ops import build
    from turbo_whisper_workspace_tpu_torch.pipeline.audio_pipeline import (
        AudioProcessingPipeline)

    # 1. environment
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 2. build
    print(f"kernels built in {build.build_all():.1f} s")
    for name, log in build.build_log.items():
        used = [ln.split(":", 1)[1].strip() for ln in log.splitlines() if "Used" in ln]
        print(f"  {name}: {'; '.join(used)}")

    # 3. kernels against their plain versions
    stats = check_kernels(att, dev)
    for name, s in stats.items():
        lib = ("none (no single PyTorch call computes attention over int8 K/V "
               "with per-head scales)" if s["library_ms"] is None
               else f"{s['library_ms']:.4f} ms")
        print(f"{name}: kernel {s['ms']:.4f} ms, plain {s['plain_ms']:.4f} ms, "
              f"library {lib}, bound {s['bound_ms']:.4f} ms ({s['bound_by']}) [{card}]")

    # 4. main path at full width
    t0 = time.perf_counter()
    pipe = AudioProcessingPipeline(PipelineConfig(), device="cuda")
    transcriber = pipe.load_transcription_model()
    torch.cuda.synchronize()
    cfg = transcriber.config
    print(f"pipeline: {cfg.model}, {transcriber.model.dtype}, beam {cfg.beam_size}, "
          f"int8 cross-KV {cfg.quantize_cross_kv}, language {cfg.language}, "
          f"batch {cfg.batch_size}, max_decode_len {cfg.max_decode_len}; "
          f"loaded in {time.perf_counter() - t0:.1f} s")
    golden, _ = audio_io.read_audio_file(GOLDEN)
    check_model(att, transcriber, golden)

    keys = ["chunks", "duration", "language", "processing_times", "segments", "text"]

    def check_result(res: dict, duration: float) -> None:
        assert sorted(res) == keys, sorted(res)
        assert res["language"] in LANGUAGES
        assert abs(res["duration"] - duration) < 1e-3
        assert isinstance(res["text"], str)
        for seg in res["segments"]:
            assert 0.0 <= seg["start"] <= seg["end"] <= duration + 1e-6, seg

    att.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        long_path = os.path.join(tmp, "synth_75s.wav")
        write_wav(long_path, synth_clip(75.0, seed=1))
        for path in (GOLDEN, long_path):
            audio, _ = audio_io.read_audio_file(path)
            t0 = time.perf_counter()
            res = pipe.transcribe(path)
            wall = time.perf_counter() - t0
            check_result(res, len(audio) / 16000)
            print(f"request {os.path.basename(path)}: {len(audio) / 16000:.1f} s audio, "
                  f"{transcriber.last_n_windows} windows, wall {wall:.3f} s, "
                  f"{len(audio) / 16000 / wall:.2f} audio-s/s, language "
                  f"{res['language']}, {len(res['segments'])} segments [{card}]")
        # one batch of 8 windows: the 75 s clip (4), the golden clip (1)
        # and three more 15 s clips
        batch = [audio_io.read_audio_file(long_path)[0], golden] + [
            synth_clip(15.0, seed=s) for s in (2, 3, 4)]
        t0 = time.perf_counter()
        results = transcriber.transcribe(batch)
        wall = time.perf_counter() - t0
    assert transcriber.last_n_windows == 8, transcriber.last_n_windows
    for res, audio in zip(results, batch):
        check_result(res, len(audio) / 16000)
    total = sum(len(a) for a in batch) / 16000
    print(f"batch call: {len(batch)} files, {total:.1f} s audio, 8 windows, wall "
          f"{wall:.3f} s, {total / wall:.2f} audio-s/s [{card}]")
    launches = dict(att.launch_counts)
    print(f"launches on the main path: {launches}")
    assert all(n > 0 for n in launches.values()), launches

    lines = []
    for name, s in stats.items():
        lines.append({
            "name": name, "route": "cuda",
            "source": f"turbo_whisper_workspace_tpu_torch/csrc/{name}.cu",
            "replaces": {"flash_attention": "turbo_whisper_workspace_tpu/ops/attention.py:55",
                         "cross_attention_int8":
                             "turbo_whisper_workspace_tpu/ops/attention.py:202"}[name],
            "launches": launches[name], **s,
        })
    print(json.dumps({"kernels": lines}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
