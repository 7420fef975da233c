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
   H=20 Tq 1, 4 and 5 (the beam step), Tpad 1536; self_attention_int8
   over the regathered int8 cache of B·K=40 beam rows and
   self_attention_int8_lanes over the lane cache of B=8 items, K=5
   beams and a random beam ancestry, both at H=20, T=P+224=227 and
   valid_len 115 (mid-decode) and 227 (last step)): max abs error within
   2e-2 and relative L2 error within 5e-3, and each mask the kernel must
   apply (keys past the sequence, past valid_len, of lanes a beam does
   not own) dropped from the plain version must read above that limit
   (the script prints those readings), and the median of 25 timed runs
   (CUDA events, L2 flushed before each run) of the kernel, the plain
   version and, where one exists, the one PyTorch call computing the
   same function, beside the least time the card could take;
4. the greedy main path at full large-v3-turbo width (random weights
   from seed 0, bf16, default TranscriptionConfig: greedy, int8
   cross-KV, language detection): first the model is held to its
   plain-PyTorch twin on one window (encoder features and prefill
   logits), then the launch counts are zeroed and the pipeline answers
   two single-file requests through AudioProcessingPipeline.transcribe
   (the golden clip and a synthesized 75 s clip) and one batch call of
   Transcriber.transcribe that fills a bucket of 8 windows; the result
   schema is checked and flash_attention and cross_attention_int8 must
   have been launched during this phase;
5. the beam path (TranscriptionConfig(beam_size=5): int8 lane self-KV
   cache), same model: one beam step of the decoder over the lane cache
   and one over the regathered int8 cache, each against the same step
   with the plain versions (logits); then, with the counts zeroed before
   and read after each, one batch call of Transcriber.transcribe on the
   same 8 windows, one single-file request through
   AudioProcessingPipeline.transcribe, and direct calls of
   beam_decode_features on a bucket's cross-KV in each self-KV cache
   mode (int8 lanes, int8 regathered with lane_cache=False, bf16
   regathered), twice each in turns, timed; the beam calls must launch
   self_attention_int8_lanes and cross_attention_int8, the int8
   regathered calls self_attention_int8.

Prints a `kernels` JSON line (launches summed over the runs of phases 4
and 5), then as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero, printing no result, when CUDA is unavailable.
"""

from __future__ import annotations

import contextlib
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
BEAM, PROMPT, DECODE = 5, 3, 224   # the beam phase: beam 5, <|sot|> en transcribe,
                                   # max_decode_len steps (random weights never stop early)
MID_DECODE = PROMPT + 112          # valid_len halfway through a decode
MODEL_TOL = 5e-2           # relative L2 error of encoder features / logits
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
RUNS = 25
REPLACES = {
    "flash_attention": "turbo_whisper_workspace_tpu/ops/attention.py:55",
    "cross_attention_int8": "turbo_whisper_workspace_tpu/ops/attention.py:202",
    "self_attention_int8": "turbo_whisper_workspace_tpu/ops/attention.py:384",
    "self_attention_int8_lanes": "turbo_whisper_workspace_tpu/ops/attention.py:497",
}


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


def compare(name: str, got: torch.Tensor, ref: torch.Tensor, dropped: dict):
    """Max abs and relative L2 error of a kernel against its plain
    version; `dropped` maps each mask the kernel must apply to the plain
    version run without it, an error the relative check must catch."""
    err = (got.float() - ref.float()).abs().max().item()
    rel = rel_err(got, ref)
    misses = {what: rel_err(out, ref) for what, out in dropped.items()}
    shown = "".join(f"; without the {what} {m:.3e}" for what, m in misses.items())
    print(f"{name}: max_abs_err {err:.3e} (tolerance {KERNEL_TOL}), rel_l2_err "
          f"{rel:.3e} (tolerance {KERNEL_REL_TOL}{shown})")
    assert math.isfinite(err) and err <= KERNEL_TOL and rel <= KERNEL_REL_TOL, (err, rel)
    assert all(m > KERNEL_REL_TOL for m in misses.values()), misses
    return err, rel


def random_ancestry(gen, b: int, k: int, t: int, dev) -> torch.Tensor:
    """lane_map (B, K, T) int32 of a beam search run from a PROMPT-token
    prompt to position t: at each step every beam continues a random
    beam of the step before and writes its own lane; the prompt sits in
    lane 0."""
    lane_map = torch.zeros((b, k, t), dtype=torch.int32, device=dev)
    own = torch.arange(k, dtype=torch.int32, device=dev).expand(b, k)
    for pos in range(PROMPT, t):
        src = torch.randint(0, k, (b, k), generator=gen, device=dev)
        lane_map = lane_map.gather(1, src[:, :, None].expand(b, k, t))
        lane_map[:, :, pos] = own
    return lane_map


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
                       att.flash_attention_reference(q, k, v), {"key mask": unmasked})
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
    rows, errs = {}, {}
    for tq in (1, 4, BEAM):
        qc = torch.randn(b, h, tq, d, generator=gen, device=dev).to(torch.bfloat16)
        args = (qc, kq, vq, ks, vs)
        out = att.cross_attention_int8(*args, seq_len=seq_len)
        torch.cuda.synchronize()
        errs[tq] = compare(
            f"cross_attention_int8 B={b} H={h} Tq={tq} Tpad={kq.shape[-1]}", out,
            att.cross_attention_int8_reference(*args, seq_len=seq_len),
            {"key mask": att.cross_attention_int8_reference(*args, seq_len=kq.shape[-1])})
        # the kernel reads K and V only at t < seq_len, each once
        rows[tq] = timed(f"cross_attention_int8 B={b} H={h} Tq={tq}",
                         lambda: att.cross_attention_int8(*args, seq_len=seq_len),
                         lambda: att.cross_attention_int8_reference(*args, seq_len=seq_len),
                         nbytes(qc, ks, vs, out) + 2 * b * h * d * seq_len,
                         4 * b * h * tq * seq_len * d, flush)
    # the greedy decode step's shape, Tq = 1, is the row in the kernels line
    stats["cross_attention_int8"] = kernel_row(rows[1], errs)
    del kv, kq, vq, ks, vs
    stats.update(check_self_kernels(att, dev, gen, flush))
    return stats


def timed(label: str, kernel, plain, n_bytes: float, n_ops: float, flush) -> dict:
    """The kernel's and its plain version's times beside the bound."""
    ms, plain_ms = time_ms(kernel, flush), time_ms(plain, flush)
    bms, by = bound_ms(n_bytes, n_ops)
    print(f"{label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by})")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": None}


def kernel_row(row: dict, errs: dict) -> dict:
    """One shape's times with the worst errors over every shape checked."""
    return {**row, "max_abs_err": max(e for e, _ in errs.values()),
            "rel_l2_err": max(r for _, r in errs.values())}


def check_self_kernels(att, dev, gen, flush) -> dict:
    """Phase 3, the beam step's self-attention kernels at the beam
    phase's shapes: B=8 windows, K=5 beams, H=20, T=PROMPT+DECODE, the
    int8 payloads and bf16 scales made by the decoder's own quantizer
    from random K/V. The row in the kernels line is the mid-decode one."""
    from turbo_whisper_workspace_tpu_torch.models import whisper as wm

    b, k, h, d = 8, BEAM, 20, 64
    t = PROMPT + DECODE
    stats = {}

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    # self_attention_int8: the regathered cache of the B·K beam rows
    kq, ks = wm._quantize_kv_rows(randn(b * k, t, h * d), h)      # (B·K, H, T, 64)
    vq, vs = wm._quantize_kv_rows(randn(b * k, t, h * d), h)
    q = randn(b * k, h, 1, d).to(torch.bfloat16)
    args = (q, kq, ks, vq, vs)
    rows, errs = {}, {}
    for valid in (MID_DECODE, t):
        out = att.self_attention_int8(*args, valid)
        torch.cuda.synchronize()
        dropped = ({"valid_len mask": att.self_attention_int8_reference(*args, t)}
                   if valid < t else {})
        errs[valid] = compare(
            f"self_attention_int8 B·K={b * k} H={h} T={t} valid_len={valid}", out,
            att.self_attention_int8_reference(*args, valid), dropped)
        # K and V rows and their bf16 scales at t < valid_len, q and o
        rows[valid] = timed(f"self_attention_int8 valid_len={valid}",
                            lambda: att.self_attention_int8(*args, valid),
                            lambda: att.self_attention_int8_reference(*args, valid),
                            nbytes(q, out) + 2 * b * k * h * valid * (d + 2),
                            4 * b * k * h * valid * d, flush)
    stats["self_attention_int8"] = kernel_row(rows[MID_DECODE], errs)
    del kq, vq, ks, vs, args

    # self_attention_int8_lanes: lane panels of B items, K lanes each
    kq, ks = wm._quantize_kv_rows(randn(b, k * t, h * d), h)      # (B, H, K·T, 64)
    vq, vs = wm._quantize_kv_rows(randn(b, k * t, h * d), h)
    kp = kq.permute(0, 1, 3, 2).reshape(b, h * d, k * t).contiguous()
    vp = vq.permute(0, 2, 1, 3).reshape(b, k * t, h * d).contiguous()
    del kq, vq
    lane_map = random_ancestry(gen, b, k, t, dev)
    own_lanes = torch.arange(k, dtype=torch.int32, device=dev)[None, :, None].expand(
        b, k, t).contiguous()
    q = randn(b, h, k, d).to(torch.bfloat16)
    args = (q, kp, ks, vp, vs, lane_map)
    rows, errs = {}, {}
    for valid in (MID_DECODE, t):
        out = att.self_attention_int8_lanes(*args, valid)
        torch.cuda.synchronize()
        dropped = {"lane selection": att.self_attention_int8_lanes_reference(
            q, kp, ks, vp, vs, own_lanes, valid)}
        if valid < t:
            dropped["valid_len mask"] = att.self_attention_int8_lanes_reference(*args, t)
        errs[valid] = compare(
            f"self_attention_int8_lanes B={b} K={k} H={h} T={t} valid_len={valid}", out,
            att.self_attention_int8_lanes_reference(*args, valid), dropped)
        # the (lane, t) pairs some beam owns at t < valid_len: their K and V
        # bytes and bf16 scales in every head, and q, o, lane_map[..., :valid]
        owned = torch.zeros((b, k, valid), dtype=torch.bool, device=dev)
        owned.scatter_(1, lane_map[:, :, :valid].long(), True)
        pairs = int(owned.sum().item())
        rows[valid] = timed(
            f"self_attention_int8_lanes valid_len={valid}, {pairs} owned (lane, t) pairs "
            f"of {b * k * valid}", lambda: att.self_attention_int8_lanes(*args, valid),
            lambda: att.self_attention_int8_lanes_reference(*args, valid),
            nbytes(q, out) + pairs * h * 2 * (d + 2) + b * k * valid * 4,
            4 * b * h * k * valid * d, flush)
    stats["self_attention_int8_lanes"] = kernel_row(rows[MID_DECODE], errs)
    return stats


@contextlib.contextmanager
def plain_kernels(att):
    """Every kernel wrapper replaced by its plain version, for a run
    that must launch nothing."""
    kernels = {name: getattr(att, name) for name in att.launch_counts}
    counts = dict(att.launch_counts)
    for name in kernels:
        setattr(att, name, getattr(att, f"{name}_reference"))
    try:
        yield
    finally:
        for name, fn in kernels.items():
            setattr(att, name, fn)
    assert att.launch_counts == counts, "the plain run launched a kernel"


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
        with plain_kernels(att):
            feats_plain = model.encoder(mel)
            logits_plain, _ = model.decoder(prompt, cross_kv)
    e_feats, e_logits = rel_err(feats, feats_plain), rel_err(logits, logits_plain)
    print(f"full-width model vs its plain twin: encoder features rel err {e_feats:.3e}, "
          f"prefill logits rel err {e_logits:.3e} (tolerance {MODEL_TOL})")
    assert e_feats <= MODEL_TOL and e_logits <= MODEL_TOL


def check_beam_step(att, transcriber, audio: np.ndarray) -> None:
    """One beam-5 step of the full-width decoder with its kernels against
    the same step with the plain versions, after a quantized prefill of
    one window: over the lane cache (self_attention_int8_lanes) and over
    the regathered int8 cache (self_attention_int8); the cross-attention
    runs at Tq = 5."""
    from turbo_whisper_workspace_tpu_torch.models import whisper as wm
    from turbo_whisper_workspace_tpu_torch.ops import mel as mel_ops

    model, dev = transcriber.model, transcriber.device
    n_layer = model.dims.n_text_layer
    with torch.no_grad():
        cross_kv = transcriber._encode_windows(mel_ops.pad_or_trim(audio)[None])
        prompt = torch.tensor([transcriber._prompt_row("en")], device=dev)
        p = prompt.shape[1]
        cache = wm.init_kv_cache(model.dims, 1, max_len=p + 8, dtype=model.dtype,
                                 device=dev, quantize=True)
        _, cache = model.decoder(prompt, cross_kv, cache, pos=0)
        step = 220 + 1000 * torch.arange(BEAM, device=dev)[:, None]   # text tokens
        lane_map = torch.zeros((1, BEAM, p + 8), dtype=torch.int32, device=dev)
        lane_map[:, :, p] = torch.arange(BEAM, dtype=torch.int32, device=dev)
        modes = {
            "self_attention_int8_lanes": (wm.beam_lane_cache(cache, BEAM), lane_map),
            "self_attention_int8": ({key: x.repeat_interleave(BEAM, 1)
                                     for key, x in cache.items()}, None),
        }
        for kernel, (beam_cache, lanes) in modes.items():
            def run(c=beam_cache, lanes=lanes):
                # the decoder writes the cache in place: each run gets a copy
                c = {key: x.clone() for key, x in c.items()}
                return model.decoder(step, cross_kv, c, pos=p, beam=BEAM,
                                     lane_map=lanes)[0]

            before = dict(att.launch_counts)
            logits = run()
            launched = {n: att.launch_counts[n] - before[n] for n in before}
            assert launched[kernel] == n_layer, launched
            assert launched["cross_attention_int8"] == n_layer, launched
            with plain_kernels(att):
                logits_plain = run()
            e = rel_err(logits, logits_plain)
            print(f"full-width beam-{BEAM} step over the {kernel} cache vs its plain twin: "
                  f"logits rel err {e:.3e} (tolerance {MODEL_TOL}); launches {launched}")
            assert logits.shape == (BEAM, 1, model.dims.n_vocab) and e <= MODEL_TOL


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
    from turbo_whisper_workspace_tpu_torch.config import PipelineConfig, TranscriptionConfig
    from turbo_whisper_workspace_tpu_torch.decode import beam as beam_mod
    from turbo_whisper_workspace_tpu_torch.decode.tokenizer import LANGUAGES
    from turbo_whisper_workspace_tpu_torch.ops import attention as att
    from turbo_whisper_workspace_tpu_torch.ops import build
    from turbo_whisper_workspace_tpu_torch.pipeline.audio_pipeline import (
        AudioProcessingPipeline)
    from turbo_whisper_workspace_tpu_torch.pipeline.transcriber import load_transcriber

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
               "with per-head or per-position scales, or with a lane selection)"
               if s["library_ms"] is None
               else f"{s['library_ms']:.4f} ms")
        print(f"{name}: kernel {s['ms']:.4f} ms, plain {s['plain_ms']:.4f} ms, "
              f"library {lib}, bound {s['bound_ms']:.4f} ms ({s['bound_by']}) [{card}]")

    # 4. greedy main path at full width
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

    def request(pipeline, tr, path: str, label: str) -> None:
        audio, _ = audio_io.read_audio_file(path)
        t0 = time.perf_counter()
        res = pipeline.transcribe(path)
        wall = time.perf_counter() - t0
        check_result(res, len(audio) / 16000)
        print(f"{label} request {os.path.basename(path)}: {len(audio) / 16000:.1f} s audio, "
              f"{tr.last_n_windows} windows, wall {wall:.3f} s, "
              f"{len(audio) / 16000 / wall:.2f} audio-s/s, language "
              f"{res['language']}, {len(res['segments'])} segments [{card}]")

    def batch_call(tr, batch: list, label: str) -> None:
        t0 = time.perf_counter()
        results = tr.transcribe(batch)
        wall = time.perf_counter() - t0
        assert tr.last_n_windows == 8, tr.last_n_windows
        for res, audio in zip(results, batch):
            check_result(res, len(audio) / 16000)
        total = sum(len(a) for a in batch) / 16000
        print(f"{label} batch call: {len(batch)} files, {total:.1f} s audio, 8 windows, "
              f"wall {wall:.3f} s, {total / wall:.2f} audio-s/s [{card}]")

    def read_counts(path: str, kernels: tuple) -> dict:
        counts = dict(att.launch_counts)
        print(f"launches on the {path} path: {counts}")
        assert all(counts[name] > 0 for name in kernels), (path, counts)
        return counts

    path_counts = {}
    att.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        long_path = os.path.join(tmp, "synth_75s.wav")
        write_wav(long_path, synth_clip(75.0, seed=1))
        for path in (GOLDEN, long_path):
            request(pipe, transcriber, path, "greedy")
        # one batch of 8 windows: the 75 s clip (4), the golden clip (1)
        # and three more 15 s clips
        batch = [audio_io.read_audio_file(long_path)[0], golden] + [
            synth_clip(15.0, seed=s) for s in (2, 3, 4)]
        batch_call(transcriber, batch, "greedy")
    path_counts["greedy"] = read_counts("greedy", ("flash_attention", "cross_attention_int8"))

    # 5. beam path: beam 5 over the int8 lane self-KV cache, same model
    check_beam_step(att, transcriber, golden)
    beam_cfg = TranscriptionConfig(beam_size=BEAM)
    assert beam_cfg.quantize_self_kv and beam_cfg.max_decode_len == DECODE
    beam_tr = load_transcriber(transcriber.model, beam_cfg, device="cuda")
    att.reset_launch_counts()
    batch_call(beam_tr, batch, f"beam-{BEAM}")
    request(AudioProcessingPipeline(PipelineConfig(transcription=beam_cfg),
                                    transcriber=beam_tr, device="cuda"),
            beam_tr, GOLDEN, f"beam-{BEAM}")
    path_counts["beam"] = read_counts(
        "beam", ("flash_attention", "cross_attention_int8", "self_attention_int8_lanes"))

    # the same beam search called directly on a bucket's cross-KV, in each
    # cache mode (quantize_cache, lane_cache), in turns: ABCCBA
    modes = {"int8 lanes": ((True, True), ("self_attention_int8_lanes",)),
             "int8 regathered": ((True, False), ("self_attention_int8",)),
             "bf16 regathered": ((False, False), ())}
    windows = np.stack([synth_clip(30.0, seed=s) for s in range(5, 13)])
    with torch.no_grad():
        cross_kv = beam_tr._encode_windows(windows)
    prompt = torch.tensor([beam_tr._prompt_row("en")] * len(windows), device=dev)
    n_vocab = beam_tr.model.dims.n_vocab
    walls = {mode: [] for mode in modes}
    for mode in list(modes) + list(modes)[::-1]:
        (quantize_cache, lane_cache), kernels = modes[mode]
        att.reset_launch_counts()
        t0 = time.perf_counter()
        res = beam_mod.beam_decode_features(
            beam_tr.model, cross_kv, prompt, rules=beam_tr.rules, beam_size=BEAM,
            max_len=DECODE, quantize_cache=quantize_cache, lane_cache=lane_cache)
        torch.cuda.synchronize()
        walls[mode].append(time.perf_counter() - t0)
        assert res.tokens.shape == (len(windows), PROMPT + DECODE), res.tokens.shape
        assert res.all_tokens.shape == (len(windows), BEAM, PROMPT + DECODE)
        assert ((res.tokens >= 0) & (res.tokens < n_vocab)).all()
        assert ((res.lengths >= 0) & (res.lengths <= DECODE)).all()
        assert torch.isfinite(res.avg_logprobs).all() and torch.isfinite(res.all_scores).all()
        assert torch.equal(res.tokens[:, :PROMPT], prompt)
        print(f"beam-{BEAM} decode, {mode} self-KV cache: {len(windows)} windows, "
              f"{DECODE} steps max, wall {walls[mode][-1]:.3f} s, "
              f"lengths {res.lengths.tolist()} [{card}]")
        counts = read_counts(f"beam, {mode} cache", ("cross_attention_int8",) + kernels)
        path_counts[f"beam, {mode} cache"] = {
            name: n + path_counts.get(f"beam, {mode} cache", {}).get(name, 0)
            for name, n in counts.items()}
    for mode, ws in walls.items():
        print(f"beam-{BEAM} decode, {mode} self-KV cache: walls {ws[0]:.3f} and "
              f"{ws[1]:.3f} s, {len(windows) * 30 / statistics.mean(ws):.2f} audio-s/s "
              f"[{card}]")

    lines = []
    for name, s in stats.items():
        lines.append({
            "name": name, "route": "cuda",
            "source": f"turbo_whisper_workspace_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": sum(counts[name] for counts in path_counts.values()), **s,
        })
    print(json.dumps({"kernels": lines}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
