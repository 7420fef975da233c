#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (turbo_whisper_workspace_tpu_torch).

    python3 chip_smoke.py        # from the repo root, on a machine with one
                                 # NVIDIA GPU, nvcc and PyTorch built for CUDA

Phases, in order; any failure ends the run with a non-zero exit:

1. environment: the card's name and power limit, torch and CUDA versions;
   TF32 off for float32 products and convolutions;
2. build: compiles the ten CUDA kernels from csrc/ (one nvcc each, in
   parallel);
3. kernels against their plain PyTorch versions at large-v3-turbo shapes
   in bf16 (flash_attention B=8 H=20 T=1500 on (B, T, H·64) projections
   viewed as heads, as the encoder calls it; cross_attention_int8 B=8
   H=20 Tq 1, 4, 5 (the beam step) and 35 (a prompted first step), Tpad
   1536; cross_attention_s8 on the same K/V at Tq 1, 5 and 35 and
   seq_len 1500 and 1536, also held within 3% mean relative of
   cross_attention_int8, its cluster plan printed and held to more than
   one rank; self_attention_int8 over the regathered int8 cache of
   B·K=40 beam rows and self_attention_int8_lanes over the lane cache of
   B=8 items, K=5 beams and a random beam ancestry, both at H=20,
   T=P+224=227 and valid_len 115 (mid-decode) and 227 (last step), the
   lane kernel also at valid_len 3 (the prompt: lane 0 alone) and at
   K=8, T=448, with the 32-byte sectors of the K panel its owned pairs
   touch): max abs error within 2e-2 and relative L2 error within 5e-3,
   and each mask the kernel must apply (keys past the sequence, past
   valid_len, of lanes a beam does not own) dropped from the plain
   version must read above that limit (the script prints those
   readings), and the median of 25 timed runs (CUDA events, L2 flushed
   before each run) of the kernel, the plain version and, where one
   exists, the one PyTorch call computing the same function, beside the
   least time the card could take; for the redesigned kernels
   (flash_attention, cross_attention_int8 and cross_attention_s8 at Tq 1
   and 5, self_attention_int8_lanes at valid_len 115 and 227 here,
   int4_matmul and int4_matmul_s8 in phase 7) also a back-to-back time
   (20 launches in one CUDA graph over input copies larger than the L2
   cache, per launch) beside the earlier design's single-launch time;
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
   regathered calls self_attention_int8;
6. the s8 route (TranscriptionConfig(cross_attention_s8=True)), same
   model: one decode step of the decoder with the route on against the
   same step with the plain versions (logits); then, with the counts
   zeroed before and read after each, one batch call of
   Transcriber.transcribe on the same 8 windows greedy and one at beam 5;
   each must launch cross_attention_s8 and not cross_attention_int8;
7. the LLM enrichment path (llama-3.1-8b at full width, random bf16
   weights from seed 0 drawn on the card, then quantized there by
   quantize_tree at quantize_bits=4: int4 body, int8 lm_head):
   int8_matmul, int4_matmul and int4_matmul_s8 against their plain
   versions at each of the path's shapes and one small ragged shape
   each (int4_matmul also at the longest stage prompt's 1748 rows, and
   the ragged shape again at G = 16; beside it torch.matmul on the
   pre-dequantized bf16 weight as a dense-GEMM yardstick), max abs
   error within 2e-2 × max|ref| and relative L2 within
   5e-3, each wrong reading of the weight layout (nibble halves swapped,
   nibbles not sign-extended, the scale of the wrong group or column)
   read above that limit, timed as in phase 3; int4_matmul_s8 also
   bit-equal to its plain version at every shape; the quantizers on the
   card bit-equal to the same call on the CPU for one full-width weight;
   the model's prefill of a 512-token prompt and one decode step within
   5e-2 relative L2 of the same model with the plain versions, with the
   hidden state's error after each layer printed, and as a control the
   plain twin against itself with TF32 sums; a torch.profiler window
   over one 1748-token prefill (device time by kernel); then, with the
   counts zeroed, the stage end to end:
   TorchLlama injected with set_llm, and AudioProcessingPipeline's
   identify_speaker_names, generate_summary and extract_topics on a
   20-segment two-speaker conversation, timed (prefill ms, ms per decode
   step, tokens/s); all three kernels must have been launched. Last, a
   torch.profiler window over three decode steps: host wall against
   device busy time per step, launches per step, the heaviest kernels;
8. the LLM-ops profiler path at full llama-3.2-3b width: s8_matmul and
   s8g4_matmul against their plain versions at the profiler's m = 1
   shapes (3072→3072, →1024, →8192, 8192→3072, the head 3072→128256), at
   M = 8 and one ragged shape, with the limits and wrong readings of
   phase 7 (s8g4_matmul also equal to int4_matmul_s8 on the same
   inputs), timed, with torch._int_mm plus the rescale timed at M = 32
   as the library context (it takes no M ≤ 16); then, with the counts
   zeroed, profile_llm_ops.main --steps 8 --iters 2, whose JSON of ms
   per step is printed; both kernels must have been launched there.

Prints a `kernels` JSON line (launches summed over the runs of phases 4
to 8; every one of the ten kernels must have been launched), then as
its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero, printing no result, when CUDA is unavailable.

    python3 chip_smoke.py --prefill-profile

builds the kernels and runs only phase 7's prefill profile (no result
line): copied into an older tree of the port, it measures that tree's
prefill the same way.

    python3 chip_smoke.py --before TREE

times the kernels whose earlier design BEFORE_MS holds shape by shape
(int8_matmul, s8_matmul) built from TREE, an unpacked earlier commit
(`git archive <rev> | tar -x -C build/parent`), against this checkout's,
in turns at each shape (no result line): the source of those "before"
times.
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
PEAK_INT8_OPS = 1979e12    # H100 SXM dense int8
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
RUNS = 25
BACK_TO_BACK = 20          # launches in a row for the back-to-back time
L2_BYTES = 50e6            # H100 L2: the back-to-back inputs exceed it
# the redesigned kernels' single-launch times in their earlier design
# (PERF.md's kernel table, "Before"; NVIDIA H100 80GB HBM3, 700.00 W),
# printed beside this run's: one time, or one a shape (M, K, N) where the
# kernel is timed at several (a shape not listed: not measured)
BEFORE_MS = {"flash_attention": 1.7712, "int4_matmul_s8": 0.0339,
             "cross_attention_int8": 0.0560, "int4_matmul": 0.8286,
             "cross_attention_s8": 0.0448, "self_attention_int8_lanes": 0.0548,
             # (512, 4096, 128256) and (1, 3072, 8192) from the table; the
             # rest the earlier sources timed by `chip_smoke.py --before`
             "int8_matmul": {(512, 4096, 128256): 7.6014, (1748, 4096, 128256): 23.1491,
                             (1, 4096, 128256): 0.9393, (1, 3072, 8192): 0.2119,
                             (1, 3072, 3072): 0.2052, (1, 3072, 1024): 0.2008,
                             (1, 8192, 3072): 0.5362, (1, 3072, 128256): 0.7040},
             "s8_matmul": {(1, 3072, 8192): 0.0270, (1, 3072, 3072): 0.0164,
                           (1, 3072, 1024): 0.0155, (1, 8192, 3072): 0.0360,
                           (1, 3072, 128256): 0.1811}}
# cross_attention_s8's mean relative distance from cross_attention_int8
# in its earlier design (same check, same card), printed beside this run's
S8_VS_INT8_BEFORE = "2.72-2.73e-2"
REPLACES = {
    "flash_attention": "turbo_whisper_workspace_tpu/ops/attention.py:55",
    "cross_attention_int8": "turbo_whisper_workspace_tpu/ops/attention.py:202",
    "cross_attention_s8": "turbo_whisper_workspace_tpu/ops/attention.py:298",
    "self_attention_int8": "turbo_whisper_workspace_tpu/ops/attention.py:384",
    "self_attention_int8_lanes": "turbo_whisper_workspace_tpu/ops/attention.py:497",
    "int8_matmul": "turbo_whisper_workspace_tpu/ops/quant.py:41",
    "int4_matmul": "turbo_whisper_workspace_tpu/ops/quant.py:151",
    "int4_matmul_s8": "turbo_whisper_workspace_tpu/ops/quant.py:260",
    "s8_matmul": "scripts/profile_llm_ops.py:86",
    "s8g4_matmul": "scripts/profile_llm_ops.py:150",
}
LLM = "llama-3.1-8b"
LLM_PROMPT = 512           # tokens of the prefill the model check runs
LLM_LONG_PROMPT = 1748      # tokens of the longest stage prompt (the summary's)
# phase 7's (M, K, N) per kernel: the LLM path's shapes at M = LLM_PROMPT
# prefill rows or the decode step's M = 1 (and the route's largest, 8),
# then one small ragged shape; the first is the kernels line's row.
# int8_matmul also runs the head at the longest prompt's rows and at the
# decode step's M = 1 (its GEMV regime, the m <= 8 route on the card).
# int4_matmul also runs the gate/up shape at the longest prompt's rows,
# and the ragged shape again at G = 16 (a fourth entry: the group size)
QUANT_SHAPES = {
    "int8_matmul": ((LLM_PROMPT, 4096, 128256), (LLM_LONG_PROMPT, 4096, 128256),
                    (1, 4096, 128256), (LLM_PROMPT, 4096, 4096), (3, 256, 1000)),
    "int4_matmul": ((LLM_PROMPT, 4096, 14336), (LLM_LONG_PROMPT, 4096, 14336),
                    (LLM_PROMPT, 14336, 4096), (LLM_PROMPT, 4096, 4096),
                    (LLM_PROMPT, 4096, 1024), (3, 256, 1000), (3, 256, 1000, 16)),
    "int4_matmul_s8": ((1, 4096, 14336), (1, 14336, 4096), (1, 4096, 4096), (1, 4096, 1024),
                       (8, 4096, 14336), (8, 14336, 4096), (3, 256, 1000)),
}
PROFILER = "llama-3.2-3b"
# phase 8's (M, K, N) for both profiler kernels: llama-3.2-3b's m = 1
# projections (gate/up first: the kernels line's row), its lm_head, the
# largest M of the W4A8 route and one small ragged shape
S8_SHAPES = ((1, 3072, 8192), (1, 3072, 3072), (1, 3072, 1024), (1, 8192, 3072),
             (1, 3072, 128256), (8, 3072, 8192), (3, 256, 1000))
LIBRARY_M = 32             # torch._int_mm takes M > 16 only


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, flush: torch.Tensor, runs: int = RUNS) -> float:
    """Median ms of `runs` calls after 3 warm-up calls; the L2 cache is
    flushed (a 256 MB write) before each timed call."""
    for _ in range(3):
        fn()
    events = []
    for _ in range(runs):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def back_to_back_ms(fn, copies: list, flush: torch.Tensor) -> float:
    """Device ms per launch of BACK_TO_BACK launches in a row, launch i
    on copies[i % len(copies)] of the inputs (over L2_BYTES in all, and
    the L2 cache flushed before the window, so every launch reads HBM).
    The launches are captured once in a CUDA graph and replayed between
    the two events: the window holds no host dispatch, which a window of
    eager launches shorter than ~40 µs each would."""
    for args in copies:
        fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(BACK_TO_BACK):
            fn(*copies[i % len(copies)])
    graph.replay()
    flush.zero_()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / BACK_TO_BACK


def input_copies(args: tuple, n_bytes: int) -> list:
    """args and enough clones of its tensors (at most BACK_TO_BACK in
    all) that the copies hold more than L2_BYTES."""
    n = min(BACK_TO_BACK, max(2, math.ceil(L2_BYTES / n_bytes) + 1))
    return [args] + [tuple(a.clone() for a in args) for _ in range(n - 1)]


def print_redesigned(name: str, label: str, single: float, b2b: float, copies: list,
                     card: str, shape: tuple | None = None) -> None:
    before = BEFORE_MS[name] if shape is None else BEFORE_MS[name].get(shape)
    was = "not measured" if before is None else f"{before:.4f} ms"
    total = sum(nbytes(*args) for args in copies)
    print(f"{label}: single launch {single:.4f} ms (before the redesign: {was}), "
          f"back-to-back {b2b:.4f} ms per launch ({BACK_TO_BACK} in a row over "
          f"{len(copies)} copies, {total / 1e6:.0f} MB) [{card}]")


def bound_ms(n_bytes: float, n_ops: float,
             peak_ops: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    got, ref = got.float(), ref.float()
    assert torch.isfinite(got).all() and got.shape == ref.shape
    return ((got - ref).norm() / ref.norm()).item()


def compare(name: str, got: torch.Tensor, ref: torch.Tensor, dropped: dict,
            relative_max: bool = False):
    """Max abs and relative L2 error of a kernel against its plain
    version; `dropped` maps each mask the kernel must apply (or each
    wrong reading of its layout) to the plain version run without it, an
    error the relative check must catch. With `relative_max` the max abs
    limit is KERNEL_TOL × max|ref| (outputs not of order one)."""
    err = (got.float() - ref.float()).abs().max().item()
    rel = rel_err(got, ref)
    tol = KERNEL_TOL * (ref.float().abs().max().item() if relative_max else 1.0)
    misses = {what: rel_err(out, ref) for what, out in dropped.items()}
    shown = "".join(f"; without the {what} {m:.3e}" for what, m in misses.items())
    print(f"{name}: max_abs_err {err:.3e} (tolerance {tol:.3e}), rel_l2_err "
          f"{rel:.3e} (tolerance {KERNEL_REL_TOL}{shown})")
    assert math.isfinite(err) and err <= tol and rel <= KERNEL_REL_TOL, (err, rel)
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


def check_kernels(att, dev, card: str) -> dict:
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
    copies = input_copies((q, k, v), nbytes(q, k, v))
    print_redesigned("flash_attention", f"flash_attention B={b} H={h} T={t}",
                     stats["flash_attention"]["ms"],
                     back_to_back_ms(att.flash_attention, copies, flush), copies, card)
    del q, k, v, out, copies

    seq_len = 1500
    kv = att.quantize_cross_kv_int8(
        torch.randn(1, b, h, seq_len, d, generator=gen, device=dev).to(torch.bfloat16),
        torch.randn(1, b, h, seq_len, d, generator=gen, device=dev).to(torch.bfloat16))
    kq, vq, ks, vs = kv["k_q"][0], kv["v_q"][0], kv["k_scale"][0], kv["v_scale"][0]
    rows, errs = {}, {}
    # Tq 35: a prompted first step, five chunks of query rows
    for tq in (1, 4, BEAM, 35):
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
        if tq in (1, BEAM):
            copies = input_copies(args, nbytes(*args))
            print_redesigned(
                "cross_attention_int8", f"cross_attention_int8 B={b} H={h} Tq={tq} "
                f"(plan: ranks, slice, rows {att.cross_int8_plan(tq, kq.shape[-1])})",
                rows[tq]["ms"], back_to_back_ms(
                    lambda *a: att.cross_attention_int8(*a, seq_len=seq_len), copies, flush),
                copies, card)
    # the greedy decode step's shape, Tq = 1, is the row in the kernels line
    stats["cross_attention_int8"] = kernel_row(rows[1], errs)
    stats["cross_attention_s8"] = check_cross_s8(att, dev, gen, flush, kv, seq_len, card)
    del kv, kq, vq, ks, vs
    stats.update(check_self_kernels(att, dev, gen, flush, card))
    return stats


def check_cross_s8(att, dev, gen, flush, kv: dict, seq_len: int, card: str) -> dict:
    """Phase 3, cross_attention_s8 on cross_attention_int8's K/V: the s8
    route's decode step (Tq = 1, the row in the kernels line), beam step
    (Tq = 5) and a prompted first step (Tq = 35), with the mask live
    (seq_len 1500) and off (1536); also within 3% mean relative of
    cross_attention_int8 on the same inputs
    (tests/test_attention_kernel.py:142-164). The kernel launches one
    cluster per (b, h) on cross_int8_plan: more than one rank here."""
    kq, vq, ks, vs = kv["k_q"][0], kv["v_q"][0], kv["k_scale"][0], kv["v_scale"][0]
    b, h, d, tpad = kq.shape
    rows, errs = {}, {}
    for tq in (1, BEAM, 35):
        plan = att.cross_int8_plan(tq, tpad)
        assert plan[0] > 1, plan
        qc = torch.randn(b, h, tq, d, generator=gen, device=dev).to(torch.bfloat16)
        args = (qc, kq, vq, ks, vs)
        for valid in (seq_len, tpad):
            out = att.cross_attention_s8(*args, seq_len=valid)
            torch.cuda.synchronize()
            dropped = ({"key mask": att.cross_attention_s8_reference(*args, seq_len=tpad)}
                       if valid < tpad else {})
            errs[(tq, valid)] = compare(
                f"cross_attention_s8 B={b} H={h} Tq={tq} Tpad={tpad} seq_len={valid}", out,
                att.cross_attention_s8_reference(*args, seq_len=valid), dropped)
            int8 = att.cross_attention_int8(*args, seq_len=valid).float()
            mean_rel = ((out.float() - int8).abs().mean() / int8.abs().mean()).item()
            print(f"  against cross_attention_int8 on the same inputs: mean relative "
                  f"{mean_rel:.3e} (limit 0.03; {S8_VS_INT8_BEFORE} in the earlier design)")
            assert mean_rel < 0.03, mean_rel
        # the kernel reads K and V only at t < seq_len, each once; s8 x s8 products
        rows[tq] = timed(f"cross_attention_s8 B={b} H={h} Tq={tq}",
                         lambda: att.cross_attention_s8(*args, seq_len=seq_len),
                         lambda: att.cross_attention_s8_reference(*args, seq_len=seq_len),
                         nbytes(qc, ks, vs, out) + 2 * b * h * d * seq_len,
                         4 * b * h * tq * seq_len * d, flush, peak_ops=PEAK_INT8_OPS)
        if tq in (1, BEAM):
            copies = input_copies(args, nbytes(*args))
            print_redesigned(
                "cross_attention_s8", f"cross_attention_s8 B={b} H={h} Tq={tq} "
                f"(plan: ranks, slice, rows {plan})", rows[tq]["ms"], back_to_back_ms(
                    lambda *a: att.cross_attention_s8(*a, seq_len=seq_len), copies, flush),
                copies, card)
    return kernel_row(rows[1], errs)


def timed(label: str, kernel, plain, n_bytes: float, n_ops: float, flush,
          peak_ops: float = PEAK_BF16_FLOPS) -> dict:
    """The kernel's and its plain version's times beside the bound."""
    ms, plain_ms = time_ms(kernel, flush), time_ms(plain, flush)
    bms, by = bound_ms(n_bytes, n_ops, peak_ops)
    print(f"{label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms ({by})")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": None}


def kernel_row(row: dict, errs: dict) -> dict:
    """One shape's times with the worst errors over every shape checked."""
    return {**row, "max_abs_err": max(e for e, _ in errs.values()),
            "rel_l2_err": max(r for _, r in errs.values())}


def check_self_kernels(att, dev, gen, flush, card: str) -> dict:
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

    # self_attention_int8_lanes: lane panels of B items, K lanes each, at
    # the beam phase's K = 5 (the row in the kernels line: mid-decode) and
    # at K = 8 over Whisper's whole 448-position context
    rows, errs = check_lanes(att, wm, dev, gen, flush, card, b, k, h, t,
                             (PROMPT, MID_DECODE, t), redesigned=(MID_DECODE, t))
    _, errs8 = check_lanes(att, wm, dev, gen, flush, card, b, 8, h, 448, (PROMPT, 224, 448))
    errs.update({(8, valid): e for valid, e in errs8.items()})
    stats["self_attention_int8_lanes"] = kernel_row(rows[MID_DECODE], errs)
    return stats


def k_panel_sectors(lane_map: torch.Tensor, valid: int, h: int) -> tuple[int, int]:
    """(owned (lane, t) pairs, 32-byte sectors of the K panel (B, H·64,
    K·T) their bytes lie in, over every head): a pair's 64 K bytes per
    head sit in 64 rows K·T bytes apart, so the sectors, not the bytes,
    are the HBM traffic of reading them."""
    b, k, t = lane_map.shape
    owned = torch.zeros((b, k, valid), dtype=torch.bool, device=lane_map.device)
    owned.scatter_(1, lane_map[:, :, :valid].long(), True)
    bi, li, ti = owned.nonzero(as_tuple=True)
    rows = torch.arange(h * 64, device=lane_map.device)
    addr = (bi[:, None] * h * 64 + rows[None]) * (k * t) + (li * t + ti)[:, None]
    return int(bi.numel()), int(torch.unique(addr // 32).numel())


def check_lanes(att, wm, dev, gen, flush, card: str, b: int, k: int, h: int, t: int,
                valids: tuple, redesigned: tuple = ()) -> tuple[dict, dict]:
    """self_attention_int8_lanes on lane panels of B items, K lanes each
    (made by the decoder's own quantizer from random K/V) over a random
    beam ancestry: at each valid_len against its plain version, with the
    lane selection and the valid_len mask dropped, timed, and beside
    the bound the K panel's sectors its owned pairs touch; at the
    `redesigned` valid_lens also back to back."""
    d = 64

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

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
    for valid in valids:
        out = att.self_attention_int8_lanes(*args, valid)
        torch.cuda.synchronize()
        dropped = {"lane selection": att.self_attention_int8_lanes_reference(
            q, kp, ks, vp, vs, own_lanes, valid)}
        if valid < t:
            dropped["valid_len mask"] = att.self_attention_int8_lanes_reference(*args, t)
        errs[valid] = compare(
            f"self_attention_int8_lanes B={b} K={k} H={h} T={t} valid_len={valid} "
            f"(plan: ranks, slice {att.lanes_plan(valid)})", out,
            att.self_attention_int8_lanes_reference(*args, valid), dropped)
        # the (lane, t) pairs some beam owns at t < valid_len: their K and V
        # bytes and bf16 scales in every head, and q, o, lane_map[..., :valid]
        pairs, sectors = k_panel_sectors(lane_map, valid, h)
        rows[valid] = timed(
            f"self_attention_int8_lanes K={k} T={t} valid_len={valid}, {pairs} owned "
            f"(lane, t) pairs of {b * k * valid}",
            lambda: att.self_attention_int8_lanes(*args, valid),
            lambda: att.self_attention_int8_lanes_reference(*args, valid),
            nbytes(q, out) + pairs * h * 2 * (d + 2) + b * k * valid * 4,
            4 * b * h * k * valid * d, flush)
        print(f"  K panel: the owned pairs' bytes lie in {sectors} 32-byte sectors "
              f"({sectors * 32 / 1e6:.2f} MB, {sectors * 32 / PEAK_BYTES * 1e3:.4f} ms at "
              f"3.35 TB/s)")
        if valid in redesigned:
            copies = input_copies(args, nbytes(*args))
            print_redesigned(
                "self_attention_int8_lanes", f"self_attention_int8_lanes B={b} K={k} H={h} "
                f"T={t} valid_len={valid}", rows[valid]["ms"], back_to_back_ms(
                    lambda *a: att.self_attention_int8_lanes(*a, valid), copies, flush),
                copies, card)
    return rows, errs


@contextlib.contextmanager
def plain_kernels(*modules):
    """Every kernel wrapper of the given modules (ops/attention.py,
    ops/quant.py) replaced by its plain version, for a run that must
    launch nothing."""
    kernels = {(mod, name): getattr(mod, name) for mod in modules
               for name in mod.launch_counts}
    counts = [dict(mod.launch_counts) for mod in modules]
    for mod, name in kernels:
        setattr(mod, name, getattr(mod, f"{name}_reference"))
    try:
        yield
    finally:
        for (mod, name), fn in kernels.items():
            setattr(mod, name, fn)
    assert [mod.launch_counts for mod in modules] == counts, "the plain run launched a kernel"


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


def check_s8_step(att, transcriber, audio: np.ndarray) -> None:
    """One decode step of the full-width decoder on the s8 route (after
    its prefill, bf16 self cache) against the same step with the plain
    versions: cross_attention_s8 in every layer, cross_attention_int8 in
    none."""
    from turbo_whisper_workspace_tpu_torch.models import whisper as wm
    from turbo_whisper_workspace_tpu_torch.ops import mel as mel_ops

    model, dev = transcriber.model, transcriber.device
    n_layer = model.dims.n_text_layer
    with torch.no_grad():
        cross_kv = transcriber._encode_windows(mel_ops.pad_or_trim(audio)[None])
        prompt = torch.tensor([transcriber._prompt_row("en")], device=dev)
        p = prompt.shape[1]
        cache = wm.init_kv_cache(model.dims, 1, max_len=p + 8, dtype=model.dtype, device=dev)
        _, cache = model.decoder(prompt, cross_kv, cache, pos=0, cross_s8=True)
        step = torch.tensor([[220]], device=dev)

        def run():
            # the decoder writes the cache in place: each run gets a copy
            c = {key: x.clone() for key, x in cache.items()}
            return model.decoder(step, cross_kv, c, pos=p, cross_s8=True)[0]

        before = dict(att.launch_counts)
        logits = run()
        launched = {n: att.launch_counts[n] - before[n] for n in before}
        with plain_kernels(att):
            logits_plain = run()
    e = rel_err(logits, logits_plain)
    print(f"full-width decode step on the s8 route vs its plain twin: logits rel err "
          f"{e:.3e} (tolerance {MODEL_TOL}); launches {launched}")
    assert launched["cross_attention_s8"] == n_layer, launched
    assert launched["cross_attention_int8"] == 0, launched
    assert logits.shape == (1, 1, model.dims.n_vocab) and e <= MODEL_TOL


# ---------------------------------------------------------------------------
# Phase 7: the LLM enrichment path


def wrong_nibbles(tq, w_q4: torch.Tensor) -> dict:
    """The packed (K/2, N) weight's (lo, hi) nibbles read in each wrong
    way the relative check must catch."""
    lo, hi = tq._unpack_int4(w_q4)
    w32 = w_q4.to(torch.int32)
    return {"low/high nibble order": (hi, lo),
            "sign extension": (w32 & 15, (w32 >> 4) & 15)}


def library_int8(x, w_q, scale, flush):
    """torch._weight_int8pack_mm (x @ (int8 W · per-column scale), W as
    (N, K)) where this torch has a CUDA kernel for it: (ms, None), else
    (None, the reason). A call slower than 100 ms (M = 512 takes about
    0.6 s) is timed over 3 runs instead of RUNS."""
    try:
        w_nk = w_q.t().contiguous()
        s = scale.to(x.dtype)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch._weight_int8pack_mm(x, w_nk, s)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
    except (RuntimeError, NotImplementedError, AttributeError) as e:
        return None, f"torch._weight_int8pack_mm: {str(e).splitlines()[0][:120]}"
    ms = time_ms(lambda: torch._weight_int8pack_mm(x, w_nk, s), flush,
                 runs=3 if first > 0.1 else RUNS)
    del w_nk
    return ms, None


def check_quant_kernels(tq, dev, card: str) -> dict:
    """Phase 7: each quantized-matmul kernel against its plain version
    at the LLM path's shapes in bf16 and one ragged shape, with the wrong
    layout readings shown to matter, timed. The row in the kernels line
    is the first shape of each kernel (the path's heaviest use)."""
    gen = torch.Generator(dev).manual_seed(1)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    stats = {}

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def weight(k, n, bits):
        w = randn(k, n) * k ** -0.5
        return tq.quantize_int8(w) if bits == 8 else tq.quantize_int4(w)

    # int8_matmul: the lm_head at the prefill (512 and 1748 rows, the wgmma
    # ring) and at a decode step (M = 1, the GEMV), the body at
    # quantize_bits=8, ragged
    rows, errs, notes = {}, {}, {}
    for m, k, n in QUANT_SHAPES["int8_matmul"]:
        x = randn(m, k).to(torch.bfloat16)
        q = weight(k, n, 8)
        wq, sc = q["w_q"], q["scale"]
        label = f"int8_matmul M={m} K={k} N={n}"
        out = tq.int8_matmul(x, wq, sc)
        torch.cuda.synchronize()
        ref = tq.int8_matmul_reference(x, wq, sc)
        errs[(m, k, n)] = compare(
            f"{label} (plan {tq.int8_plan(m, k, n)})", out, ref,
            {"right column's scale": tq.int8_matmul_reference(x, wq, sc.roll(1))},
            relative_max=True)
        del ref
        row = timed(label, lambda: tq.int8_matmul(x, wq, sc),
                    lambda: tq.int8_matmul_reference(x, wq, sc),
                    nbytes(x, wq, sc, out), 2 * m * k * n, flush)
        if (m, k, n) in BEFORE_MS["int8_matmul"]:
            copies = input_copies((x, wq, sc), nbytes(x, wq, sc))
            print_redesigned("int8_matmul", label, row["ms"],
                             back_to_back_ms(tq.int8_matmul, copies, flush), copies, card,
                             (m, k, n))
            del copies
        lib, why = library_int8(x, wq, sc, flush)
        row["library_ms"], notes[(m, k, n)] = lib, why
        w_deq = (wq.to(torch.bfloat16) * sc.to(torch.bfloat16))
        print(f"{label}: library "
              f"{'%.4f ms' % lib if lib is not None else 'none (' + why + ')'}; cuBLAS bf16 "
              f"on the pre-dequantized weight (context only) "
              f"{time_ms(lambda: x @ w_deq, flush):.4f} ms")
        if m <= 8:
            # the m <= 8 route the CPU keeps: the dequant matmul, which
            # writes and reads a bf16 copy of W every call
            print(f"{label}: the dequant route (_int8_matmul_xla) "
                  f"{time_ms(lambda: tq._int8_matmul_xla(x, wq, sc), flush):.4f} ms, the kernel "
                  f"{row['ms']:.4f} ms [{card}]")
        rows[(m, k, n)] = row
        del x, q, wq, sc, out, w_deq
    first = QUANT_SHAPES["int8_matmul"][0]
    stats["int8_matmul"] = kernel_row(rows[first], errs)
    stats["int8_matmul"]["library_note"] = notes[first]

    # int4_matmul: the body prefill's four shapes (gate/up, down, q/out, k/v), ragged
    rows, errs = {}, {}
    for m, k, n, *group in QUANT_SHAPES["int4_matmul"]:
        x = randn(m, k).to(torch.bfloat16)
        q = tq.quantize_int4(randn(k, n) * k ** -0.5, *group)
        wq, sc = q["w_q4"], q["scale4"]
        label = f"int4_matmul M={m} K={k} N={n} G={k // sc.shape[0]}"
        out = tq.int4_matmul(x, wq, sc)
        torch.cuda.synchronize()
        ref = tq.int4_matmul_reference(x, wq, sc)
        dropped = {what: tq._int4_from_halves(x, lo, hi, sc)
                   for what, (lo, hi) in wrong_nibbles(tq, wq).items()}
        dropped["right group's scale"] = tq.int4_matmul_reference(x, wq, sc.roll(1, 0))
        errs[(m, k, n, *group)] = compare(f"{label} (K split {tq.int4_plan(m, k, n)})", out,
                                          ref, dropped, relative_max=True)
        del ref
        rows[(m, k, n, *group)] = timed(label, lambda: tq.int4_matmul(x, wq, sc),
                                        lambda: tq.int4_matmul_reference(x, wq, sc),
                                        nbytes(x, wq, sc, out), 2 * m * k * n, flush)
        if m >= LLM_PROMPT:
            copies = input_copies((x, wq, sc), nbytes(x, wq, sc))
            print_redesigned("int4_matmul", label, rows[(m, k, n, *group)]["ms"],
                             back_to_back_ms(tq.int4_matmul, copies, flush), copies, card)
            del copies
        lo, hi = tq._dequant4_halves(wq, sc, k)
        w_deq = torch.cat([lo, hi])
        # a dense-GEMM yardstick, not a library call of this function: it
        # takes the weight already dequantized, which the port never holds
        print(f"{label}: library none (no PyTorch call takes this packing); dense-GEMM "
              f"yardstick, torch.matmul on the pre-dequantized bf16 weight "
              f"{time_ms(lambda: x @ w_deq, flush):.4f} ms")
        del x, q, wq, sc, out, lo, hi, w_deq
    stats["int4_matmul"] = kernel_row(rows[QUANT_SHAPES["int4_matmul"][0]], errs)

    # int4_matmul_s8: the decode step's four shapes (M = 1), the route's largest M, ragged
    rows, errs = {}, {}
    for m, k, n in QUANT_SHAPES["int4_matmul_s8"]:
        q = weight(k, n, 4)
        wq, sc = q["w_q4"], q["scale4"]
        xq, xs = tq.quant_act_grouped(randn(m, k), sc.shape[0])
        out = tq.int4_matmul_s8(xq, xs, wq, sc)
        torch.cuda.synchronize()
        ref = tq.int4_matmul_s8_reference(xq, xs, wq, sc)
        dropped = {what: tq._s8_from_halves(xq, xs, lo, hi, sc)
                   for what, (lo, hi) in wrong_nibbles(tq, wq).items()}
        dropped["right group's scale"] = tq.int4_matmul_s8_reference(xq, xs, wq, sc.roll(1, 0))
        errs[(m, k, n)] = compare(f"int4_matmul_s8 M={m} K={k} N={n}", out, ref, dropped,
                                  relative_max=True)
        same = torch.equal(out, ref)
        print(f"  bit-equal to its plain version: {same}")
        assert same
        # the packed weight and its scales, xq, xs and the bf16 output
        label = f"int4_matmul_s8 M={m} K={k} N={n}"
        rows[(m, k, n)] = timed(label, lambda: tq.int4_matmul_s8(xq, xs, wq, sc),
                                lambda: tq.int4_matmul_s8_reference(xq, xs, wq, sc),
                                nbytes(xq, xs, wq, sc, out), 2 * m * k * n, flush,
                                peak_ops=PEAK_INT8_OPS)
        copies = input_copies((xq, xs, wq, sc), nbytes(xq, xs, wq, sc))
        print_redesigned("int4_matmul_s8", label, rows[(m, k, n)]["ms"],
                         back_to_back_ms(tq.int4_matmul_s8, copies, flush), copies, card)
        del q, wq, sc, xq, xs, out, ref, copies
    print("int4_matmul_s8: library none (no PyTorch call takes int4 weights packed in "
          "halves with grouped int8 activations)")
    stats["int4_matmul_s8"] = kernel_row(rows[QUANT_SHAPES["int4_matmul_s8"][0]], errs)
    return stats


def check_quantizer(tq, dev) -> None:
    """The quantizers on the card give the CPU's bytes for one
    full-width weight (the gate projection, 4096 × 14336)."""
    gen = torch.Generator(dev).manual_seed(2)
    w = torch.randn(4096, 14336, generator=gen, device=dev) * 4096 ** -0.5
    w_cpu = w.cpu()
    for name, fn in (("quantize_int4", tq.quantize_int4), ("quantize_int8", tq.quantize_int8)):
        on_card, on_cpu = fn(w), fn(w_cpu)
        for key in on_card:
            assert torch.equal(on_card[key].cpu(), on_cpu[key]), (name, key)
        print(f"{name} of a 4096 x 14336 weight: bit-equal on the card and the CPU")


@contextlib.contextmanager
def residual_stream(lm):
    """Records the residual stream of each lm.forward run inside: the
    value entering every RMSNorm, in call order ([2l] enters layer l,
    [2l + 1] follows its attention, the last enters the final norm)."""
    seen = []
    rms_norm = lm.rms_norm

    def recording(x, p, eps):
        seen.append(x.clone())
        return rms_norm(x, p, eps)

    lm.rms_norm = recording
    try:
        yield seen
    finally:
        lm.rms_norm = rms_norm


def layer_errors(got: list, ref: list) -> str:
    """Relative error of the hidden state after each layer."""
    return " ".join(f"{rel_err(a, b):.2e}" for a, b in zip(got[2::2], ref[2::2]))


def check_llm_model(tq, lm, params, dims, dev) -> None:
    """The full-width model with its kernels against the same model with
    the plain versions: the prefill of a LLM_PROMPT-token prompt
    (int4_matmul, int8_matmul) and one decode step (int4_matmul_s8 and
    int8_matmul's GEMV regime for the head),
    with the hidden state after each layer held to the plain twin's, and
    beside them the plain twin against itself with its f32 sums in
    another order."""
    gen = torch.Generator(dev).manual_seed(3)
    prompt = torch.randint(0, dims.n_vocab, (1, LLM_PROMPT), generator=gen, device=dev)
    step = torch.randint(0, dims.n_vocab, (1, 1), generator=gen, device=dev)
    cache = lm.init_kv_cache(dims, 1, LLM_PROMPT + 8, dtype=torch.bfloat16, device=dev)
    with torch.no_grad():
        before = dict(tq.launch_counts)
        with residual_stream(lm) as hidden:
            logits, _ = lm.forward(params, dims, prompt, cache, pos=0)
        launched = {n: tq.launch_counts[n] - before[n] for n in before}
        prefilled = {key: x.clone() for key, x in cache.items()}
        with plain_kernels(tq), residual_stream(lm) as hidden_plain:
            logits_plain, _ = lm.forward(params, dims, prompt,
                                         {key: torch.zeros_like(x) for key, x in cache.items()})
        e_prefill = rel_err(logits, logits_plain)
        e_layers = layer_errors(hidden, hidden_plain)
        # control: the plain twin again with TF32 matmuls. Every f32 product
        # of the forward is of bf16 values, exact in TF32, so this twin
        # parts from the plain one only in the order of its f32 sums
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            with plain_kernels(tq), residual_stream(lm) as hidden_tf32:
                logits_tf32, _ = lm.forward(params, dims, prompt, {
                    key: torch.zeros_like(x) for key, x in cache.items()})
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        e_tf32 = rel_err(logits_tf32, logits_plain)
        e_tf32_layers = layer_errors(hidden_tf32, hidden_plain)
        del logits, logits_plain, logits_tf32, hidden, hidden_plain, hidden_tf32
        before = dict(tq.launch_counts)
        with residual_stream(lm) as hidden:
            step_logits, _ = lm.forward(params, dims, step, cache, pos=LLM_PROMPT)
        launched_step = {n: tq.launch_counts[n] - before[n] for n in before}
        with plain_kernels(tq), residual_stream(lm) as hidden_plain:
            step_plain, _ = lm.forward(params, dims, step, prefilled, pos=LLM_PROMPT)
        e_step = rel_err(step_logits, step_plain)
        e_step_layers = layer_errors(hidden, hidden_plain)
    print(f"full-width {LLM} (int4 body, int8 head) vs its plain twin: prefill of "
          f"{LLM_PROMPT} tokens logits rel err {e_prefill:.3e} (launches {launched}), "
          f"decode step logits rel err {e_step:.3e} (launches {launched_step}); "
          f"tolerance {MODEL_TOL}")
    print(f"  hidden state rel err after each of the {dims.n_layer} layers, prefill: "
          f"{e_layers}")
    print(f"  the same, decode step: {e_step_layers}")
    print(f"  control, the plain twin with TF32 sums vs the plain twin: prefill logits rel "
          f"err {e_tf32:.3e}; after each layer: {e_tf32_layers}")
    n_proj = 7 * dims.n_layer
    assert launched == {"int8_matmul": 1, "int4_matmul": n_proj, "int4_matmul_s8": 0}
    # the decode step's head: int8_matmul's GEMV regime on the card
    assert launched_step == {"int8_matmul": 1, "int4_matmul": 0, "int4_matmul_s8": n_proj}
    assert e_prefill <= MODEL_TOL and e_step <= MODEL_TOL


SPEAKERS = ("Speaker 0", "Speaker 1")
CONVERSATION = [
    "Hi, I'm Maria. Thanks for joining the call about the studio move.",
    "Hello Maria, this is David. Happy to help with the planning.",
    "We need to move the recording gear before the end of the month.",
    "How many microphones and stands are we talking about?",
    "Twelve microphones, eight stands, and the mixing desk.",
    "The desk is heavy. We should book a van with a lift.",
    "Agreed. Can you get quotes from two rental companies?",
    "Sure, I'll call them tomorrow morning and send you the prices.",
    "Also, the new room needs acoustic panels on the back wall.",
    "I measured it last week: about twenty square metres of panels.",
    "That fits the budget if we reuse the old bass traps.",
    "The bass traps are fine, but two of them have torn covers.",
    "Let's order new covers then, it's cheaper than new traps.",
    "What about the network? The old studio had cable runs everywhere.",
    "The building has fibre, so we only need a switch and patch cables.",
    "Good. Then the last question is the schedule for the first booking.",
    "The band wants to record on the fifteenth, in the afternoon.",
    "That gives us two days to test the gear after the move.",
    "Fine by me. I'll write up the plan and share it tonight.",
    "Great, thanks David. Talk to you tomorrow.",
]


def conversation() -> list[dict]:
    """20 merged segments of two speakers, as the transcript merge hands
    them over: start, end, speaker, text."""
    segs, t = [], 0.0
    for i, text in enumerate(CONVERSATION):
        dur = 0.35 * len(text.split())
        segs.append({"start": round(t, 2), "end": round(t + dur, 2),
                     "speaker": SPEAKERS[i % 2], "text": text})
        t += dur + 0.4
    return segs


def profile_decode(lm, params, dims, dev, card: str, prompt_len: int = 1500,
                   steps: int = 3) -> None:
    """Where a decode step's time goes: host wall per step against the
    device's busy time (torch.profiler, kernel self time) after a
    prompt_len-token prefill, the kernel launches per step and the
    kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(dev).manual_seed(4)
    prompt = torch.randint(0, dims.n_vocab, (1, prompt_len), generator=gen, device=dev)
    cache = lm.init_kv_cache(dims, 1, prompt_len + 2 * steps + 2, dtype=torch.bfloat16,
                             device=dev)
    tok = torch.zeros((1, 1), dtype=torch.long, device=dev)
    with torch.no_grad():
        lm.forward(params, dims, prompt, cache, pos=0)
        lm.forward(params, dims, tok, cache, pos=prompt_len)            # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            lm.forward(params, dims, tok, cache, pos=prompt_len + 1 + i)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(steps):
                lm.forward(params, dims, tok, cache, pos=prompt_len + 1 + steps + i)
            torch.cuda.synchronize()
    events = prof.key_averages()

    def device_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))

    kernels = [e for e in events if device_us(e) > 0 and not e.key.startswith("aten::")]
    busy = sum(device_us(e) for e in kernels) / steps / 1e3
    launches = sum(e.count for e in events if e.key == "cudaLaunchKernel") / steps
    print(f"decode step profile ({LLM}, cache at {prompt_len} positions): host wall "
          f"{wall * 1e3:.2f} ms per step, device busy {busy:.2f} ms per step "
          f"({100 * (1 - busy / (wall * 1e3)):.0f}% idle), {launches:.0f} kernel launches "
          f"per step [{card}]")
    for e in sorted(kernels, key=device_us, reverse=True)[:6]:
        print(f"  {device_us(e) / steps / 1e3:.3f} ms per step, {e.count // steps} calls: "
              f"{e.key[:90]}")


def profile_prefill(lm, params, dims, dev, card: str,
                    prompt_len: int = LLM_LONG_PROMPT) -> None:
    """Where a prefill's device time goes: one prompt_len-token prefill
    (after one warm-up) under torch.profiler, its device busy time split
    by kernel, beside its host wall."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(dev).manual_seed(6)
    prompt = torch.randint(0, dims.n_vocab, (1, prompt_len), generator=gen, device=dev)
    cache = lm.init_kv_cache(dims, 1, prompt_len, dtype=torch.bfloat16, device=dev)
    with torch.no_grad():
        lm.forward(params, dims, prompt, cache, pos=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            lm.forward(params, dims, prompt, cache, pos=0)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()

    def device_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))

    kernels = sorted((e for e in events if device_us(e) > 0 and not e.key.startswith("aten::")),
                     key=device_us, reverse=True)
    busy = sum(device_us(e) for e in kernels) / 1e3
    print(f"prefill profile ({LLM}, {prompt_len} tokens): device busy {busy:.2f} ms, host "
          f"wall {wall * 1e3:.1f} ms (profiled) [{card}]")
    for e in kernels[:8]:
        print(f"  {device_us(e) / 1e3:.3f} ms, {e.count} calls: {e.key[:90]}")


def llm_model(tq, lm, dev):
    """llama-3.1-8b at the Q4 point: random bf16 weights from seed 0
    drawn on the card and quantized there."""
    dims = lm.LLAMA_CONFIGS[LLM]
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = tq.quantize_tree(lm.init_params(dims, torch.Generator(dev).manual_seed(0),
                                             torch.bfloat16, dev), bits=4)
    torch.cuda.synchronize()
    print(f"{LLM}: random bf16 weights (seed 0) drawn and quantized on the card in "
          f"{time.perf_counter() - t0:.1f} s; {torch.cuda.memory_allocated() / 1e9:.2f} GB "
          f"allocated, peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return params, dims


def llm_phase(att, dev, card: str):
    """Phase 7. Returns the three kernels' stats and the launches of the
    stage's run (counts zeroed just before it)."""
    from turbo_whisper_workspace_tpu_torch.config import LLMConfig, PipelineConfig
    from turbo_whisper_workspace_tpu_torch.llm import llm_helper
    from turbo_whisper_workspace_tpu_torch.models import llama as lm
    from turbo_whisper_workspace_tpu_torch.ops import quant as tq
    from turbo_whisper_workspace_tpu_torch.pipeline.audio_pipeline import (
        AudioProcessingPipeline)

    qstats = check_quant_kernels(tq, dev, card)
    for name, s in qstats.items():
        note = s.pop("library_note", None)
        lib = (f"{s['library_ms']:.4f} ms" if s["library_ms"] is not None else
               f"none ({note or 'no PyTorch call takes int4 weights packed in halves'})")
        print(f"{name}: kernel {s['ms']:.4f} ms, plain {s['plain_ms']:.4f} ms, "
              f"library {lib}, bound {s['bound_ms']:.4f} ms ({s['bound_by']}) [{card}]")
    check_quantizer(tq, dev)

    llm_cfg = LLMConfig()
    assert llm_cfg.model == LLM and llm_cfg.quantize_bits == 4, llm_cfg
    params, dims = llm_model(tq, lm, dev)
    check_llm_model(tq, lm, params, dims, dev)
    profile_prefill(lm, params, dims, dev, card)

    llm = llm_helper.TorchLlama(params, dims, device=dev)
    llm_helper.set_llm(llm)
    llm_pipe = AudioProcessingPipeline(PipelineConfig(llm=llm_cfg), device=dev)
    segs = conversation()
    stages = (("identify_speaker_names", dict, llm_cfg.max_tokens_names),
              ("generate_summary", str, llm_cfg.max_tokens_summary),
              ("extract_topics", list, llm_cfg.max_tokens_topics))
    tq.reset_launch_counts()
    att.reset_launch_counts()
    for name, kind, max_tokens in stages:
        llm.last_generation = {}
        t0 = time.perf_counter()
        out = getattr(llm_pipe, name)(segs)
        wall = time.perf_counter() - t0
        assert isinstance(out, kind), (name, out)
        g = llm.last_generation
        assert g, f"{name}: the LLM did not generate"       # generate_text hides errors
        steps = g["decode_forwards"] + 1           # sampled tokens: the last needs no forward
        print(f"LLM stage {name}: prompt {g['prompt_tokens']} tokens, {steps} sampled "
              f"(max {max_tokens}), {g['new_tokens']} before EOS; prefill "
              f"{g['prefill_s'] * 1e3:.1f} ms; decode {g['decode_s'] * 1e3 / max(steps - 1, 1):.3f} "
              f"ms per step, {steps / g['decode_s']:.1f} tokens/s; wall {wall:.3f} s; "
              f"result {str(out)[:100]!r} [{card}]")
    counts = {**dict(tq.launch_counts), **{n: c for n, c in att.launch_counts.items() if c}}
    print(f"launches on the LLM path: {counts}")
    assert all(tq.launch_counts[name] > 0 for name in tq.launch_counts), counts
    llm_helper.set_llm(None)
    profile_decode(lm, params, dims, dev, card)
    return qstats, counts


# ---------------------------------------------------------------------------
# Phase 8: the LLM-ops profiler path


def library_s8(prof, xq, xs, w_q, scale, flush) -> None:
    """torch._int_mm (s8 x s8 → s32, M > 16 only) plus the rescale, at
    M = LIBRARY_M, beside the kernel at the same M; printed as context:
    no PyTorch call computes s8_matmul at the profiler's M = 1."""
    m, k = xq.shape
    n = w_q.shape[1]

    def library():
        return (torch._int_mm(xq, w_q).float() * xs * scale).to(torch.bfloat16)

    try:
        same = torch.equal(library(), prof.s8_matmul(xq, xs, w_q, scale))
    except (RuntimeError, NotImplementedError, AttributeError) as e:
        print(f"s8_matmul M={m} K={k} N={n}: torch._int_mm: {str(e).splitlines()[0][:120]}")
        return
    print(f"s8_matmul M={m} K={k} N={n}: library torch._int_mm + rescale "
          f"{time_ms(library, flush):.4f} ms, the kernel "
          f"{time_ms(lambda: prof.s8_matmul(xq, xs, w_q, scale), flush):.4f} ms; "
          f"bit-equal {same}")
    assert same


def check_s8_kernels(tq, prof, dev, card: str) -> dict:
    """Phase 8: s8_matmul and s8g4_matmul against their plain versions at
    S8_SHAPES in the profiler's formats (int8 weights with per-column
    scales; grouped int4 with G = 128), with the wrong layout readings
    shown to matter, timed (s8_matmul also back to back, and int8_matmul's
    GEMV on the same weights at every M = 1 shape). The row in the kernels
    line is the first shape of each kernel."""
    gen = torch.Generator(dev).manual_seed(5)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    stats = {}

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    rows, errs = {}, {}
    for m, k, n in S8_SHAPES:
        q = tq.quantize_int8(randn(k, n) * k ** -0.5)
        wq, sc = q["w_q"], q["scale"]
        xq, xs = prof.quant_act(randn(m, k))
        out = prof.s8_matmul(xq, xs, wq, sc)
        torch.cuda.synchronize()
        ref = prof.s8_matmul_reference(xq, xs, wq, sc)
        dropped = {"right column's scale": prof.s8_matmul_reference(xq, xs, wq, sc.roll(1))}
        if m > 1:
            dropped["right row's scale"] = prof.s8_matmul_reference(xq, xs.roll(1, 0), wq, sc)
        errs[(m, k, n)] = compare(f"s8_matmul M={m} K={k} N={n}", out, ref, dropped,
                                  relative_max=True)
        same = torch.equal(out, ref)
        print(f"  bit-equal to its plain version: {same} (plan {prof.s8_plan(m, k, n)})")
        assert same
        # the int8 weight and its scales, xq, xs and the bf16 output
        label = f"s8_matmul M={m} K={k} N={n}"
        rows[(m, k, n)] = timed(label, lambda: prof.s8_matmul(xq, xs, wq, sc),
                                lambda: prof.s8_matmul_reference(xq, xs, wq, sc),
                                nbytes(xq, xs, wq, sc, out), 2 * m * k * n, flush,
                                peak_ops=PEAK_INT8_OPS)
        if (m, k, n) in BEFORE_MS["s8_matmul"]:
            copies = input_copies((xq, xs, wq, sc), nbytes(xq, xs, wq, sc))
            print_redesigned("s8_matmul", label, rows[(m, k, n)]["ms"],
                             back_to_back_ms(prof.s8_matmul, copies, flush), copies, card,
                             (m, k, n))
            del copies
        if (m, k, n) == S8_SHAPES[0]:
            xq, xs = prof.quant_act(randn(LIBRARY_M, k))
            library_s8(prof, xq, xs, wq, sc, flush)
        if m == 1:
            # int8_matmul's GEMV at the same widths, the profiler's int8 rows
            x = randn(m, k).to(torch.bfloat16)
            label = f"int8_matmul M={m} K={k} N={n} (profiler)"
            got = tq.int8_matmul(x, wq, sc)
            torch.cuda.synchronize()
            compare(f"{label} (plan {tq.int8_plan(m, k, n)})", got,
                    tq.int8_matmul_reference(x, wq, sc),
                    {"right column's scale": tq.int8_matmul_reference(x, wq, sc.roll(1))},
                    relative_max=True)
            single = timed(label, lambda: tq.int8_matmul(x, wq, sc),
                           lambda: tq.int8_matmul_reference(x, wq, sc),
                           nbytes(x, wq, sc, got), 2 * m * k * n, flush)["ms"]
            copies = input_copies((x, wq, sc), nbytes(x, wq, sc))
            print_redesigned("int8_matmul", label, single,
                             back_to_back_ms(tq.int8_matmul, copies, flush), copies, card,
                             (m, k, n))
            del x, got, copies
        del q, wq, sc, xq, xs, out, ref, dropped
    stats["s8_matmul"] = kernel_row(rows[S8_SHAPES[0]], errs)
    stats["s8_matmul"]["library_note"] = (
        "no PyTorch call takes M = 1: torch._int_mm needs M > 16 (timed at M = 32 above)")

    rows, errs = {}, {}
    for m, k, n in S8_SHAPES:
        q = tq.quantize_int4(randn(k, n) * k ** -0.5)
        wq, sc = q["w_q4"], q["scale4"]
        xq, xs = tq.quant_act_grouped(randn(m, k), sc.shape[0])
        out = prof.s8g4_matmul(xq, xs, wq, sc)
        torch.cuda.synchronize()
        ref = prof.s8g4_matmul_reference(xq, xs, wq, sc)
        dropped = {what: tq._s8_from_halves(xq, xs, lo, hi, sc)
                   for what, (lo, hi) in wrong_nibbles(tq, wq).items()}
        dropped["right group's scale"] = prof.s8g4_matmul_reference(xq, xs, wq, sc.roll(1, 0))
        errs[(m, k, n)] = compare(f"s8g4_matmul M={m} K={k} N={n}", out, ref, dropped,
                                  relative_max=True)
        same = torch.equal(out, tq.int4_matmul_s8(xq, xs, wq, sc))
        print(f"  equal to the int4_matmul_s8 kernel on the same inputs: {same}")
        assert same
        rows[(m, k, n)] = timed(f"s8g4_matmul M={m} K={k} N={n}",
                                lambda: prof.s8g4_matmul(xq, xs, wq, sc),
                                lambda: prof.s8g4_matmul_reference(xq, xs, wq, sc),
                                nbytes(xq, xs, wq, sc, out), 2 * m * k * n, flush,
                                peak_ops=PEAK_INT8_OPS)
        del q, wq, sc, xq, xs, out, ref, dropped
    stats["s8g4_matmul"] = kernel_row(rows[S8_SHAPES[0]], errs)
    stats["s8g4_matmul"]["library_note"] = (
        "no PyTorch call takes int4 weights packed in halves with grouped int8 activations")
    return stats


def profiler_phase(dev, card: str):
    """Phase 8. Returns the two kernels' stats and the launches of the
    profiler's run (counts zeroed just before it)."""
    from turbo_whisper_workspace_tpu_torch.ops import quant as tq
    from turbo_whisper_workspace_tpu_torch.scripts import profile_llm_ops as prof

    stats = check_s8_kernels(tq, prof, dev, card)
    for name, s in stats.items():
        print(f"{name}: kernel {s['ms']:.4f} ms, plain {s['plain_ms']:.4f} ms, library "
              f"none ({s.pop('library_note')}), bound {s['bound_ms']:.4f} ms "
              f"({s['bound_by']}) [{card}]")
    torch.cuda.empty_cache()
    prof.reset_launch_counts()
    tq.reset_launch_counts()
    t0 = time.perf_counter()
    results = prof.main(["--device", "cuda", "--model", PROFILER, "--steps", "8",
                         "--iters", "2"])
    wall = time.perf_counter() - t0
    counts = {**dict(prof.launch_counts), **{n: c for n, c in tq.launch_counts.items() if c}}
    print(f"LLM-ops profiler ({PROFILER}, ms per decode step): {json.dumps(results)}; "
          f"wall {wall:.1f} s [{card}]")
    print(f"launches on the profiler path: {counts}")
    assert all(prof.launch_counts[name] > 0 for name in prof.launch_counts), counts
    return stats, counts


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


def prefill_profile_only() -> int:
    """`chip_smoke.py --prefill-profile`: the build, then only
    profile_prefill on the LLM at the Q4 point. It reads nothing newer
    than the port's first LLM slice, so the same file measures an older
    tree of the port beside this one."""
    from turbo_whisper_workspace_tpu_torch.models import llama as lm
    from turbo_whisper_workspace_tpu_torch.ops import build
    from turbo_whisper_workspace_tpu_torch.ops import quant as tq

    card = card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"kernels built in {build.build_all():.1f} s")
    dev = torch.device("cuda")
    params, dims = llm_model(tq, lm, dev)
    profile_prefill(lm, params, dims, dev, card)
    return 0


def before_only(tree: str) -> int:
    """`chip_smoke.py --before TREE`: every kernel that BEFORE_MS times
    shape by shape, built from the sources of TREE (an earlier commit of
    the repo, unpacked) beside this checkout's, and timed single launch at
    each of its shapes in turns (before, this, this, before; each checked
    against its plain version). Prints the medians; no result line."""
    from turbo_whisper_workspace_tpu_torch.ops import build
    from turbo_whisper_workspace_tpu_torch.ops import quant as tq
    from turbo_whisper_workspace_tpu_torch.scripts import profile_llm_ops as prof

    card = card_line()
    print(card)
    print(f"kernels built in {build.build_all():.1f} s")
    names = [name for name, ms in BEFORE_MS.items() if isinstance(ms, dict)]
    src = os.path.join(tree, "turbo_whisper_workspace_tpu_torch", "csrc")
    out = os.path.join(REPO, "build", "torch_cuda", "before")
    os.makedirs(out, exist_ok=True)
    procs = {name: subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-o", os.path.join(out, f"lib{name}.so"),
         os.path.join(src, f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for name in names}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, f"nvcc failed on the earlier {name}:\n{log}"
    libs = {name: {"before": build.load(os.path.join(out, f"lib{name}.so"), name),
                   "this": build.library(name)} for name in names}
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(7)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def inputs(name, m, k, n):
        """(the kernel's call, a check of its output)"""
        q = tq.quantize_int8(torch.randn(k, n, generator=gen, device=dev) * k ** -0.5)
        wq, sc = q["w_q"], q["scale"]
        if name == "int8_matmul":
            x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
            ref = tq.int8_matmul_reference(x, wq, sc)
            return (lambda: tq.int8_matmul(x, wq, sc),
                    lambda got: rel_err(got, ref) <= KERNEL_REL_TOL)
        xq, xs = prof.quant_act(torch.randn(m, k, generator=gen, device=dev))
        ref = prof.s8_matmul_reference(xq, xs, wq, sc)
        return lambda: prof.s8_matmul(xq, xs, wq, sc), lambda got: torch.equal(got, ref)

    for name in names:
        for m, k, n in BEFORE_MS[name]:
            call, check = inputs(name, m, k, n)
            times = {"before": [], "this": []}
            for tree_name in ("before", "this", "this", "before"):
                build._LIBS[name] = libs[name][tree_name]
                assert check(call()), (name, tree_name, (m, k, n))
                times[tree_name].append(time_ms(call, flush))
            build._LIBS[name] = libs[name]["this"]
            print(f"{name} M={m} K={k} N={n}: single launch, the earlier tree "
                  f"{statistics.median(times['before']):.4f} ms, this tree "
                  f"{statistics.median(times['this']):.4f} ms [{card}]")
            torch.cuda.empty_cache()
    return 0


def main(argv: list[str] | None = None) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    args = sys.argv[1:] if argv is None else argv
    if "--prefill-profile" in args:
        return prefill_profile_only()
    if "--before" in args:
        return before_only(args[args.index("--before") + 1])
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
    stats = check_kernels(att, dev, card)
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

    # 6. the s8 route: the int8 cross-KV read by cross_attention_s8, same model
    check_s8_step(att, transcriber, golden)
    for label, s8_cfg in (("s8 greedy", TranscriptionConfig(cross_attention_s8=True)),
                          (f"s8 beam-{BEAM}", TranscriptionConfig(beam_size=BEAM,
                                                                  cross_attention_s8=True))):
        s8_tr = load_transcriber(transcriber.model, s8_cfg, device="cuda")
        att.reset_launch_counts()
        batch_call(s8_tr, batch, label)
        path_counts[label] = read_counts(label, ("flash_attention", "cross_attention_s8"))
        assert path_counts[label]["cross_attention_int8"] == 0, path_counts[label]

    # 7. the LLM enrichment path: llama-3.1-8b at the Q4 point
    del beam_tr, s8_tr, cross_kv, transcriber, pipe
    torch.cuda.empty_cache()
    qstats, path_counts["llm"] = llm_phase(att, dev, card)
    stats.update(qstats)

    # 8. the LLM-ops profiler path at llama-3.2-3b width
    torch.cuda.empty_cache()
    pstats, path_counts["profiler"] = profiler_phase(dev, card)
    stats.update(pstats)

    lines = []
    for name, s in stats.items():
        lines.append({
            "name": name, "route": "cuda",
            "source": f"turbo_whisper_workspace_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": sum(counts.get(name, 0) for counts in path_counts.values()), **s,
        })
    assert sorted(line["name"] for line in lines) == sorted(build.SIGNATURES), lines
    assert all(line["launches"] > 0 for line in lines), lines
    print(json.dumps({"kernels": lines}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
