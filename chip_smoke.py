#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (turbo_whisper_workspace_tpu_torch).

    python3 chip_smoke.py        # from the repo root, on a machine with one
                                 # NVIDIA GPU, nvcc and PyTorch built for CUDA

Phases, in order; any failure ends the run with a non-zero exit:

1. environment: the card's name and power limit, torch and CUDA versions;
   TF32 off for float32 products and convolutions;
2. build: compiles the twenty-one CUDA kernels from csrc/ (one nvcc each,
   in parallel);
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
   touch; self_attention_int8 also at Tq=2 and over a T=448 cache at
   valid_len 224 and 448; both take valid_len as a device int32, their
   launch sized by T, and each is captured in a CUDA graph at valid_len 115, 227
   written into the device scalar and the graph replayed, the output
   held to the plain version at 227): max abs error within 2e-2 and relative L2 error within 5e-3,
   and each mask the kernel must apply (keys past the sequence, past
   valid_len, of lanes a beam does not own) dropped from the plain
   version must read above that limit (the script prints those
   readings), and the median of 25 timed runs (CUDA events, L2 flushed
   before each run) of the kernel, the plain version and, where one
   exists, the one PyTorch call computing the same function, beside the
   least time the card could take; for the redesigned kernels
   (flash_attention, cross_attention_int8 and cross_attention_s8 at Tq 1
   and 5, self_attention_int8_lanes and self_attention_int8 at valid_len
   115 and 227 here, int4_matmul and int4_matmul_s8 in phase 8,
   s8_matmul and s8g4_matmul in phase 9) also a back-to-back time
   (20 launches in one CUDA graph over input copies larger than the L2
   cache, per launch);
4. the greedy main path at full large-v3-turbo width (random weights
   from seed 0, bf16, default TranscriptionConfig: greedy, int8
   cross-KV, language detection): first the model is held to its
   plain-PyTorch twin on one window (encoder features and prefill
   logits), then the launch counts are zeroed and the pipeline answers
   two single-file requests through AudioProcessingPipeline.transcribe
   (the golden clip and a synthesized 75 s clip) and one batch call of
   Transcriber.transcribe that fills a bucket of 8 windows; the result
   schema is checked and flash_attention, cross_attention_int8 and the
   decoder step's kernels (llama_attention over the bf16 self cache,
   whisper_norm, whisper_kv_rows, whisper_logit_rules) must have been
   launched during this phase; the model's plain twins here and in
   phases 5-6 replace the wrappers of ops/attention.py, ops/llama_ops.py
   and ops/whisper_ops.py;
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
   regathered calls self_attention_int8; every beam search here (and in
   phases 6 and 12) runs graphed, one captured CUDA graph a step, its
   launches counted with the replays;
6. the s8 route (TranscriptionConfig(cross_attention_s8=True)), same
   model: one decode step of the decoder with the route on against the
   same step with the plain versions (logits); then, with the counts
   zeroed before and read after each, one batch call of
   Transcriber.transcribe on the same 8 windows greedy and one at beam 5;
   each must launch cross_attention_s8 and not cross_attention_int8;
7. the master flow (transcribe → diarize → merge → enrich), same
   model: random segmentation and embedding nets at the default dims
   (SegmentationDims(): d_model 256 × 4 layers; EmbeddingDims(): 256
   channels × 4 blocks, 192-d; seed 0) written as `.npz` checkpoints with
   their dims under the default model names in a temporary models
   directory, loaded by name through AudioProcessingPipeline.load_diarizer
   (bf16 on the card), their segmentation logits and embeddings held
   within 5e-2 relative L2 of the f32 nets of the same weights on the
   CPU; then, with the counts zeroed, process_batch on the golden clip
   and a synthesized 75 s two-speaker dialogue (num_speakers=2) on the
   neural tier (twice: the first call is a warm-up) and on the
   weight-free tier, and one process_audio(num_speakers=0, enrich=True)
   on the dialogue with DummyLLM injected; each result's keys against the
   JAX package's, its turns inside the file; the weight-free tier's
   golden timeline within 0.5 s of examples/golden/expected.json and its
   DER on the dialogue under 0.25; each stage's wall from
   processing_times and the diarization's audio-s/s printed;
   flash_attention and cross_attention_int8 must have been launched;
8. the LLM enrichment path (llama-3.1-8b at full width, random bf16
   weights from seed 0 drawn on the card, then quantized there by
   quantize_tree at quantize_bits=4: int4 body, int8 lm_head; handed to
   a TorchLlama on the card and taken as it holds them, q|k|v and gate|up
   fused):
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
   5e-2 relative L2 of the same model with the plain versions (of the
   quantized matmuls and of the Llama layer's four kernels), with the
   hidden state's error after each layer printed, and as a control the
   plain twin against itself with TF32 sums, each of the seven kernels
   launched the number of times a layer calls it (the int4 body 4 a
   layer: q|k|v, out, gate|up, down); a torch.profiler
   window over one 1748-token prefill (device time by kernel); then, with
   the counts zeroed, the stage end to end:
   TorchLlama injected with set_llm, and AudioProcessingPipeline's
   identify_speaker_names, generate_summary and extract_topics on a
   20-segment two-speaker conversation, timed (prefill ms, ms per decode
   step, tokens/s); all three quantized-matmul kernels and the four
   Llama-layer kernels (phase 15) must have been launched. Last, a
   torch.profiler window over three decode steps: host wall against
   device busy time per step, kernels run and launches per step, the
   heaviest kernels;
9. the LLM-ops profiler path at full llama-3.2-3b width: s8_matmul and
   s8g4_matmul against their plain versions at the profiler's m = 1
   shapes (3072→3072, →1024, →8192, 8192→3072, the head 3072→128256), at
   M = 8 and one ragged shape, with the limits and wrong readings of
   phase 8 (both bit-equal to their plain versions, s8g4_matmul also
   equal to int4_matmul_s8 on the same inputs), timed single launch and
   back to back, with torch._int_mm plus the rescale timed at M = 32 as
   the library context (it takes no M ≤ 16); s8g4_matmul also at
   llama-3.1-8b's unfused gate and down shapes (4096→14336, 14336→4096),
   equal to and
   timed beside int4_matmul_s8 on the same inputs; then, with the counts
   zeroed, profile_llm_ops.main --steps 8 --iters 2, whose JSON of ms
   per step is printed; both kernels must have been launched there;
10. the offline tool shell, on phase 7's pipeline and phase 8's
   quantized llama-3.1-8b, with the counts zeroed: SecurityMonitor
   .monitor_directory over a directory holding the golden clip and the
   75 s two-speaker dialogue (one process_batch call, DummyLLM
   enrichment), timed; bar_security_monitor.run_mock_analysis with the
   TorchLlama injected, so the incident summary is generated on the card
   (an underage_drinking incident; prefill ms and ms per decode step);
   evaluate_corpus over the same two files on the weight-free
   diarization tier, with RTTMs from the dialogue's truth and
   examples/golden/expected.json (corpus WER and DER printed, the
   dialogue's DER under 0.25); dynamic_normalize and spectral_denoise on
   the dialogue on the card, within 1e-4 relative L2 of the same calls on
   the CPU, both timed; the CLI's check-gpu, info, diagnose and
   preprocess (--denoise --dynamic --device cuda) on the golden clip;
   flash_attention, cross_attention_int8, int4_matmul, int4_matmul_s8 and
   int8_matmul must have been launched;
11. serving, on phase 7's pipeline (DummyLLM enrichment), with the counts
   zeroed: the port's stdlib server on 127.0.0.1 in a thread, through
   its client: GET / and /api/models, POST /api/transcribe with the
   golden clip, /api/security/analyze and /api/analyze on the 75 s
   dialogue (the card's machine has no matplotlib: the audio info and
   `plots_error`), then two concurrent /api/transcribe requests whose
   text and merged segments must equal the lone request's; then one
   boot through ensure_api_server_running on a second port; each
   request's wall printed; flash_attention and cross_attention_int8
   must have been launched;
12. parallelism: (a) an NCCL group of one rank, DP = 1: make_dp_decode
   on phase 7's full-width model (int8 cross-KV), greedy and beam 5 on
   one bucket of 8 windows, tokens equal to greedy_decode_features /
   beam_decode_features run directly on the same inputs and no
   collective issued; (b) the train step at full width on the same
   group: first flash_attention's autograd route against the plain
   version's autograd gradients at an encoder layer's (2, 20, 1500, 64)
   (relative L2 of dq, dk, dv within 1e-2), then three AdamW steps of
   make_train_step on one batch of 2 windows × 12 tokens (a fresh
   random large-v3-turbo in bf16, learning rate 1e-3): finite losses
   that descend, ms a step and peak memory printed; (c) TP = 2 as two
   processes sharing the card over gloo (`--tp-worker`; NCCL takes one
   rank a card): make_tp_decode at large-v3-turbo's widths and 4 + 4
   layers with int8 cross-KV, 10 heads a rank, 8 windows × 32 greedy
   steps, both ranks' tokens equal to the unsharded module's, each
   rank's flash_attention and cross_attention_int8 launched and its
   all-reduces counted; both processes joined with a timeout;
13. the decode loops as CUDA graphs: greedy_decode_features and
   generate_tokens replay one captured step (utils/step_loop.py) on the
   card, so phases 4, 7, 8, 10 and 11 already ran them graphed; here
   each is held against its eager step function (graphed=False, the
   same function called each step) in turns eager, graphed, graphed,
   eager: Whisper greedy on phase 4's 8 windows x 224 steps at full
   large-v3-turbo width on the int8 and the s8 cross route, tokens,
   lengths and sum_logprobs bit-equal; the 8B LLM on a 1748-token prompt
   x 200 steps, tokens bit-equal; each with its walls, capture ms, ms per
   step against the byte bound, and a step's profile (host wall, device
   busy, idle share, kernels run, cudaLaunchKernel and cudaGraphLaunch
   calls) as the difference of two loop lengths, with each kernel's device
   µs and calls a step by name; profile_decode on the graphed LLM step;
   one sampled call of each loop at T = 0.6 (grammar or
   EOS padding, seeded); the phase's peak memory. The graphed runs'
   launches (replays counted) join the kernels line;
14. the beam loop as a CUDA graph: beam_decode_features (beam 5) on phase
   4's 8 windows x 224 steps at full large-v3-turbo width, held against
   its eager step function (graphed=False) in turns eager, graphed,
   graphed, eager, in each self-KV cache mode (int8 lanes, int8
   regathered, bf16 regathered) and on the s8 cross route in lanes mode:
   every field of the result bit-equal; walls, capture ms, ms per step,
   and for the lanes mode a step's profile (host wall, device busy, idle
   share, kernels run, cudaLaunchKernel and cudaGraphLaunch calls, each
   kernel's device µs and calls a step by name) as the difference of two
   loop lengths; the phase's peak memory; each mode must launch its
   self-attention and cross-attention kernels;
15. the Llama layer's kernels (ops/llama_ops.py) at llama-3.1-8b width
   against their plain versions, with the limits of phase 3 (max abs
   error × max|ref|): llama_attention at a decode step over a 2004-row
   cache (the summary call's 1748 + 256) at 1500 and 2003 cached
   positions, every row past pos random, and at the 1748-token prefill
   (its online softmax), with the plain version without the position
   mask and with query head i reading kv head i % group in place of
   i // group read above the limit; llama_norm_quant at a decode step in
   each mode (residual add and norm, norm, quantizer alone; with the
   grouped quantizer) and at the prefill, its xq equal to the plain
   version's or off by 1 only in a group whose bf16 input differs
   (counted); llama_rope_cache at both positions and the prefill, with
   interleaved-pair reads in place of the half-split layout above the
   limit and the cache rows written equal; llama_swiglu_quant at a decode
   step with the quantizer and at the prefill; each timed single launch
   and back to back beside its plain version, its bound, and the library
   call where one exists (scaled_dot_product_attention with enable_gqa
   and the mask; F.rms_norm, the norm alone); then GRAPH_CHECK_STEPS
   replays of one 8B decode step captured by StepGraph against the eager
   step function from the same state, logits, tokens and cache
   bit-equal, with each kernel's launches a step. These comparisons'
   launches are not counted in the kernels line: the four kernels' counts
   there come from the LLM path of phases 8, 10 and 13 (llama_attention's
   also from the Whisper paths);
16. the Whisper decoder step's kernels (ops/whisper_ops.py, and
   llama_attention at group 1) at large-v3-turbo's shapes against their
   plain versions, with the limits of phase 3: whisper_norm (d = 1280)
   over a greedy step's 8 rows, a beam step's 40 and a bucket's 12000
   encoder rows, with and without the residual add, and its entry mode
   at a device pos, x' bit-equal and h within one bf16 ulp of
   F.layer_norm's (counted), the norm without the residual add above the
   limit; whisper_kv_rows into the bf16 cache (8 rows, t = 1 and the
   prompt's 3), the int8 cache (40 rows) and the lanes (8 × 5 beams) at
   T = 227, at a host and a device pos, every payload and scale bit-equal,
   the lanes written into lane 0 in place of lane k above the limit;
   whisper_logit_rules over 51866 logits, a greedy step's 8 rows (plain,
   at the first step, sampled at T = 0.6 on the same Gumbel draws) and a
   beam step's 40 (cand = alive + log_softmax), tokens equal, the
   probabilities and the token's log-probability within the limits, the
   rows whose timestamp forcing flipped counted (none allowed), the
   rules without the pairing bans and with the begin mask at a later
   step above the limit; llama_attention at B = 8 and 40, 20 heads of 64,
   T = 227 at pos 115 and 226 (device pos), the prompt's t = 3 and a
   40-token prompt (its prefill regime), without the position mask above
   the limit; each timed single launch and back to back beside its plain
   version, its bound and the library call where one exists;
17. the DeepSeek-V3 path (models/deepseek_v3.py) at Moonlight-16B-A3B's
   widths: int4_matmul_s8 bit-equal to its plain version at phase 8's
   shapes (its sweep is shared with int4_moe_s8 in csrc/int4_s8.cuh);
   int4_moe_s8 bit-equal to its plain version at the decode step's
   gate|up (8 rows, one input, split) and down (group 64), a split-K
   plan and a ragged one (a repeated and an out-of-range id);
   int4_group_matmul against its plain version with the limits of phase 3
   over ~10500 rows loaded unevenly on the 66 experts (gate|up split, and
   down); moe_route
   against its plain version over 1, 8 and 1500 rows (ids equal but at
   near-ties, which are counted; weights within 1e-6); mla_attention
   against its plain version with the limits of phase 3 at device
   positions 1800, 0, 2047 and the slices' edges of 2048-, 2056- and
   4096-row caches (the last through rounds), a host position, two
   head tiles, 8 batch rows (more clusters than the card holds at 16
   ranks: 8) and a 100-row cache (2 ranks), the cache row written
   bit-equal and nowhere else, the position mask dropped above the
   limit, a graph replay at a new position, its ranks against the mirror
   and the occupancy query's answer; both timed single and back to back
   beside their bounds (and scaled_dot_product_attention on the absorbed
   rows), mla_attention at MLA_TIMED's positions; then the model at
   3 layers (Q4) served by TorchLlama: a 1500-token prefill and a decode
   step against the plain twin, the graphed generation against the eager
   one, the kernels' launches a step.
   (F.layer_norm, the norm alone; scaled_dot_product_attention); then
   the greedy step (bf16 self cache) and the beam-5 lanes step replayed
   from a StepGraph against the eager step function, every field of the
   result bit-equal; and C5: a head-dim-64 Llama (2048 wide, 32 heads
   over 8, 4 layers, int4) through models/llama.py:forward, a 256-token
   prefill and a decode step at a device pos, within 5e-2 relative L2
   of its plain twin. These comparisons' launches are not counted in the
   kernels line: the three kernels' counts there come from the Whisper
   paths of phases 4-14.

Prints a `kernels` JSON line (launches summed over the runs of phases 4
to 14 and 17, the TP ranks' included; every one of the twenty-one kernels must
have been launched), then as
its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero, printing no result, when CUDA is unavailable.

    python3 chip_smoke.py --moe

builds the kernels and runs phase 17 alone (no kernels line).

    python3 chip_smoke.py --llm-profile

builds the kernels and runs the LLM at the Q4 point alone: phase 8's
prefill profile, the decode step's profile eager and graphed, and
phase 8's three stage calls (no result line); copied into an older tree
of the port, it measures that tree the same way.

    python3 chip_smoke.py --whisper-profile

builds the kernels and runs large-v3-turbo alone: phase 4's greedy and
phase 5's beam-5 batch calls and phase 14's graphed beam-5 lanes decode
(walls), and the by-kernel profiles of a graphed greedy step and a
graphed beam-5 lanes step (no result line); copied into an older tree,
it measures that tree the same way.

    python3 chip_smoke.py --before TREE

first runs `--llm-profile`, then `--whisper-profile`, in TREE, an
unpacked earlier commit (`git archive <rev> | tar -x -C build/parent`;
this file is copied there), and in this checkout, in turns (TREE, this,
this, TREE); then phase 16's checks and times of the Whisper decoder
step's kernels in this checkout; then times, among the kernels that
BEFORE_SHAPES lists shape by
shape (int8_matmul, s8_matmul, s8g4_matmul), the two self-attention
kernels by valid_len (an earlier tree's host-int interface called as
such) and mla_attention at MLA_TIMED's positions, those whose source
differs in TREE, built from TREE's sources,
against this checkout's, in turns at each shape (no result line): the
source of those "before" times.
"""

from __future__ import annotations

import contextlib
import glob
import json
import math
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
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
# the matmul shapes at which phases 8 and 9 print the back-to-back time
# beside the single launch's, and at which `--before` times an earlier
# tree's kernel against this checkout's
BEFORE_SHAPES = {
    "int8_matmul": [(512, 4096, 128256), (1748, 4096, 128256), (1, 4096, 128256),
                    (1, 3072, 8192), (1, 3072, 3072), (1, 3072, 1024), (1, 8192, 3072),
                    (1, 3072, 128256)],
    "s8_matmul": [(1, 3072, 8192), (1, 3072, 3072), (1, 3072, 1024), (1, 8192, 3072),
                  (1, 3072, 128256)],
    "s8g4_matmul": [(1, 3072, 8192), (1, 3072, 3072), (1, 3072, 1024), (1, 8192, 3072),
                    (1, 3072, 128256), (8, 3072, 8192), (3, 256, 1000)]}
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
    # no Pallas kernel: the JAX package leaves this work to XLA inside its
    # jitted Llama forward (the code's first line)
    "llama_attention": "turbo_whisper_workspace_tpu/models/llama.py:156",
    "llama_norm_quant": "turbo_whisper_workspace_tpu/models/llama.py:89",
    "llama_rope_cache": "turbo_whisper_workspace_tpu/models/llama.py:95",
    "llama_swiglu_quant": "turbo_whisper_workspace_tpu/models/llama.py:172",
    # nor here: XLA fuses this work inside the jitted Whisper decode loop
    "whisper_norm": "turbo_whisper_workspace_tpu/models/whisper.py:182",
    "whisper_kv_rows": "turbo_whisper_workspace_tpu/models/whisper.py:420",
    "whisper_logit_rules": "turbo_whisper_workspace_tpu/decode/rules.py:87",
    # no JAX code at all: the JAX package runs no DeepSeek-V3 model
    "int4_moe_s8": "none (the JAX package has no mixture of experts)",
    "mla_attention": "none (the JAX package has no latent attention)",
    "moe_route": "none (the JAX package has no mixture of experts)",
    "int4_group_matmul": "none (the JAX package has no mixture of experts)",
}
# phase 17: Moonlight-16B-A3B's widths at MOE_LAYERS layers (the dense
# one and two expert layers), a MOE_PROMPT-token prefill (~140 rows an
# expert) and the decode kernels at MOE_POS of a MOE_CACHE-row cache
MOE = "moonlight-16b-a3b"
MOE_LAYERS = 3
MOE_PROMPT = 1500
MOE_POS = 1800
MOE_CACHE = 2048
MOE_EXPERTS = 66           # 64 routed and 2 shared, stacked
MOE_BIAS_STD = 0.02        # the router's selection bias in phase 17's model
LLM = "llama-3.1-8b"
LLM_PROMPT = 512           # tokens of the prefill the model check runs
LLM_LONG_PROMPT = 1748      # tokens of the longest stage prompt (the summary's)
# phase 8's (M, K, N) per kernel: the LLM path's shapes at M = LLM_PROMPT
# prefill rows or the decode step's M = 1 (and the route's largest, 8),
# then one small ragged shape; the first is the kernels line's row. The
# int4 body's shapes are those the path launches with its siblings fused:
# gate|up 4096→28672 (first), q|k|v 4096→6144, out 4096→4096, down
# 14336→4096. int8_matmul also runs the head at the longest prompt's rows
# and at the decode step's M = 1 (its GEMV regime, the m <= 8 route on the
# card). int4_matmul also runs gate|up at the longest prompt's rows, and
# the ragged shape again at G = 16 (a fourth entry: the group size).
# int4_matmul_s8 also runs Moonlight-16B-A3B's projections that split K
# over a cluster: q|kv_a 2048→3648, o 2048→2048, layer 0's down 11264→2048
QUANT_SHAPES = {
    "int8_matmul": ((LLM_PROMPT, 4096, 128256), (LLM_LONG_PROMPT, 4096, 128256),
                    (1, 4096, 128256), (LLM_PROMPT, 4096, 4096), (3, 256, 1000)),
    "int4_matmul": ((LLM_PROMPT, 4096, 28672), (LLM_LONG_PROMPT, 4096, 28672),
                    (LLM_PROMPT, 4096, 6144), (LLM_PROMPT, 4096, 4096),
                    (LLM_PROMPT, 14336, 4096), (3, 256, 1000), (3, 256, 1000, 16)),
    "int4_matmul_s8": ((1, 4096, 28672), (1, 4096, 6144), (1, 4096, 4096), (1, 14336, 4096),
                       (8, 4096, 28672), (8, 14336, 4096), (3, 256, 1000), (1, 2048, 3648),
                       (1, 2048, 2048), (1, 11264, 2048)),
}
PROFILER = "llama-3.2-3b"
# phase 9's (M, K, N) for both profiler kernels: llama-3.2-3b's m = 1
# projections (gate/up first: the kernels line's row), its lm_head, the
# largest M of the W4A8 route and one small ragged shape
S8_SHAPES = ((1, 3072, 8192), (1, 3072, 3072), (1, 3072, 1024), (1, 8192, 3072),
             (1, 3072, 128256), (8, 3072, 8192), (3, 256, 1000))
# s8g4_matmul at llama-3.1-8b's decode shapes (M = 1, G = 128), beside
# int4_matmul_s8, the route the LLM path takes there, on the same inputs
S8G4_8B_SHAPES = ((1, 4096, 14336), (1, 14336, 4096))
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


def print_back_to_back(label: str, single: float, b2b: float, copies: list,
                       card: str) -> None:
    total = sum(nbytes(*args) for args in copies)
    print(f"{label}: single launch {single:.4f} ms, back-to-back {b2b:.4f} ms per launch ({BACK_TO_BACK} in a row over "
          f"{len(copies)} copies, {total / 1e6:.0f} MB) [{card}]")


def bound_ms(n_bytes: float, n_ops: float,
             peak_ops: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def checked_plan(lo, t: int, group: int, s_len: int, pairs: int) -> tuple:
    """llama_attention's plan for a label: ops/llama_ops.py's mirror,
    asserted equal to the plan the built kernel launches."""
    plan = lo.attention_plan(t, group, s_len, pairs)
    assert plan == lo.kernel_plan(t, group, s_len, pairs), (plan, t, group, s_len, pairs)
    return plan


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


def device_int(n: int, dev) -> torch.Tensor:
    """n as the one-element int32 tensor the self-attention kernels read
    valid_len from (made before a timed window: an int would be copied to
    the card inside it)."""
    return torch.tensor([n], dtype=torch.int32, device=dev)


def check_replay(name: str, fn, plain, args: tuple, t: int) -> tuple:
    """One launch of fn(*args, valid_len) captured in a CUDA graph with
    the device scalar at MID_DECODE, then t written into it and the graph
    replayed: the output must be the plain version's at t, and the plain
    version at the captured MID_DECODE (what a launch sized or masked at
    capture would give) must read above the limit."""
    vl = device_int(MID_DECODE, args[0].device)
    fn(*args, vl)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*args, vl)
    vl.fill_(t)
    graph.replay()
    torch.cuda.synchronize()
    err = compare(f"{name} captured at valid_len={MID_DECODE}, replayed at {t}", out,
                  plain(*args, t), {"captured valid_len": plain(*args, MID_DECODE)})
    del graph
    return err


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
    print_back_to_back(f"flash_attention B={b} H={h} T={t}", stats["flash_attention"]["ms"],
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
            print_back_to_back(
                f"cross_attention_int8 B={b} H={h} Tq={tq} "
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
                  f"{mean_rel:.3e} (limit 0.03)")
            assert mean_rel < 0.03, mean_rel
        # the kernel reads K and V only at t < seq_len, each once; s8 x s8 products
        rows[tq] = timed(f"cross_attention_s8 B={b} H={h} Tq={tq}",
                         lambda: att.cross_attention_s8(*args, seq_len=seq_len),
                         lambda: att.cross_attention_s8_reference(*args, seq_len=seq_len),
                         nbytes(qc, ks, vs, out) + 2 * b * h * d * seq_len,
                         4 * b * h * tq * seq_len * d, flush, peak_ops=PEAK_INT8_OPS)
        if tq in (1, BEAM):
            copies = input_copies(args, nbytes(*args))
            print_back_to_back(
                f"cross_attention_s8 B={b} H={h} Tq={tq} "
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
    from random K/V, valid_len a device int32 as the graphed beam step
    passes it. The row in the kernels line is the mid-decode one."""
    from turbo_whisper_workspace_tpu_torch.ops import whisper_ops as wo

    b, k, h, d = 8, BEAM, 20, 64
    t = PROMPT + DECODE
    stats = {}

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    # self_attention_int8: the regathered cache of the B·K beam rows
    kq, ks = wo.quantize_kv_rows(randn(b * k, t, h * d), h)      # (B·K, H, T, 64)
    vq, vs = wo.quantize_kv_rows(randn(b * k, t, h * d), h)
    q = randn(b * k, h, 1, d).to(torch.bfloat16)
    args = (q, kq, ks, vq, vs)
    rows, errs = {}, {}
    for valid in (MID_DECODE, t):
        vl = device_int(valid, dev)
        out = att.self_attention_int8(*args, vl)
        torch.cuda.synchronize()
        dropped = ({"valid_len mask": att.self_attention_int8_reference(*args, t)}
                   if valid < t else {})
        errs[valid] = compare(
            f"self_attention_int8 B·K={b * k} H={h} T={t} valid_len={valid}", out,
            att.self_attention_int8_reference(*args, valid), dropped)
        # K and V rows and their bf16 scales at t < valid_len, q and o
        label = f"self_attention_int8 valid_len={valid}"
        rows[valid] = timed(label, lambda: att.self_attention_int8(*args, vl),
                            lambda: att.self_attention_int8_reference(*args, vl),
                            nbytes(q, out) + 2 * b * k * h * valid * (d + 2),
                            4 * b * k * h * valid * d, flush)
        copies = input_copies(args, nbytes(*args))
        b2b = back_to_back_ms(lambda *a: att.self_attention_int8(*a, vl), copies, flush)
        print_back_to_back(label, rows[valid]["ms"], b2b, copies, card)
        del copies
    errs["replay"] = check_replay("self_attention_int8", att.self_attention_int8,
                                  att.self_attention_int8_reference, args, t)
    # two query rows sharing the copied K/V (not on the path: the prefill
    # takes self_attention_int8_xla), and Whisper's whole 448-position
    # context (the kernel's blocks, sized for 448 keys, run in three waves)
    q2 = randn(b * k, h, 2, d).to(torch.bfloat16)
    errs["Tq=2"] = compare(
        f"self_attention_int8 B·K={b * k} H={h} T={t} Tq=2 valid_len={MID_DECODE}",
        att.self_attention_int8(q2, *args[1:], device_int(MID_DECODE, dev)),
        att.self_attention_int8_reference(q2, *args[1:], MID_DECODE),
        {"valid_len mask": att.self_attention_int8_reference(q2, *args[1:], t)})
    del kq, vq, ks, vs, args, q2
    kq, ks = wo.quantize_kv_rows(randn(b * k, 448, h * d), h)
    vq, vs = wo.quantize_kv_rows(randn(b * k, 448, h * d), h)
    args = (q, kq, ks, vq, vs)
    for valid in (224, 448):
        vl = device_int(valid, dev)
        out = att.self_attention_int8(*args, vl)
        errs[(448, valid)] = compare(
            f"self_attention_int8 B·K={b * k} H={h} T=448 valid_len={valid}", out,
            att.self_attention_int8_reference(*args, valid),
            {"valid_len mask": att.self_attention_int8_reference(*args, 448)}
            if valid < 448 else {})
        row = timed(f"self_attention_int8 T=448 valid_len={valid}",
                    lambda: att.self_attention_int8(*args, vl),
                    lambda: att.self_attention_int8_reference(*args, vl),
                    nbytes(q, out) + 2 * b * k * h * valid * (d + 2),
                    4 * b * k * h * valid * d, flush)
    stats["self_attention_int8"] = kernel_row(rows[MID_DECODE], errs)
    del kq, vq, ks, vs, args

    # self_attention_int8_lanes: lane panels of B items, K lanes each, at
    # the beam phase's K = 5 (the row in the kernels line: mid-decode) and
    # at K = 8 over Whisper's whole 448-position context
    rows, errs = check_lanes(att, wo, dev, gen, flush, card, b, k, h, t,
                             (PROMPT, MID_DECODE, t), redesigned=(MID_DECODE, t))
    _, errs8 = check_lanes(att, wo, dev, gen, flush, card, b, 8, h, 448, (PROMPT, 224, 448))
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


def check_lanes(att, wo, dev, gen, flush, card: str, b: int, k: int, h: int, t: int,
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

    kq, ks = wo.quantize_kv_rows(randn(b, k * t, h * d), h)      # (B, H, K·T, 64)
    vq, vs = wo.quantize_kv_rows(randn(b, k * t, h * d), h)
    kp = kq.permute(0, 1, 3, 2).reshape(b, h * d, k * t).contiguous()
    vp = vq.permute(0, 2, 1, 3).reshape(b, k * t, h * d).contiguous()
    del kq, vq
    lane_map = random_ancestry(gen, b, k, t, dev)
    own_lanes = torch.arange(k, dtype=torch.int32, device=dev)[None, :, None].expand(
        b, k, t).contiguous()
    q = randn(b, h, k, d).to(torch.bfloat16)
    args = (q, kp, ks, vp, vs, lane_map)
    rows, errs = {}, {}
    ranks, slice_t = att.lanes_plan(t)
    for valid in valids:
        vl = device_int(valid, dev)
        out = att.self_attention_int8_lanes(*args, vl)
        torch.cuda.synchronize()
        dropped = {"lane selection": att.self_attention_int8_lanes_reference(
            q, kp, ks, vp, vs, own_lanes, valid)}
        if valid < t:
            dropped["valid_len mask"] = att.self_attention_int8_lanes_reference(*args, t)
        errs[valid] = compare(
            f"self_attention_int8_lanes B={b} K={k} H={h} T={t} valid_len={valid} "
            f"(plan: ranks, slice {(ranks, slice_t)}; "
            f"{ranks - -(-valid // slice_t)} ranks past valid_len)", out,
            att.self_attention_int8_lanes_reference(*args, valid), dropped)
        # the (lane, t) pairs some beam owns at t < valid_len: their K and V
        # bytes and bf16 scales in every head, and q, o, lane_map[..., :valid]
        pairs, sectors = k_panel_sectors(lane_map, valid, h)
        rows[valid] = timed(
            f"self_attention_int8_lanes K={k} T={t} valid_len={valid}, {pairs} owned "
            f"(lane, t) pairs of {b * k * valid}",
            lambda: att.self_attention_int8_lanes(*args, vl),
            lambda: att.self_attention_int8_lanes_reference(*args, vl),
            nbytes(q, out) + pairs * h * 2 * (d + 2) + b * k * valid * 4,
            4 * b * h * k * valid * d, flush)
        print(f"  K panel: the owned pairs' bytes lie in {sectors} 32-byte sectors "
              f"({sectors * 32 / 1e6:.2f} MB, {sectors * 32 / PEAK_BYTES * 1e3:.4f} ms at "
              f"3.35 TB/s)")
        if valid in redesigned:
            copies = input_copies(args, nbytes(*args))
            b2b = back_to_back_ms(lambda *a: att.self_attention_int8_lanes(*a, vl), copies,
                                  flush)
            print_back_to_back(
                f"self_attention_int8_lanes B={b} K={k} H={h} T={t} valid_len={valid}",
                rows[valid]["ms"], b2b, copies, card)
    if t == PROMPT + DECODE:
        errs["replay"] = check_replay("self_attention_int8_lanes",
                                      att.self_attention_int8_lanes,
                                      att.self_attention_int8_lanes_reference, args, t)
    return rows, errs


# wrappers beyond a module's launch_counts names: whisper_norm's entry mode
EXTRA_WRAPPERS = {"turbo_whisper_workspace_tpu_torch.ops.whisper_ops": ("whisper_embed_norm",)}


def counters() -> tuple:
    """The modules whose kernel wrappers count the Whisper paths' launches:
    ops/attention.py, ops/llama_ops.py (llama_attention over the bf16
    self cache) and ops/whisper_ops.py."""
    from turbo_whisper_workspace_tpu_torch.ops import attention as att
    from turbo_whisper_workspace_tpu_torch.ops import llama_ops as lo
    from turbo_whisper_workspace_tpu_torch.ops import whisper_ops as wo

    return att, lo, wo


def reset_counts(*modules) -> None:
    """Zero the launch counts of `modules` (default: counters())."""
    for mod in modules or counters():
        mod.reset_launch_counts()


def launches(*modules) -> dict:
    """kernel name → launches counted in `modules` (default: counters())."""
    return {n: c for mod in modules or counters() for n, c in mod.launch_counts.items()}


@contextlib.contextmanager
def plain_kernels(*modules):
    """Every kernel wrapper of the given modules (ops/attention.py,
    ops/quant.py, ops/llama_ops.py, ops/whisper_ops.py) replaced by its
    plain version, for a run that must launch nothing; EXTRA_WRAPPERS
    names the wrappers counted under another kernel's name."""
    kernels = {(mod, name): getattr(mod, name) for mod in modules
               for name in (*mod.launch_counts, *EXTRA_WRAPPERS.get(mod.__name__, ()))}
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
        with plain_kernels(*counters()):
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
            with plain_kernels(*counters()):
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
        with plain_kernels(*counters()):
            logits_plain = run()
    e = rel_err(logits, logits_plain)
    print(f"full-width decode step on the s8 route vs its plain twin: logits rel err "
          f"{e:.3e} (tolerance {MODEL_TOL}); launches {launched}")
    assert launched["cross_attention_s8"] == n_layer, launched
    assert launched["cross_attention_int8"] == 0, launched
    assert logits.shape == (1, 1, model.dims.n_vocab) and e <= MODEL_TOL


# ---------------------------------------------------------------------------
# Phase 7: the master flow (transcribe → diarize → merge → enrich)

# the JAX package's result keys (examples/golden/expected.json), and the
# enrichment's when the LLM stage runs
RESULT_KEYS = ["audio_path", "chunks", "diarization_segments", "duration", "language",
               "merged_segments", "processing_times", "segments", "text"]
ENRICH_KEYS = ["summary", "topics"]                 # + "speaker_names" when found
TIME_KEYS = ["diarization", "merge", "total", "transcription"]
DIAR_TOL = 5e-2            # relative L2 of bf16 nets on the card vs f32 on the CPU


def two_speaker_clip(seconds: float, seed: int):
    """Alternating two-speaker dialogue of harmonic voices at 115 and 285
    Hz with silences between turns, and its true turns (the synthetic
    conversation of tests/test_diarization_der.py)."""
    rng = np.random.default_rng(seed)
    audio = np.zeros(int(seconds * 16000), np.float32)
    turns, t, spk = [], 0.8, 0
    while t < seconds - 5.0:
        dur = float(rng.uniform(2.5, 4.5))
        tt = np.arange(int(dur * 16000)) / 16000
        f0 = (115.0, 285.0)[spk] * rng.uniform(0.97, 1.03)
        vib = 1.0 + 0.01 * np.sin(2 * np.pi * 5.0 * tt)
        sig = sum((0.5 / k) * np.sin(2 * np.pi * f0 * k * vib * tt + rng.uniform(0, 6))
                  for k in range(1, 6))
        am = 0.6 + 0.4 * np.clip(np.sin(2 * np.pi * rng.uniform(2, 4) * tt), 0, 1)
        seg = 0.3 * sig * am + 0.005 * rng.standard_normal(len(tt))
        i0 = int(t * 16000)
        audio[i0:i0 + len(seg)] = seg
        turns.append({"start": t, "end": t + dur, "speaker": f"S{spk}"})
        t += dur + float(rng.uniform(0.8, 1.3))
        spk = 1 - spk
    return audio, turns


def check_result_schema(res: dict, duration: float, enriched: bool) -> None:
    keys = sorted(RESULT_KEYS + (ENRICH_KEYS + (["speaker_names"] if "speaker_names" in res
                                                 else []) if enriched else []))
    assert sorted(res) == keys, sorted(res)
    assert sorted(res["processing_times"]) == sorted(TIME_KEYS + (["llm"] if enriched else []))
    assert abs(res["duration"] - duration) < 1e-3
    for seg in res["diarization_segments"]:
        assert 0.0 <= seg["start"] < seg["end"] <= duration + 1e-6, seg
    assert len(res["merged_segments"]) == len(res["segments"])


def check_diarization_nets(diarizer, cpu_seg, cpu_emb, audio: np.ndarray) -> None:
    """The bf16 nets on the card against the f32 nets of the same weights
    on the CPU, on the same mels: 8 segmentation windows and 8 crops."""
    from turbo_whisper_workspace_tpu_torch.ops import mel as mel_ops

    def pcm(rows):
        return torch.from_numpy(np.clip(np.stack(rows) * 32768.0, -32768, 32767)
                                .astype(np.int16))

    win, crop = 160000, 32000
    with torch.no_grad():
        seg_mel = mel_ops.log_mel_spectrogram(
            pcm([audio[i * 48000:i * 48000 + win] for i in range(8)]))[:, :, :1000]
        emb_mel = mel_ops.log_mel_spectrogram(
            pcm([audio[i * 16000:i * 16000 + crop] for i in range(8)]))[:, :, :200]
        for name, card_net, cpu_net, mel in (
                ("segmentation logits", diarizer.seg_params, cpu_seg, seg_mel),
                ("embeddings", diarizer.emb_params, cpu_emb, emb_mel)):
            got = card_net(mel.to(diarizer.device)).cpu()
            ref = cpu_net(mel)
            e = rel_err(got, ref)
            print(f"diarization {name}, bf16 on the card vs f32 on the CPU, "
                  f"{tuple(got.shape)}: rel err {e:.3e} (tolerance {DIAR_TOL})")
            assert got.shape == ref.shape and torch.isfinite(got).all() and e <= DIAR_TOL


def master_flow_phase(att, transcriber, dev, card: str):
    """Phase 7. Returns the launches of the flow's runs (counts zeroed
    just before them) and the pipeline, whose neural diarizer stays
    loaded for phase 10."""
    import dataclasses

    from turbo_whisper_workspace_tpu_torch.config import PipelineConfig
    from turbo_whisper_workspace_tpu_torch.llm import llm_helper
    from turbo_whisper_workspace_tpu_torch.models import convert
    from turbo_whisper_workspace_tpu_torch.models import embedding as emb_mod
    from turbo_whisper_workspace_tpu_torch.models import segmentation as seg_mod
    from turbo_whisper_workspace_tpu_torch.pipeline.audio_pipeline import (
        AudioProcessingPipeline)
    from turbo_whisper_workspace_tpu_torch.utils.metrics import der

    with tempfile.TemporaryDirectory() as tmp:
        # random nets at the default dims, seed 0, written as the
        # default names' checkpoints and loaded by name (bf16 on the card)
        cfg = PipelineConfig(models_dir=tmp)
        gen = torch.Generator().manual_seed(0)
        seg_dims, emb_dims = seg_mod.SegmentationDims(), emb_mod.EmbeddingDims()
        cpu_seg = seg_mod.init_params(seg_dims, gen)
        cpu_emb = emb_mod.init_params(emb_dims, gen)
        convert.save_params(os.path.join(tmp, f"seg-{cfg.diarization.segmentation_model}.npz"),
                            cpu_seg, meta=dataclasses.asdict(seg_dims))
        convert.save_params(os.path.join(tmp, f"emb-{cfg.diarization.embedding_model}.npz"),
                            cpu_emb, meta=dataclasses.asdict(emb_dims))
        pipe = AudioProcessingPipeline(cfg, transcriber=transcriber, device=dev)
        neural = pipe.load_diarizer()
        assert neural.seg_dims == seg_dims and neural.emb_dims == emb_dims
        for net in (neural.seg_params, neural.emb_params):
            w = next(net.parameters())
            assert w.dtype == torch.bfloat16 and w.device.type == dev.type, w
        print(f"diarizer: segmentation {seg_dims}, embedding {emb_dims}, bf16 from "
              f"{neural.segmentation_model!r} / {neural.embedding_model!r}")

        long_audio, truth = two_speaker_clip(75.0, seed=5)
        long_path = os.path.join(tmp, "two_speakers_75s.wav")
        write_wav(long_path, long_audio)
        check_diarization_nets(neural, cpu_seg, cpu_emb, long_audio)
        paths = [GOLDEN, long_path]
        durations = [15.0, 75.0]
        golden_want = json.load(open(os.path.join(REPO, "examples", "golden",
                                                  "expected.json")))["diarization_segments"]

        def report(label: str, results: list, wall: float) -> None:
            audio_s = sum(durations)
            t = results[0]["processing_times"]
            print(f"master flow, {label}: {len(paths)} files, {audio_s:.1f} s audio, wall "
                  f"{wall:.3f} s; transcription {t['transcription']:.3f} s, diarization "
                  f"{t['diarization']:.3f} s ({audio_s / t['diarization']:.1f} audio-s/s), "
                  f"merge {sum(r['processing_times']['merge'] for r in results):.6f} s; "
                  f"turns {[len(r['diarization_segments']) for r in results]} [{card}]")

        reset_counts()
        for label, names in (("neural tier, first call", {}), ("neural tier", {}),
                             ("weight-free tier", dict(segmentation_model="none",
                                                       embedding_model="none"))):
            t0 = time.perf_counter()
            results = pipe.process_batch(paths, num_speakers=2, enrich=False, **names)
            report(label, results, time.perf_counter() - t0)
            for res, path, duration in zip(results, paths, durations):
                assert res["audio_path"] == path
                check_result_schema(res, duration, enriched=False)
        fallback = pipe.load_diarizer(segmentation_model="none", embedding_model="none")
        assert fallback.seg_params is None and fallback.emb_params is None
        # the weight-free tier on the golden clip: its committed timeline
        # (±0.5 s), and on the 75 s dialogue: the DER bound of the JAX tests
        got = results[0]["diarization_segments"]
        assert [g["speaker"] for g in got] == [w["speaker"] for w in golden_want], got
        assert all(abs(g["start"] - w["start"]) <= 0.5 and abs(g["end"] - w["end"]) <= 0.5
                   for g, w in zip(got, golden_want)), got
        rep = der(truth, results[1]["diarization_segments"], duration_s=75.0)
        print(f"weight-free tier on the 75 s dialogue: DER {rep['der']:.4f} "
              f"(bound 0.25), {rep}")
        assert rep["der"] < 0.25, rep

        llm_helper.set_llm(llm_helper.DummyLLM())
        try:
            t0 = time.perf_counter()
            res = pipe.process_audio(long_path, num_speakers=0, enrich=True)
            wall = time.perf_counter() - t0
        finally:
            llm_helper.set_llm(None)
        check_result_schema(res, 75.0, enriched=True)
        t = res["processing_times"]
        print(f"master flow, process_audio(num_speakers=0, enrich=True) with DummyLLM: "
              f"wall {wall:.3f} s; transcription {t['transcription']:.3f} s, diarization "
              f"{t['diarization']:.3f} s ({75.0 / t['diarization']:.1f} audio-s/s), merge "
              f"{t['merge']:.6f} s, llm {t['llm']:.3f} s; "
              f"{len({s['speaker'] for s in res['diarization_segments']})} speakers [{card}]")
    counts = launches()
    print(f"launches on the master-flow path: {counts}")
    assert counts["flash_attention"] > 0 and counts["cross_attention_int8"] > 0, counts
    return counts, pipe


# ---------------------------------------------------------------------------
# Phase 8: the LLM enrichment path


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
    """Phase 8: each quantized-matmul kernel against its plain version
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
        if (m, k, n) in BEFORE_SHAPES["int8_matmul"]:
            copies = input_copies((x, wq, sc), nbytes(x, wq, sc))
            print_back_to_back(label, row["ms"], back_to_back_ms(tq.int8_matmul, copies, flush),
                               copies, card)
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

    # int4_matmul: the body prefill's four shapes (gate|up, q|k|v, out, down), ragged
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
            print_back_to_back(label, rows[(m, k, n, *group)]["ms"],
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

    # int4_matmul_s8: the decode step's four shapes (M = 1: gate|up, q|k|v, out,
    # down), the route's largest M, ragged
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
        n_groups = sc.shape[0]
        pb = tq.s8_pairs_per_block(m, k, n, n_groups, n % 16 == 0)
        plan = ("every group in a block" if pb == n_groups // 2 else
                f"K split over {-(-n_groups // 2 // pb)} ranks of {pb} pairs, "
                f"{-(-n // tq.S8_BLOCK_N[0])} clusters a row chunk, the card holds "
                f"{tq.s8_resident_clusters(m, k, n, n_groups, pb)} at once")
        print(f"  bit-equal to its plain version: {same}; {plan}")
        assert same
        # the packed weight and its scales, xq, xs and the bf16 output
        label = f"int4_matmul_s8 M={m} K={k} N={n}"
        rows[(m, k, n)] = timed(label, lambda: tq.int4_matmul_s8(xq, xs, wq, sc),
                                lambda: tq.int4_matmul_s8_reference(xq, xs, wq, sc),
                                nbytes(xq, xs, wq, sc, out), 2 * m * k * n, flush,
                                peak_ops=PEAK_INT8_OPS)
        copies = input_copies((xq, xs, wq, sc), nbytes(xq, xs, wq, sc))
        print_back_to_back(label, rows[(m, k, n)]["ms"],
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
def residual_stream(lo):
    """Records the residual stream of each models/llama.py:forward run
    inside: the value every RMSNorm normalises (the residual sum its
    llama_norm_quant call forms), in call order ([2l] enters layer l,
    [2l + 1] follows its attention, the last enters the final norm)."""
    seen = []
    norm_quant = lo.llama_norm_quant

    def recording(*args, **kw):
        out = norm_quant(*args, **kw)
        if kw.get("norm", True):
            seen.append(out[0].clone())
        return out

    lo.llama_norm_quant = recording
    try:
        yield seen
    finally:
        lo.llama_norm_quant = norm_quant


def layer_errors(got: list, ref: list) -> str:
    """Relative error of the hidden state after each layer."""
    return " ".join(f"{rel_err(a, b):.2e}" for a, b in zip(got[2::2], ref[2::2]))


def check_llm_model(tq, lo, lm, params, dims, dev) -> None:
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

    def counts():
        return {**tq.launch_counts, **lo.launch_counts}

    with torch.no_grad():
        before = counts()
        with residual_stream(lo) as hidden:
            logits, _ = lm.forward(params, dims, prompt, cache, pos=0)
        launched = {n: c - before[n] for n, c in counts().items()}
        prefilled = {key: x.clone() for key, x in cache.items()}
        with plain_kernels(tq, lo), residual_stream(lo) as hidden_plain:
            logits_plain, _ = lm.forward(params, dims, prompt,
                                         {key: torch.zeros_like(x) for key, x in cache.items()})
        e_prefill = rel_err(logits, logits_plain)
        e_layers = layer_errors(hidden, hidden_plain)
        # control: the plain twin again with TF32 matmuls. Every f32 product
        # of the forward is of bf16 values, exact in TF32, so this twin
        # parts from the plain one only in the order of its f32 sums
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            with plain_kernels(tq, lo), residual_stream(lo) as hidden_tf32:
                logits_tf32, _ = lm.forward(params, dims, prompt, {
                    key: torch.zeros_like(x) for key, x in cache.items()})
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        e_tf32 = rel_err(logits_tf32, logits_plain)
        e_tf32_layers = layer_errors(hidden_tf32, hidden_plain)
        del logits, logits_plain, logits_tf32, hidden, hidden_plain, hidden_tf32
        before = counts()
        with residual_stream(lo) as hidden:
            step_logits, _ = lm.forward(params, dims, step, cache, pos=LLM_PROMPT)
        launched_step = {n: c - before[n] for n, c in counts().items()}
        with plain_kernels(tq, lo), residual_stream(lo) as hidden_plain:
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
    # the int4 body a layer: q|k|v, out, gate|up and down, the siblings fused
    layers = dims.n_layer
    n_proj = 4 * layers
    # a layer: attention, RoPE, SwiGLU once; the norm twice (and the final
    # norm), plus the out projection's quantizer at a decode step
    # (the experts' two kernels launch in no Llama layer)
    assert launched == {"int8_matmul": 1, "int4_matmul": n_proj, "int4_matmul_s8": 0,
                        "int4_moe_s8": 0, "int4_group_matmul": 0,
                        "llama_attention": layers, "llama_norm_quant": 2 * layers + 1,
                        "llama_rope_cache": layers, "llama_swiglu_quant": layers}
    # the decode step's head: int8_matmul's GEMV regime on the card
    assert launched_step == {"int8_matmul": 1, "int4_matmul": 0, "int4_matmul_s8": n_proj,
                             "int4_moe_s8": 0, "int4_group_matmul": 0,
                             "llama_attention": layers, "llama_norm_quant": 3 * layers + 1,
                             "llama_rope_cache": layers, "llama_swiglu_quant": layers}
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


def device_us(e) -> float:
    """A profiler event's self time on the device, in µs."""
    return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))


def calls(events, prefix: str) -> int:
    """Host calls of the CUDA runtime functions named `prefix`... in a
    profiler window (cudaLaunchKernel also counts cudaLaunchKernelExC,
    the cluster launches of the port's kernels)."""
    return sum(e.count for e in events if e.key.startswith(prefix))


def profile_decode(lm, params, dims, dev, card: str, prompt_len: int = 1500,
                   steps: int = 3, graphed: bool = False) -> None:
    """Where a decode step's time goes: host wall per step against the
    device's busy time (torch.profiler, kernel self time) after a
    prompt_len-token prefill, the kernel launches per step and the
    kernels that take the most device time. graphed: the step is
    models/llama.py:forward at a device position captured once in a
    CUDA graph (utils/step_loop.StepGraph, as llm/generate.py runs it)
    and replayed; else forward at a host position, eagerly."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(dev).manual_seed(4)
    prompt = torch.randint(0, dims.n_vocab, (1, prompt_len), generator=gen, device=dev)
    cache = lm.init_kv_cache(dims, 1, prompt_len + 2 * steps + 2, dtype=torch.bfloat16,
                             device=dev)
    tok = torch.zeros((1, 1), dtype=torch.long, device=dev)
    with torch.no_grad():
        lm.forward(params, dims, prompt, cache, pos=0)
        if graphed:
            from turbo_whisper_workspace_tpu_torch.utils.step_loop import StepGraph

            pos = torch.tensor(prompt_len, device=dev)

            def step():
                lm.forward(params, dims, tok, cache, pos=pos)
                pos.add_(1)

            run = StepGraph(step, {"pos": pos}).replay
        else:
            at = [prompt_len]

            def run():
                lm.forward(params, dims, tok, cache, pos=at[0])
                at[0] += 1

        run()                                                        # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                run()
            torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if device_us(e) > 0 and not e.key.startswith("aten::")]
    busy = sum(device_us(e) for e in kernels) / steps / 1e3
    run_ = sum(e.count for e in kernels) / steps
    launches = calls(events, "cudaLaunchKernel") / steps
    graph_launches = calls(events, "cudaGraphLaunch") / steps
    print(f"decode step profile ({LLM}, cache at {prompt_len} positions, "
          f"{'graphed' if graphed else 'eager'}): host wall "
          f"{wall * 1e3:.2f} ms per step, device busy {busy:.2f} ms per step "
          f"({100 * (1 - busy / (wall * 1e3)):.0f}% idle), {run_:.0f} kernels run, "
          f"{launches:.0f} kernel launches and {graph_launches:.0f} graph launches per "
          f"step [{card}]")
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
    kernels = sorted((e for e in events if device_us(e) > 0 and not e.key.startswith("aten::")),
                     key=device_us, reverse=True)
    busy = sum(device_us(e) for e in kernels) / 1e3
    print(f"prefill profile ({LLM}, {prompt_len} tokens): device busy {busy:.2f} ms, host "
          f"wall {wall * 1e3:.1f} ms (profiled) [{card}]")
    for e in kernels[:8]:
        print(f"  {device_us(e) / 1e3:.3f} ms, {e.count} calls: {e.key[:90]}")


def llm_model(tq, lm, dev):
    """llama-3.1-8b at the Q4 point: random bf16 weights from seed 0
    drawn on the card and quantized there, then as a TorchLlama on the
    card holds them (the int4 siblings fused where the tree fuses)."""
    from turbo_whisper_workspace_tpu_torch.llm import llm_helper

    dims = lm.LLAMA_CONFIGS[LLM]
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = tq.quantize_tree(lm.init_params(dims, torch.Generator(dev).manual_seed(0),
                                             torch.bfloat16, dev), bits=4)
    params = llm_helper.TorchLlama(params, dims, device=dev).params
    torch.cuda.synchronize()
    print(f"{LLM}: random bf16 weights (seed 0) drawn and quantized on the card in "
          f"{time.perf_counter() - t0:.1f} s; {torch.cuda.memory_allocated() / 1e9:.2f} GB "
          f"allocated, peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return params, dims


def llm_phase(att, dev, card: str):
    """Phase 8. Returns the three kernels' stats, the launches of the
    stage's run (counts zeroed just before it) and the TorchLlama, kept
    for phase 10."""
    from turbo_whisper_workspace_tpu_torch.config import LLMConfig
    from turbo_whisper_workspace_tpu_torch.models import llama as lm
    from turbo_whisper_workspace_tpu_torch.ops import llama_ops as lo
    from turbo_whisper_workspace_tpu_torch.ops import quant as tq

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
    check_llm_model(tq, lo, lm, params, dims, dev)
    profile_prefill(lm, params, dims, dev, card)

    tq.reset_launch_counts()
    att.reset_launch_counts()
    lo.reset_launch_counts()
    llm = run_llm_stages(params, dims, dev, card)
    counts = {**dict(tq.launch_counts), **dict(lo.launch_counts),
              **{n: c for n, c in att.launch_counts.items() if c}}
    print(f"launches on the LLM path: {counts}")
    # every kernel of the Llama path (the experts' two run in phase 17)
    assert all(counts[name] > 0 for name in (*tq.launch_counts, *lo.launch_counts)
               if name not in ("int4_moe_s8", "int4_group_matmul")), counts
    profile_decode(lm, params, dims, dev, card)
    return qstats, counts, llm


def run_llm_stages(params, dims, dev, card: str):
    """Phase 8's stage end to end: a TorchLlama of the model injected with
    set_llm, then AudioProcessingPipeline's identify_speaker_names,
    generate_summary and extract_topics on the 20-segment conversation,
    each timed. Returns the TorchLlama (set_llm cleared)."""
    from turbo_whisper_workspace_tpu_torch.config import LLMConfig, PipelineConfig
    from turbo_whisper_workspace_tpu_torch.llm import llm_helper
    from turbo_whisper_workspace_tpu_torch.pipeline.audio_pipeline import (
        AudioProcessingPipeline)

    llm_cfg = LLMConfig()
    llm = llm_helper.TorchLlama(params, dims, device=dev)
    llm_helper.set_llm(llm)
    llm_pipe = AudioProcessingPipeline(PipelineConfig(llm=llm_cfg), device=dev)
    segs = conversation()
    stages = (("identify_speaker_names", dict, llm_cfg.max_tokens_names),
              ("generate_summary", str, llm_cfg.max_tokens_summary),
              ("extract_topics", list, llm_cfg.max_tokens_topics))
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
    llm_helper.set_llm(None)
    return llm


# ---------------------------------------------------------------------------
# Phase 9: the LLM-ops profiler path


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
    """Phase 9: s8_matmul and s8g4_matmul against their plain versions at
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
        if (m, k, n) in BEFORE_SHAPES["s8_matmul"]:
            copies = input_copies((xq, xs, wq, sc), nbytes(xq, xs, wq, sc))
            print_back_to_back(label, rows[(m, k, n)]["ms"],
                               back_to_back_ms(prof.s8_matmul, copies, flush), copies, card)
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
            print_back_to_back(label, single, back_to_back_ms(tq.int8_matmul, copies, flush),
                               copies, card)
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
        same = torch.equal(out, ref)
        print(f"  bit-equal to its plain version: {same} (plan {prof.s8g4_plan(m, k, n)})")
        assert same
        same = torch.equal(out, tq.int4_matmul_s8(xq, xs, wq, sc))
        print(f"  equal to the int4_matmul_s8 kernel on the same inputs: {same}")
        assert same
        label = f"s8g4_matmul M={m} K={k} N={n}"
        rows[(m, k, n)] = timed(label, lambda: prof.s8g4_matmul(xq, xs, wq, sc),
                                lambda: prof.s8g4_matmul_reference(xq, xs, wq, sc),
                                nbytes(xq, xs, wq, sc, out), 2 * m * k * n, flush,
                                peak_ops=PEAK_INT8_OPS)
        copies = input_copies((xq, xs, wq, sc), nbytes(xq, xs, wq, sc))
        print_back_to_back(label, rows[(m, k, n)]["ms"],
                           back_to_back_ms(prof.s8g4_matmul, copies, flush), copies, card)
        del q, wq, sc, xq, xs, out, ref, dropped, copies
    for m, k, n in S8G4_8B_SHAPES:
        # context for the LLM path's decode body, whose route stays
        # int4_matmul_s8: both kernels on the same inputs, equal outputs
        q = tq.quantize_int4(randn(k, n) * k ** -0.5)
        wq, sc = q["w_q4"], q["scale4"]
        xq, xs = tq.quant_act_grouped(randn(m, k), sc.shape[0])
        out = prof.s8g4_matmul(xq, xs, wq, sc)
        same = torch.equal(out, tq.int4_matmul_s8(xq, xs, wq, sc))
        print(f"s8g4_matmul M={m} K={k} N={n} (llama-3.1-8b, plan {prof.s8g4_plan(m, k, n)}):"
              f" bit-equal to its plain version "
              f"{torch.equal(out, prof.s8g4_matmul_reference(xq, xs, wq, sc))}, equal to the "
              f"int4_matmul_s8 kernel on the same inputs {same}")
        assert same and torch.equal(out, prof.s8g4_matmul_reference(xq, xs, wq, sc))
        copies = input_copies((xq, xs, wq, sc), nbytes(xq, xs, wq, sc))
        times = {name: (time_ms(lambda: fn(xq, xs, wq, sc), flush),
                        back_to_back_ms(fn, copies, flush))
                 for name, fn in (("s8g4_matmul", prof.s8g4_matmul),
                                  ("int4_matmul_s8", tq.int4_matmul_s8))}
        bms, _ = bound_ms(nbytes(xq, xs, wq, sc, out), 2 * m * k * n, PEAK_INT8_OPS)
        print("  " + "; ".join(f"{name} single launch {a:.4f} ms, back-to-back {b2b:.4f} ms"
                               for name, (a, b2b) in times.items())
              + f"; bound {bms:.4f} ms [{card}]")
        del q, wq, sc, xq, xs, out, copies
    stats["s8g4_matmul"] = kernel_row(rows[S8_SHAPES[0]], errs)
    stats["s8g4_matmul"]["library_note"] = (
        "no PyTorch call takes int4 weights packed in halves with grouped int8 activations")
    return stats


def profiler_phase(dev, card: str):
    """Phase 9. Returns the two kernels' stats and the launches of the
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


# ---------------------------------------------------------------------------
# Phase 10: the offline tool shell


class CountedPipeline:
    """A pipeline whose process_batch calls are recorded (the monitor's
    directory mode must make one)."""

    def __init__(self, pipe):
        self.pipe, self.calls = pipe, []

    def process_batch(self, files, **kw):
        self.calls.append(list(files))
        return self.pipe.process_batch(files, **kw)


def write_rttm(path: str, stem: str, turns: list) -> None:
    """NIST RTTM SPEAKER lines (a name holds no blank: "Speaker 0" → "Speaker_0")."""
    with open(path, "w") as f:
        for t in turns:
            name = t["speaker"].replace(" ", "_")
            f.write(f"SPEAKER {stem} 1 {t['start']:.3f} {t['end'] - t['start']:.3f} "
                    f"<NA> <NA> {name} <NA> <NA>\n")


def tool_shell_phase(att, tq, pipe, llm, dev, card: str) -> dict:
    """Phase 10. Returns the launches of the phase's runs (counts zeroed
    just before them)."""
    import shutil

    from turbo_whisper_workspace_tpu_torch import __main__ as cli
    from turbo_whisper_workspace_tpu_torch.analysis import bar_security_monitor as bar
    from turbo_whisper_workspace_tpu_torch.analysis import preprocess as pp
    from turbo_whisper_workspace_tpu_torch.analysis.security_monitor import SecurityMonitor
    from turbo_whisper_workspace_tpu_torch.config import DiarizationConfig, PipelineConfig
    from turbo_whisper_workspace_tpu_torch.llm import llm_helper
    from turbo_whisper_workspace_tpu_torch.pipeline.audio_pipeline import (
        AudioProcessingPipeline)
    from turbo_whisper_workspace_tpu_torch.utils.evaluate import evaluate_corpus

    dialogue, truth = two_speaker_clip(75.0, seed=5)
    golden_want = json.load(open(os.path.join(REPO, "examples", "golden", "expected.json")))
    from turbo_whisper_workspace_tpu_torch.ops import llama_ops as lo

    reset_counts(*counters(), tq)
    with tempfile.TemporaryDirectory() as tmp:
        audio_dir, ref_dir, rttm_dir = (os.path.join(tmp, d) for d in ("audio", "ref", "rttm"))
        for d in (audio_dir, ref_dir, rttm_dir):
            os.makedirs(d)
        shutil.copy(GOLDEN, os.path.join(audio_dir, "golden.wav"))
        write_wav(os.path.join(audio_dir, "dialogue.wav"), dialogue)

        # the monitor's directory mode: one process_batch over both files
        # (phase 7's pipeline, neural diarization, DummyLLM enrichment)
        counted = CountedPipeline(pipe)
        llm_helper.set_llm(llm_helper.DummyLLM())
        try:
            t0 = time.perf_counter()
            incidents = SecurityMonitor(pipeline=counted, output_dir=os.path.join(tmp, "inc"),
                                        device=dev).monitor_directory(audio_dir)
            wall = time.perf_counter() - t0
        finally:
            llm_helper.set_llm(None)
        assert len(counted.calls) == 1 and len(counted.calls[0]) == 2, counted.calls
        print(f"security monitor, directory of 2 files (90.0 s audio): one process_batch "
              f"call, wall {wall:.3f} s, {len(incidents)} incidents [{card}]")

        # the mock transcript, its incident summary generated on the card
        llm_helper.set_llm(llm)
        try:
            llm.last_generation = {}
            t0 = time.perf_counter()
            inc = bar.run_mock_analysis(monitor=bar.BarSecurityMonitor(
                output_dir=os.path.join(tmp, "bar"), device=dev))
            wall = time.perf_counter() - t0
        finally:
            llm_helper.set_llm(None)
        assert inc is not None and inc.incident_type == "underage_drinking", inc
        g = llm.last_generation
        assert g, "the incident summary was not generated"   # generate_text hides errors
        steps = g["decode_forwards"] + 1
        print(f"mock bar incident ({inc.incident_type}, level {inc.threat_level}/5): summary "
              f"prompt {g['prompt_tokens']} tokens, {steps} sampled (max 128); prefill "
              f"{g['prefill_s'] * 1e3:.1f} ms; decode "
              f"{g['decode_s'] * 1e3 / max(steps - 1, 1):.3f} ms per step; summary "
              f"{len(inc.summary)} chars; wall {wall:.3f} s [{card}]")

        # corpus WER and DER on the weight-free diarization tier
        for stem, turns in (("golden", golden_want["diarization_segments"]),
                            ("dialogue", truth)):
            write_rttm(os.path.join(rttm_dir, f"{stem}.rttm"), stem, turns)
            with open(os.path.join(ref_dir, f"{stem}.txt"), "w") as f:
                f.write(golden_want["text"] if stem == "golden" else "")
        eval_pipe = AudioProcessingPipeline(
            PipelineConfig(diarization=DiarizationConfig(segmentation_model="none",
                                                         embedding_model="none")),
            transcriber=pipe.load_transcription_model(), device=dev)
        t0 = time.perf_counter()
        rep = evaluate_corpus(audio_dir, ref_dir=ref_dir, rttm_dir=rttm_dir, pipeline=eval_pipe,
                              num_speakers=2, device=dev)
        wall = time.perf_counter() - t0
        print(f"evaluator, 2 files: corpus WER {rep['wer']} over {rep['wer_ref_words']} "
              f"reference words (random weights, empty references: WER counts inserted "
              f"words), corpus DER {rep['der']} (missed {rep['missed']}, false alarm "
              f"{rep['false_alarm']}, confusion {rep['confusion']}), per file "
              f"{rep['files']}; wall {wall:.3f} s [{card}]")
        assert rep["files"]["dialogue"]["der"] < 0.25 and rep["files"]["golden"]["der"] < 0.25, rep

        # preprocessing on the card against the same calls on the CPU
        for name, fn in (("dynamic_normalize", pp.dynamic_normalize),
                         ("spectral_denoise", pp.spectral_denoise)):
            fn(dialogue, device=dev)                      # warm-up
            walls = {}
            outs = {}
            for where in (dev, "cpu"):
                t0 = time.perf_counter()
                outs[str(where)] = fn(dialogue, device=where)
                walls[str(where)] = time.perf_counter() - t0
            got, ref = outs[str(dev)], outs["cpu"]
            e = float(np.linalg.norm(got - ref) / np.linalg.norm(ref))
            print(f"{name} on 75 s: card {walls[str(dev)] * 1e3:.2f} ms, CPU "
                  f"{walls['cpu'] * 1e3:.2f} ms (numpy in and out); card vs CPU rel err "
                  f"{e:.3e} (tolerance 1e-4) [{card}]")
            assert got.shape == ref.shape and np.isfinite(got).all() and e <= 1e-4, e

        # the CLI on the card
        cli.main(["check-gpu"])
        cli.main(["info", "-i", GOLDEN])
        cli.main(["diagnose", "-i", GOLDEN])
        out = os.path.join(tmp, "golden_pre.wav")
        cli.main(["preprocess", "-i", GOLDEN, "-o", out, "--denoise", "0.3", "--dynamic",
                  "--device", str(dev)])
        assert os.path.getsize(out) > 44
    counts = {n: c for n, c in launches(*counters(), tq).items() if c}
    print(f"launches on the tool-shell path: {counts}")
    for name in ("flash_attention", "cross_attention_int8", "int4_matmul", "int4_matmul_s8",
                 "int8_matmul", *lo.launch_counts):
        assert counts.get(name, 0) > 0, (name, counts)
    return counts


# ---------------------------------------------------------------------------
# Phase 11: serving


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def serving_phase(att, pipe, dev, card: str) -> dict:
    """Phase 11. Returns the launches of the phase's requests (counts
    zeroed just before them)."""
    from turbo_whisper_workspace_tpu_torch.audio import io as audio_io
    from turbo_whisper_workspace_tpu_torch.llm import llm_helper
    from turbo_whisper_workspace_tpu_torch.serve import api
    from turbo_whisper_workspace_tpu_torch.serve.client import (APIClient,
                                                                ensure_api_server_running)

    dialogue, _ = two_speaker_clip(75.0, seed=5)
    golden_s = len(audio_io.read_audio_file(GOLDEN)[0]) / 16000
    api.set_pipeline(pipe)
    llm_helper.set_llm(llm_helper.DummyLLM())
    httpd = api.serve("127.0.0.1", 0, device=dev)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    booted = None

    def timed(label: str, fn, *args):
        t0 = time.perf_counter()
        res = fn(*args)
        print(f"served {label}: wall {time.perf_counter() - t0:.3f} s [{card}]")
        return res

    def check_transcript(res: dict) -> None:
        enriched = "summary" in res
        check_result_schema(res, golden_s, enriched)
        assert isinstance(res["text"], str) and res["language"]

    reset_counts()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            dialogue_path = os.path.join(tmp, "dialogue.wav")
            write_wav(dialogue_path, dialogue)
            client = APIClient(f"http://127.0.0.1:{httpd.server_address[1]}")
            root = timed("GET /", client.health)
            assert root["name"] == "turbo-whisper-workspace-tpu-torch", root
            models = timed("GET /api/models", client.models)
            assert "large-v3-turbo" in models["whisper_models"], models
            lone = timed(f"POST /api/transcribe (golden clip, {golden_s:.1f} s)",
                         client.transcribe, GOLDEN)
            check_transcript(lone)
            sec = timed("POST /api/security/analyze (75 s dialogue)",
                        client.security_analyze, dialogue_path)
            assert isinstance(sec["incident_detected"], bool), sec
            ana = timed("POST /api/analyze (75 s dialogue)", client.analyze, dialogue_path)
            assert abs(ana["audio_info"]["duration"] - 75.0) < 1e-3, ana["audio_info"]
            assert len(ana["plots"]) == 4 or "plots_error" in ana, sorted(ana)
            print(f"  /api/analyze: {len(ana['plots'])} plots"
                  + (f" ({ana['plots_error']})" if "plots_error" in ana else ""))
            both, walls = [None, None], [0.0, 0.0]

            def call(i: int) -> None:
                t0 = time.perf_counter()
                both[i] = client.transcribe(GOLDEN)
                walls[i] = time.perf_counter() - t0

            t0 = time.perf_counter()
            threads = [threading.Thread(target=call, args=(i,)) for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            wall = time.perf_counter() - t0
            print(f"served 2 concurrent POST /api/transcribe (golden clip): walls "
                  f"{walls[0]:.3f} and {walls[1]:.3f} s, {wall:.3f} s together [{card}]")
            for res in both:
                assert res is not None, "a concurrent request did not answer"
                check_transcript(res)
                assert res["text"] == lone["text"], (res["text"], lone["text"])
                assert res["merged_segments"] == lone["merged_segments"]
            print(f"  concurrent responses equal the lone one: text ({len(lone['text'])} "
                  f"chars) and {len(lone['merged_segments'])} merged segments")
            booted = ensure_api_server_running(port=free_port(), device=str(dev))
            assert timed("GET / (self-booted server)", booted.health)["name"] == root["name"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        llm_helper.set_llm(None)
        api.set_pipeline(None)
    counts = {n: c for n, c in launches().items() if c}
    print(f"launches on the serving path: {counts}")
    for name in ("flash_attention", "cross_attention_int8"):
        assert counts.get(name, 0) > 0, (name, counts)
    return counts


# ---------------------------------------------------------------------------
# Phase 12: parallelism

TP_LAYERS = 4              # large-v3-turbo widths at 4 + 4 layers for TP = 2
TP_DECODE = 32             # greedy steps of the TP check
TP_TIMEOUT_S = 600         # the two TP processes, joined
TRAIN_BATCH, TRAIN_TOKENS, TRAIN_STEPS, TRAIN_LR = 2, 12, 3, 1e-3
GRAD_TOL = 1e-2            # relative L2 of flash_attention's gradients, bf16
# TP and unsharded bf16 logits differ by rounding alone (max abs 0.027 at
# the prefill, NVIDIA H100 80GB HBM3, 700 W), and random weights leave
# top-2 gaps near 0.12: a TP decode may leave the unsharded one only at a
# decision whose margin is within twice that difference
TIE_NATS = 0.05


def pcm_windows(n: int, seed0: int) -> torch.Tensor:
    """n synthesized 30 s windows as int16 PCM (the transcriber's input)."""
    audio = np.stack([synth_clip(30.0, seed=s) for s in range(seed0, seed0 + n)])
    return torch.from_numpy(np.clip(audio * 32768.0, -32768, 32767).astype(np.int16))


def tp_worker(rank: int, world: int, port: int, out_dir: str) -> int:
    """`chip_smoke.py --tp-worker RANK WORLD PORT DIR`: one rank of phase
    12's TP = 2 check, sharing the card with the other over gloo; writes
    DIR/tp_rank<RANK>.json (rank 0 also decodes with the unsharded
    module)."""
    import dataclasses
    import datetime

    import torch.distributed as dist

    from turbo_whisper_workspace_tpu_torch.decode import greedy as greedy_mod
    from turbo_whisper_workspace_tpu_torch.decode.rules import DecodeRules
    from turbo_whisper_workspace_tpu_torch.decode.tokenizer import special_tokens_for_vocab
    from turbo_whisper_workspace_tpu_torch.models import whisper as wm
    from turbo_whisper_workspace_tpu_torch.ops import attention as att
    from turbo_whisper_workspace_tpu_torch.ops import mel as mel_ops
    from turbo_whisper_workspace_tpu_torch.parallel import infer
    from turbo_whisper_workspace_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=300))
    dims = dataclasses.replace(wm.WHISPER_CONFIGS["large-v3-turbo"], n_audio_layer=TP_LAYERS,
                               n_text_layer=TP_LAYERS)
    model = wm.init_params(dims, torch.Generator(dev).manual_seed(0), dtype=torch.bfloat16)
    rules = DecodeRules(specials=special_tokens_for_vocab(dims.n_vocab), timestamps=True)
    pcm = pcm_windows(8, seed0=5)
    sot = rules.specials.sot_sequence(language="en", task="transcribe", timestamps=True)
    prompt = torch.tensor([sot] * len(pcm))
    mesh = make_mesh(model_parallel=world, device_type="cuda")
    fn = infer.make_tp_decode(model, mesh, rules=rules, max_len=TP_DECODE, quantize_kv=True)
    local = fn.model
    reset_counts()
    t0 = time.perf_counter()
    res, collectives = infer.count_collectives(fn, pcm, prompt)
    torch.cuda.synchronize()
    out = {"wall": time.perf_counter() - t0, "launches": launches(),
           "collectives": collectives, "tokens": res.tokens.tolist(),
           "lengths": res.lengths.tolist(),
           "heads": [local.encoder.blocks[0].n_head, local.decoder.n_head],
           "q": list(local.encoder.blocks[0].attn.q.weight.shape),
           "fc2": list(local.encoder.blocks[0].mlp.fc2.weight.shape)}
    with torch.no_grad():
        kv = local.decoder.precompute_cross_kv(
            torch.zeros(1, dims.n_audio_ctx, dims.n_audio_state, dtype=model.dtype,
                        device=dev), quantize=True)
    out["k_q"] = list(kv["k_q"].shape)

    # the unsharded module's decode on rank 0, its tokens sent to rank 1
    ref_tokens = torch.empty_like(res.tokens)
    if rank == 0:
        t0 = time.perf_counter()
        with torch.no_grad():
            mels = mel_ops.log_mel_spectrogram(pcm.to(dev), num_mels=dims.n_mels)
            ckv = model.decoder.precompute_cross_kv(model.encoder(mels), quantize=True)
            ref = greedy_mod.greedy_decode_features(model, ckv, prompt.to(dev), rules=rules,
                                                    max_len=TP_DECODE)
        torch.cuda.synchronize()
        out["ref_wall"] = time.perf_counter() - t0
        ref_tokens.copy_(ref.tokens)
    dist.broadcast(ref_tokens, src=0)

    def forced(module) -> torch.Tensor:
        """Logits of every sampled position, teacher-forced on the
        unsharded decode's tokens (the decisions it made)."""
        with torch.no_grad():
            mels = mel_ops.log_mel_spectrogram(pcm.to(dev), num_mels=dims.n_mels)
            ckv = module.decoder.precompute_cross_kv(module.encoder(mels), quantize=True)
            return module.decoder(ref_tokens[:, :-1], ckv)[0][:, prompt.shape[1] - 1:]

    tp_logits = forced(local)
    if rank == 0:
        ref_logits = forced(model)
        out["ref_tokens"] = ref_tokens.tolist()
        out["forced_rel_err"] = rel_err(tp_logits, ref_logits)
        out["forced_max_abs"] = float((tp_logits - ref_logits).abs().max())
        # where a row's free-running TP decode first leaves the unsharded
        # one: the unsharded logits' margin between its choice and TP's
        p = prompt.shape[1]
        out["divergence"] = []
        for row, (a, b) in enumerate(zip(res.tokens.tolist(), ref_tokens.tolist())):
            t = next((i for i in range(p, len(a)) if a[i] != b[i]), None)
            margin = None if t is None else float(
                ref_logits[row, t - p, b[t]] - ref_logits[row, t - p, a[t]])
            out["divergence"].append([None if t is None else t - p, margin])
    with open(os.path.join(out_dir, f"tp_rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def tp_check(card: str) -> dict:
    """Phase 12 (c): two `--tp-worker` processes; returns the launches of
    their TP decodes, summed."""
    port = free_port()
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--tp-worker",
                                   str(r), "2", str(port), out]) for r in range(2)]
        try:
            deadline = time.monotonic() + TP_TIMEOUT_S
            rcs = [p.wait(timeout=max(deadline - time.monotonic(), 1)) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        assert rcs == [0, 0], f"TP workers exited {rcs}"
        ranks = []
        for r in range(2):
            with open(os.path.join(out, f"tp_rank{r}.json")) as f:
                ranks.append(json.load(f))
    r0 = ranks[0]
    print(f"TP = 2 vs the unsharded module, both teacher-forced on the unsharded "
          f"decode's tokens (8 windows x {TP_DECODE} steps): logits rel L2 "
          f"{r0['forced_rel_err']:.3e}, max abs {r0['forced_max_abs']:.3e} (tolerance "
          f"{MODEL_TOL}) [{card}]")
    assert r0["forced_rel_err"] <= MODEL_TOL, r0["forced_rel_err"]
    for r, got in enumerate(ranks):
        print(f"TP = 2, rank {r}: {got['heads'][0]} encoder / {got['heads'][1]} decoder heads, "
              f"q {got['q']}, fc2 {got['fc2']}, int8 cross-K {got['k_q']}; 8 windows x "
              f"{TP_DECODE} steps, wall {got['wall']:.3f} s; collectives {got['collectives']}; "
              f"launches {({n: c for n, c in got['launches'].items() if c})} [{card}]")
        assert got["heads"] == [10, 10] and got["k_q"][2] == 10, got["heads"]
        assert got["collectives"]["all_reduce"] > 0, got["collectives"]
        for name in ("flash_attention", "cross_attention_int8"):
            assert got["launches"][name] > 0, (name, got["launches"])
        assert got["tokens"] == ranks[0]["tokens"], "the TP ranks decoded different tokens"
    equal = sum(t is None for t, _ in r0["divergence"])
    print(f"TP = 2 free-running tokens: {equal} of 8 rows equal to the unsharded decode "
          f"over all {TP_DECODE} steps; the others (step, the unsharded logits' margin "
          f"between its token and TP's): "
          f"{[(t, round(m, 4)) for t, m in r0['divergence'] if t is not None]} (a row may "
          f"leave only at a near-tie, |margin| <= {TIE_NATS}); unsharded decode "
          f"{r0['ref_wall']:.3f} s on rank 0; two processes {wall:.1f} s in all [{card}]")
    assert all(t is None or abs(m) <= TIE_NATS for t, m in r0["divergence"]), r0["divergence"]
    return {name: sum(r["launches"][name] for r in ranks) for name in ranks[0]["launches"]}


def train_check(att, mesh, dev, card: str) -> dict:
    """Phase 12 (b). Returns the launches of the three train steps."""
    from turbo_whisper_workspace_tpu_torch.models import whisper as wm
    from turbo_whisper_workspace_tpu_torch.ops import mel as mel_ops
    from turbo_whisper_workspace_tpu_torch.parallel import train

    gen = torch.Generator(dev).manual_seed(7)
    q, k, v, g = (torch.randn(TRAIN_BATCH, 20, 1500, 64, generator=gen, device=dev)
                  .to(torch.bfloat16) for _ in range(4))
    ours = [t.clone().requires_grad_() for t in (q, k, v)]
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    att.flash_attention(*ours).backward(g)
    att.flash_attention_reference(*plain).backward(g)
    errs = [rel_err(a.grad, b.grad) for a, b in zip(ours, plain)]
    print(f"flash_attention autograd route vs the plain version's autograd, "
          f"{tuple(q.shape)} bf16: rel L2 dq {errs[0]:.3e}, dk {errs[1]:.3e}, dv {errs[2]:.3e} "
          f"(tolerance {GRAD_TOL})")
    assert all(e <= GRAD_TOL for e in errs), errs
    del q, k, v, g, ours, plain
    from turbo_whisper_workspace_tpu_torch.ops import whisper_ops as wo
    ngen = torch.Generator(dev).manual_seed(8)      # leaves gen's train data as it was
    x, delta, g = (torch.randn(TRAIN_BATCH * 1500, 1280, generator=ngen, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
    w, b = (1 + 0.1 * torch.randn(1280, generator=ngen, device=dev)).to(torch.bfloat16), \
        (0.1 * torch.randn(1280, generator=ngen, device=dev)).to(torch.bfloat16)
    ours = [t.clone().requires_grad_() for t in (x, w, b, delta)]
    plain = [t.clone().requires_grad_() for t in (x, w, b, delta)]
    torch.autograd.backward(wo.whisper_norm(*ours[:3], 1e-5, ours[3]), [g, g])
    torch.autograd.backward(wo.whisper_norm_reference(*plain[:3], 1e-5, plain[3]), [g, g])
    errs = [rel_err(a.grad, b.grad) for a, b in zip(ours, plain)]
    print(f"whisper_norm autograd route vs the plain version's autograd, {tuple(x.shape)} bf16 "
          f"with the residual add: rel L2 dx {errs[0]:.3e}, dw {errs[1]:.3e}, db {errs[2]:.3e}, "
          f"ddelta {errs[3]:.3e} (tolerance {GRAD_TOL})")
    assert all(e <= GRAD_TOL for e in errs), errs
    del x, delta, g, ours, plain

    dims = wm.WHISPER_CONFIGS["large-v3-turbo"]
    with torch.no_grad():
        mel = mel_ops.log_mel_spectrogram(pcm_windows(TRAIN_BATCH, seed0=20).to(dev),
                                          num_mels=dims.n_mels)
    tokens = torch.randint(0, 50257, (TRAIN_BATCH, TRAIN_TOKENS), generator=gen, device=dev)
    mask = torch.ones(TRAIN_BATCH, TRAIN_TOKENS - 1, device=dev)

    def train_steps():
        model = wm.init_params(dims, torch.Generator(dev).manual_seed(1), dtype=torch.bfloat16)
        init_fn, step_fn = train.make_train_step(model, mesh, learning_rate=TRAIN_LR)
        local, opt = init_fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, walls = [], []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            local, opt, loss = step_fn(local, opt, mel, tokens, mask)
            losses.append(float(loss))
            walls.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2**30
        counts = {n: c for n, c in launches().items() if c}
        del model, local, opt
        torch.cuda.empty_cache()
        return losses, walls, peak, counts

    reset_counts()
    losses, walls, peak, counts = train_steps()
    print(f"train step, large-v3-turbo bf16, batch {TRAIN_BATCH} x {TRAIN_TOKENS} tokens, "
          f"AdamW lr {TRAIN_LR}: losses {[round(x, 4) for x in losses]}, ms a step "
          f"{[round(w * 1e3, 1) for w in walls]}, peak memory {peak:.2f} GiB; launches "
          f"{counts} [{card}]")
    with plain_kernels(wo):
        plain_losses, plain_walls, plain_peak, _ = train_steps()
    print(f"the same train steps with whisper_norm's plain version (the earlier route): losses "
          f"{[round(x, 4) for x in plain_losses]}, ms a step "
          f"{[round(w * 1e3, 1) for w in plain_walls]}, peak memory {plain_peak:.2f} GiB")
    assert all(math.isfinite(x) for x in losses) and losses[-1] < losses[0], losses
    # the first step's forward differs from its plain twin only in the norms' roundings
    assert abs(losses[0] - plain_losses[0]) <= 1e-2 * abs(plain_losses[0]), (losses, plain_losses)
    assert counts.get("flash_attention") == dims.n_audio_layer * TRAIN_STEPS, counts
    # every norm of the forward launches its kernel (the backward recomputes in torch
    # ops): two a block and ln_post in the encoder, the entry and three a layer in the decoder
    n_norms = 2 * dims.n_audio_layer + 1 + 3 * dims.n_text_layer + 1
    assert counts.get("whisper_norm") == n_norms * TRAIN_STEPS, counts
    return counts


def parallel_phase(att, transcriber, dev, card: str) -> dict:
    """Phase 12. Returns {path: launches} for the DP decodes, the train
    steps and the TP ranks (counts zeroed just before each run)."""
    import torch.distributed as dist

    from turbo_whisper_workspace_tpu_torch.decode import beam as beam_mod
    from turbo_whisper_workspace_tpu_torch.decode import greedy as greedy_mod
    from turbo_whisper_workspace_tpu_torch.ops import mel as mel_ops
    from turbo_whisper_workspace_tpu_torch.parallel import infer
    from turbo_whisper_workspace_tpu_torch.parallel.mesh import make_mesh

    model = transcriber.model
    pcm = pcm_windows(8, seed0=5)
    prompt = torch.tensor([transcriber._prompt_row("en")] * len(pcm))
    path_counts = {"dp decode": {}}
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(model_parallel=1, data_parallel=1, device_type="cuda")
        for beam in (1, BEAM):
            fn = infer.make_dp_decode(model, mesh, rules=transcriber.rules, beam_size=beam,
                                      max_len=DECODE, quantize_kv=True)
            reset_counts()
            t0 = time.perf_counter()
            res, collectives = infer.count_collectives(fn, pcm, prompt)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            for name, c in launches().items():
                path_counts["dp decode"][name] = path_counts["dp decode"].get(name, 0) + c
            full = infer.gather_dp(mesh, res)
            t0 = time.perf_counter()
            with torch.no_grad():
                mels = mel_ops.log_mel_spectrogram(pcm.to(dev), num_mels=model.dims.n_mels)
                ckv = model.decoder.precompute_cross_kv(model.encoder(mels), quantize=True)
                kw = dict(rules=transcriber.rules, max_len=DECODE)
                direct = (beam_mod.beam_decode_features(model, ckv, prompt.to(dev),
                                                        beam_size=beam, **kw)
                          if beam > 1 else
                          greedy_mod.greedy_decode_features(model, ckv, prompt.to(dev), **kw))
            torch.cuda.synchronize()
            direct_wall = time.perf_counter() - t0
            label = "greedy" if beam == 1 else f"beam-{beam}"
            print(f"DP = 1 (NCCL, one rank) {label} decode, 8 windows x {DECODE} steps max: "
                  f"wall {wall:.3f} s (direct call {direct_wall:.3f} s), collectives "
                  f"{collectives}, lengths {full.lengths.tolist()} [{card}]")
            assert sum(collectives.values()) == 0, collectives
            assert torch.equal(full.tokens, direct.tokens), label
            assert torch.equal(full.lengths, direct.lengths), label
        print(f"DP decode tokens equal the direct calls'; launches {path_counts['dp decode']}")
        for name in ("flash_attention", "cross_attention_int8"):
            assert path_counts["dp decode"][name] > 0, (name, path_counts["dp decode"])
        path_counts["train"] = train_check(att, mesh, dev, card)
    finally:
        dist.destroy_process_group()
    path_counts["tp decode"] = tp_check(card)
    return path_counts


# ---------------------------------------------------------------------------
# Phase 13: the decode loops as CUDA graphs

GRAPH_PROFILE = {"whisper": (32, DECODE), "llm": (16, 64)}   # loop lengths of a step's
                                                              # profile (see step_profile)
LLM_GRAPH_STEPS = 200      # the LLM witness: the 1748-token prompt, then 200 steps
SAMPLED_T = 0.6


def batch_windows(transcriber, batch: list) -> np.ndarray:
    """The 30 s windows Transcriber.transcribe cuts from `batch` (phase
    4's batch call: 8 windows)."""
    from turbo_whisper_workspace_tpu_torch.decode import longform

    cfg = transcriber.config
    plans = [p for fi, audio in enumerate(batch) for p in longform.plan_chunks(
        len(audio), fi, chunk_s=cfg.chunk_length_s, stride_s=cfg.stride_length_s)]
    return np.stack([longform.slice_chunk(batch[p.file_index], p) for p in plans])


def step_profile(run, short: int, long: int) -> dict:
    """Per decode step of the loop `run(n)` (n sampled tokens, random
    weights: no row ends early; it returns the loop's timings). Host
    wall: the steps' own loop (`loop_s`, after the capture, ending in a
    sync) of an unprofiled run of `long` steps, over its steps. Device
    busy (kernel self time), kernels run, and cudaLaunchKernel and
    cudaGraphLaunch calls: torch.profiler windows over a run of `long`
    and one of `short` steps, their difference over long − short steps,
    so the prefill, the warm-up and the capture cancel. `by_kernel`:
    each kernel's device µs and calls a step, the same difference."""
    from torch.profiler import ProfilerActivity, profile

    timings = run(long)
    wall = timings["loop_s"] / timings["decode_forwards"] * 1e3
    read, named = {}, {}
    for n in (short, long):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run(n)
        events = prof.key_averages()
        kernels = [e for e in events if device_us(e) > 0 and not e.key.startswith("aten::")]
        read[n] = (sum(device_us(e) for e in kernels) / 1e3, sum(e.count for e in kernels),
                   calls(events, "cudaLaunchKernel"), calls(events, "cudaGraphLaunch"))
        named[n] = {e.key: (device_us(e), e.count) for e in kernels}
    busy, kernels, n_launches, graph_launches = (
        (a - b) / (long - short) for a, b in zip(read[long], read[short]))
    by_kernel = {key: tuple((a - b) / (long - short) for a, b in zip(
        named[long][key], named[short].get(key, (0.0, 0)))) for key in named[long]}
    return {"wall_ms": wall, "busy_ms": busy, "idle": 1 - busy / wall, "kernels": kernels,
            "launches": n_launches, "graph_launches": graph_launches,
            "by_kernel": {k: v for k, v in by_kernel.items() if v[1] > 0.5}}


def print_step_profile(label: str, prof: dict, card: str) -> None:
    print(f"{label} step profile: host wall {prof['wall_ms']:.3f} ms, device busy "
          f"{prof['busy_ms']:.3f} ms ({100 * prof['idle']:.1f}% idle), "
          f"{prof['kernels']:.1f} kernels run, {prof['launches']:.1f} cudaLaunchKernel and "
          f"{prof['graph_launches']:.1f} cudaGraphLaunch calls per step [{card}]")
    for key, (us, n) in sorted(prof["by_kernel"].items(), key=lambda kv: -kv[1][0]):
        print(f"  {us:8.2f} us a step, {n:5.1f} calls: {key[:100]}")


def in_turns(run) -> dict:
    """run(graphed) in turns eager, graphed, graphed, eager → {graphed:
    [its two results]}."""
    out = {False: [], True: []}
    for graphed in (False, True, True, False):
        out[graphed].append(run(graphed))
    return out


def check_grammar(tokens: torch.Tensor, p: int, rules) -> None:
    """Each row's sampled tokens obey the timestamp grammar: EOT-padded
    after the first EOT, a first timestamp within max_initial_timestamp,
    no suppressed token, timestamps non-decreasing."""
    sp = rules.specials
    suppressed = set(rules._static_suppress_ids().tolist())
    tsb = sp.timestamp_begin
    for row in tokens[:, p:].tolist():
        n = row.index(sp.eot) if sp.eot in row else len(row)
        assert all(t == sp.eot for t in row[n:]), row
        body = row[:n]
        if not body:
            continue
        assert tsb <= body[0] <= tsb + 50, body[0]
        assert not suppressed.intersection(body), body
        ts = [t for t in body if t >= tsb]
        assert all(a <= b for a, b in zip(ts, ts[1:])), ts


def graph_phase(att, tq, transcriber, windows: np.ndarray, llm, dev, card: str) -> dict:
    """Phase 13. Returns the launches of the graphed loops run through
    their entry points (counts zeroed before each, summed)."""
    from turbo_whisper_workspace_tpu_torch.decode import greedy as greedy_mod
    from turbo_whisper_workspace_tpu_torch.llm import generate as gen_mod
    from turbo_whisper_workspace_tpu_torch.ops import llama_ops as lo

    torch.cuda.reset_peak_memory_stats()
    counts: dict = {}

    def counted(fn):
        """fn() with the counts zeroed before; the launches join `counts`."""
        reset_counts(*counters(), tq)
        out = fn()
        for name, c in launches(*counters(), tq).items():
            counts[name] = counts.get(name, 0) + c
        return out

    # Whisper greedy at large-v3-turbo width on phase 4's 8 windows
    model, rules = transcriber.model, transcriber.rules
    with torch.no_grad():
        cross_kv = transcriber._encode_windows(windows)
    prompt = torch.tensor([transcriber._prompt_row("en")] * len(windows), device=dev)
    p = prompt.shape[1]
    step_bytes = (sum(t.numel() * t.element_size() for t in model.decoder.parameters())
                  + nbytes(*cross_kv.values()))
    print(f"Whisper greedy step bound: {step_bytes / PEAK_BYTES * 1e3:.4f} ms (bytes: the "
          f"decoder's weights and the int8 cross-KV of {len(windows)} windows, "
          f"{step_bytes / 1e6:.1f} MB) [{card}]")
    for route in ("int8", "s8"):
        def decode(graphed, max_len=DECODE, **kw):
            timings = {}
            t0 = time.perf_counter()
            res = greedy_mod.greedy_decode_features(
                model, cross_kv, prompt, rules=rules, max_len=max_len,
                cross_s8=route == "s8", graphed=graphed, timings=timings, **kw)
            torch.cuda.synchronize()
            return res, time.perf_counter() - t0, timings

        def run(graphed):
            out = counted(lambda: decode(graphed)) if graphed else decode(graphed)
            assert out[2]["decode_forwards"] == DECODE - 1, out[2]   # random weights
            return out

        runs = in_turns(run)
        (eager, _, _), (graph, _, timings) = runs[False][0], runs[True][0]
        for field in ("tokens", "lengths", "sum_logprobs"):
            for res, _, _ in runs[False] + runs[True]:
                assert torch.equal(getattr(res, field), getattr(eager, field)), (route, field)
        assert eager.tokens.shape == (len(windows), p + DECODE)
        walls = {g: [f"{w:.3f}" for _, w, _ in runs[g]] for g in runs}
        print(f"Whisper greedy, {route} cross route, {len(windows)} windows x {DECODE} steps: "
              f"tokens, lengths and sum_logprobs of the graphed loop bit-equal to the eager "
              f"step function's; walls eager {walls[False]} s, graphed {walls[True]} s "
              f"(capture {1e3 * timings['capture_s']:.1f} and "
              f"{1e3 * runs[True][1][2]['capture_s']:.1f} ms) [{card}]")
        for graphed in (False, True):
            prof = step_profile(lambda n, g=graphed: decode(g, max_len=n)[2],
                                *GRAPH_PROFILE["whisper"])
            print_step_profile(f"Whisper greedy ({route}, {'graphed' if graphed else 'eager'})",
                               prof, card)
    sampled = [counted(lambda s=s: decode(True, temperature=SAMPLED_T,
                                          generator=torch.Generator(dev).manual_seed(s)))
               for s in (7, 7, 8)]
    for res, _, _ in sampled:
        check_grammar(res.tokens, p, rules)
    assert torch.equal(sampled[0][0].tokens, sampled[1][0].tokens)
    print(f"Whisper greedy at T = {SAMPLED_T} (graphed, s8 route): obeys the grammar, seeded "
          f"(seed 7 twice equal; seed 8 {'differs' if not torch.equal(sampled[0][0].tokens, sampled[2][0].tokens) else 'equal'}); "
          f"lengths {sampled[0][0].lengths.tolist()} [{card}]")
    del cross_kv

    # the LLM at llama-3.1-8b, int4 body and int8 head
    from turbo_whisper_workspace_tpu_torch.models import llama as lm

    params, dims = llm.params, llm.dims
    lprompt = torch.randint(1, dims.n_vocab, (1, LLM_LONG_PROMPT),
                            generator=torch.Generator(dev).manual_seed(8), device=dev)

    def generate(graphed, max_len=LLM_GRAPH_STEPS, **kw):
        timings = {}
        res = gen_mod.generate_tokens(params, dims, lprompt, max_len=max_len,
                                      graphed=graphed, timings=timings, **kw)
        torch.cuda.synchronize()
        return res, timings

    def run_llm(graphed):
        out = counted(lambda: generate(graphed)) if graphed else generate(graphed)
        assert out[1]["decode_forwards"] == LLM_GRAPH_STEPS - 1, out[1]
        return out

    runs = in_turns(run_llm)
    eager = runs[False][0][0]
    for res, _ in runs[False] + runs[True]:
        assert torch.equal(res.tokens, eager.tokens) and torch.equal(res.lengths, eager.lengths)
    body = sum(nbytes(*(t for t in leaf.values())) for blk in params["blocks"]
               for name, leaf in blk.items() if not name.endswith("_norm"))
    head = nbytes(*params["lm_head"].values())
    kv = (2 * dims.n_layer * dims.n_kv_head * dims.head_dim * 2
          * (LLM_LONG_PROMPT + LLM_GRAPH_STEPS // 2))
    bound = (body + head) / PEAK_BYTES * 1e3
    per_step = {g: [(t["decode_s"] - t["capture_s"]) / t["decode_forwards"] * 1e3
                    for _, t in runs[g]] for g in runs}
    print(f"LLM {LLM} greedy, prompt {LLM_LONG_PROMPT} tokens x {LLM_GRAPH_STEPS} steps: "
          f"graphed tokens bit-equal to the eager step function's; ms per step eager "
          f"{[f'{x:.3f}' for x in per_step[False]]}, graphed "
          f"{[f'{x:.3f}' for x in per_step[True]]} (capture "
          f"{[f'{1e3 * t['capture_s']:.1f}' for _, t in runs[True]]} ms), against a "
          f"{bound:.4f} ms bound (bytes: int4 body {body / 1e6:.0f} MB + int8 head "
          f"{head / 1e6:.0f} MB; the KV cache read adds {kv / PEAK_BYTES * 1e3:.4f} ms at "
          f"the middle step) [{card}]")
    for graphed in (False, True):
        prof = step_profile(lambda n, g=graphed: generate(g, max_len=n)[1],
                            *GRAPH_PROFILE["llm"])
        print_step_profile(f"LLM ({'graphed' if graphed else 'eager'})", prof, card)
    profile_decode(lm, params, dims, dev, card, graphed=True)
    sampled = [counted(lambda s=s: generate(True, max_len=64, temperature=SAMPLED_T,
                                            generator=torch.Generator(dev).manual_seed(s)))
               for s in (9, 9)]
    for res, _ in sampled:
        n = int(res.lengths[0])
        assert 0 <= n <= 64 and (res.tokens[0, LLM_LONG_PROMPT + n:] == 0).all(), n
    assert torch.equal(sampled[0][0].tokens, sampled[1][0].tokens)
    print(f"LLM at T = {SAMPLED_T} (graphed, 64 steps): EOS-padded after its length "
          f"{int(sampled[0][0].lengths[0])}, seed 9 twice equal [{card}]")
    print(f"phase 13 peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"launches of the graphed loops {counts} [{card}]")
    for name in ("cross_attention_int8", "cross_attention_s8", "int4_matmul_s8",
                 "int8_matmul", *lo.launch_counts):
        assert counts.get(name, 0) > 0, (name, counts)
    return counts


# ---------------------------------------------------------------------------
# Phase 14: the beam loop as a CUDA graph

BEAM_PROFILE = (16, 64)    # loop lengths of the beam step's profile (see step_profile)
# (quantize_cache, lane_cache, cross_s8) → the self-attention kernel it runs
BEAM_GRAPH_MODES = {"int8 lanes": ((True, True, False), "self_attention_int8_lanes"),
                    "int8 regathered": ((True, False, False), "self_attention_int8"),
                    "bf16 regathered": ((False, False, False), None),
                    "int8 lanes, s8 cross route": ((True, True, True),
                                                   "self_attention_int8_lanes")}


def beam_graph_phase(att, transcriber, windows: np.ndarray, dev, card: str) -> dict:
    """Phase 14. Returns the launches of the graphed beam loops (counts
    zeroed before each, summed)."""
    from turbo_whisper_workspace_tpu_torch.decode import beam as beam_mod

    torch.cuda.reset_peak_memory_stats()
    counts: dict = {}
    model, rules = transcriber.model, transcriber.rules
    with torch.no_grad():
        cross_kv = transcriber._encode_windows(windows)
    prompt = torch.tensor([transcriber._prompt_row("en")] * len(windows), device=dev)
    for mode, ((quantize_cache, lane_cache, s8), kernel) in BEAM_GRAPH_MODES.items():
        def decode(graphed, max_len=DECODE):
            timings = {}
            t0 = time.perf_counter()
            res = beam_mod.beam_decode_features(
                model, cross_kv, prompt, rules=rules, beam_size=BEAM, max_len=max_len,
                quantize_cache=quantize_cache, lane_cache=lane_cache, cross_s8=s8,
                graphed=graphed, timings=timings)
            torch.cuda.synchronize()
            # random weights: no item holds K finished hypotheses early
            assert timings["decode_forwards"] == max_len, timings
            return res, time.perf_counter() - t0, timings

        def run(graphed):
            if not graphed:
                return decode(False)
            reset_counts()
            out = decode(True)
            for name, c in launches().items():
                counts[name] = counts.get(name, 0) + c
            assert att.launch_counts["cross_attention_s8" if s8 else "cross_attention_int8"]
            assert kernel is None or att.launch_counts[kernel] > 0, (mode, att.launch_counts)
            return out

        runs = in_turns(run)
        eager = runs[False][0][0]
        for res, _, _ in runs[False] + runs[True]:
            for field in beam_mod.BeamResult._fields:
                assert torch.equal(getattr(res, field), getattr(eager, field)), (mode, field)
        walls = {g: [f"{w:.3f}" for _, w, _ in runs[g]] for g in runs}
        per_step = {g: [f"{t['loop_s'] / (t['decode_forwards'] - 1) * 1e3:.3f}"
                        for _, _, t in runs[g]] for g in runs}
        print(f"beam-{BEAM} ({mode}), {len(windows)} windows x {DECODE} steps: "
              f"every field of the graphed loop's result bit-equal to the eager step "
              f"function's; walls eager {walls[False]} s, graphed {walls[True]} s; ms per "
              f"step eager {per_step[False]}, graphed {per_step[True]} (capture "
              f"{[f'{1e3 * t['capture_s']:.1f}' for _, _, t in runs[True]]} ms) [{card}]")
        if mode == "int8 lanes":
            for graphed in (False, True):
                def steps(n, g=graphed):
                    t = decode(g, max_len=n)[2]
                    return {**t, "decode_forwards": t["decode_forwards"] - 1}   # the loop's

                print_step_profile(f"beam-{BEAM} ({mode}, {'graphed' if graphed else 'eager'})",
                                   step_profile(steps, *BEAM_PROFILE), card)
    print(f"phase 14 peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"launches of the graphed beam loops {counts} [{card}]")
    return counts


# ---------------------------------------------------------------------------
# Phase 15: the Llama layer's kernels

LLAMA_KERNELS = ("llama_attention", "llama_norm_quant", "llama_rope_cache",
                 "llama_swiglu_quant")
LLM_CACHE = LLM_LONG_PROMPT + 256    # the summary call's cache: its prompt and max_tokens
LLM_DECODE_POS = (1500, LLM_CACHE - 1)   # cached positions of the decode checks
GRAPH_CHECK_STEPS = 3      # steps of the StepGraph replay held to the eager step


def attention_variant(lo, q, ck, cv, pos, mask: bool = True, kv_of=None):
    """The plain attention with one reading changed, the error the
    relative check must catch: no position mask (every cache row seen),
    or query head i reading kv head kv_of(i) (the cache expanded to one
    kv head a query head)."""
    b, t, h, dh = q.shape
    s_len, kvh = ck.shape[1], ck.shape[-1] // dh
    if kv_of is not None:
        idx = torch.tensor([kv_of(i) for i in range(h)], device=q.device)
        ck, cv = (c.reshape(b, s_len, kvh, dh)[:, :, idx].reshape(b, s_len, h * dh)
                  for c in (ck, cv))
        return lo.llama_attention_reference(q, ck, cv, pos)
    assert not mask
    kk, vv = (c.reshape(b, s_len, kvh, dh) for c in (ck, cv))
    logits = torch.einsum("btkgd,bskd->bkgts", q.reshape(b, t, kvh, h // kvh, dh).float(),
                          kk.float()) * dh ** -0.5
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bkgts,bskd->btkgd", w, vv).reshape(b, t, h * dh)


def rope_interleaved(lo, q, k, v, ck, cv, cos, sin, pos):
    """The plain RoPE reading each rotated pair from neighbouring dims
    (2i, 2i + 1), the GPT-J layout, where Llama's half-split reads (i,
    i + dh/2): the rotated q."""
    dh = q.shape[-1]
    perm = torch.cat([torch.arange(0, dh, 2), torch.arange(1, dh, 2)]).to(q.device)
    inv = torch.argsort(perm)
    return lo.llama_rope_cache_reference(q[..., perm], k[..., perm], v, ck.clone(), cv.clone(),
                                         cos, sin, pos)[..., inv]


def sdpa_gqa(q, ck, cv, mask):
    """torch's scaled_dot_product_attention on the same inputs: (B, H, t,
    Dh) queries over the cache's (B, kvh, S, Dh) views with enable_gqa and
    the boolean position mask (t, S)."""
    b, t, h, dh = q.shape
    s_len, kvh = ck.shape[1], ck.shape[-1] // dh
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), ck.view(b, s_len, kvh, dh).transpose(1, 2),
        cv.view(b, s_len, kvh, dh).transpose(1, 2), attn_mask=mask, enable_gqa=True)


def check_payload(label: str, got: tuple, ref: tuple, h: torch.Tensor, h_ref: torch.Tensor,
                  n_groups: int) -> int:
    """The quantizer's (xq, xs) against the plain version's: xq equal, or
    off by 1 only in a group whose bf16 input differs (the input's own
    rounding, e.g. a last-bit rsqrt); returns the elements that differ."""
    (xq, xs), (rq, rs) = got, ref
    diff = (xq.int() - rq.int()).abs()
    m, k = diff.shape
    moved = diff.reshape(m, n_groups, -1).amax(-1) > 0
    h_apart = (h.reshape(m, n_groups, -1) != h_ref.reshape(m, n_groups, -1)).any(-1)
    n = int((diff > 0).sum())
    print(f"  {label}: xq {n} of {diff.numel()} elements off by 1, in {int(moved.sum())} "
          f"groups, every one with a bf16 input that differs; xs equal in "
          f"{int((xs == rs).sum())} of {xs.numel()}")
    assert int(diff.max()) <= 1 and not (moved & ~h_apart).any()
    assert torch.equal(xs[~h_apart], rs[~h_apart])
    return n


def llama_kernels_phase(att, tq, llm, dev, card: str) -> dict:
    """Phase 15. Returns the four kernels' stats, the rows of the
    kernels line (decode at the first of LLM_DECODE_POS)."""
    from turbo_whisper_workspace_tpu_torch.models import llama as lm
    from turbo_whisper_workspace_tpu_torch.ops import llama_ops as lo
    from turbo_whisper_workspace_tpu_torch.utils.step_loop import StepGraph

    gen = torch.Generator(dev).manual_seed(15)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    params, dims = llm.params, llm.dims
    h, kvh, dh, d = dims.n_head, dims.n_kv_head, dims.head_dim, dims.d_model
    group, eps = h // kvh, dims.norm_eps
    n_groups, ff_groups = d // tq.GROUP4, dims.d_ff // tq.GROUP4
    stats = {}

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def row(name, label, fn, plain, args, n_bytes, n_ops, library=None):
        """single launch, back-to-back, plain and library times, and the bound"""
        r = timed(f"{name} {label}", lambda: fn(*args), lambda: plain(*args), n_bytes, n_ops,
                  flush)
        # input_copies, with the non-tensor arguments passed along
        n = min(BACK_TO_BACK, max(2, math.ceil(
            L2_BYTES / nbytes(*(a for a in args if torch.is_tensor(a)))) + 1))
        copies = [args] + [tuple(a.clone() if torch.is_tensor(a) else a for a in args)
                           for _ in range(n - 1)]
        r["b2b_ms"] = back_to_back_ms(fn, copies, flush)
        lib = None if library is None else time_ms(library, flush)
        r["library_ms"] = lib
        print(f"{name} {label}: single launch {r['ms']:.4f} ms, back-to-back "
              f"{r['b2b_ms']:.4f} ms per launch ({BACK_TO_BACK} in a row over {len(copies)} "
              f"copies), plain {r['plain_ms']:.4f} ms, library "
              f"{'none' if lib is None else '%.4f ms' % lib}, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}) [{card}]")
        del copies
        return r

    # llama_attention: a decode step at two cached positions (the cache's
    # rows past pos random: the mask must drop them), the prefill
    rows, errs = {}, {}
    ck, cv = randn(1, LLM_CACHE, kvh * dh), randn(1, LLM_CACHE, kvh * dh)
    for pos in LLM_DECODE_POS:
        q = randn(1, 1, h, dh)
        at = torch.tensor(pos, device=dev)
        out = lo.llama_attention(q, ck, cv, at)
        torch.cuda.synchronize()
        dropped = {"i // group mapping (i % group)":
                   attention_variant(lo, q, ck, cv, pos, kv_of=lambda i: i % group)}
        if pos + 1 < LLM_CACHE:
            dropped["position mask"] = attention_variant(lo, q, ck, cv, pos, mask=False)
        label = (f"decode t=1 pos={pos} S={LLM_CACHE} (plan "
                 f"{checked_plan(lo, 1, group, LLM_CACHE, kvh)})")
        errs[pos] = compare(f"llama_attention {label}", out,
                            lo.llama_attention_reference(q, ck, cv, pos), dropped,
                            relative_max=True)
        mask = torch.arange(LLM_CACHE, device=dev)[None, :] <= pos
        n = pos + 1                      # the keys a decode step reads
        rows[pos] = row("llama_attention", label, lo.llama_attention,
                        lo.llama_attention_reference, (q, ck, cv, at),
                        nbytes(q, out) + 2 * n * kvh * dh * 2, 4 * h * n * dh,
                        lambda: sdpa_gqa(q, ck, cv, mask))
    t = LLM_LONG_PROMPT
    q, pk, pv = randn(1, t, h, dh), randn(1, t, kvh * dh), randn(1, t, kvh * dh)
    out = lo.llama_attention(q, pk, pv, 0)
    torch.cuda.synchronize()
    label = f"prefill t={t} (plan {checked_plan(lo, t, group, t, kvh)})"
    errs["prefill"] = compare(
        f"llama_attention {label}, online softmax", out,
        lo.llama_attention_reference(q, pk, pv, 0),
        {"position mask": attention_variant(lo, q, pk, pv, 0, mask=False),
         "i // group mapping (i % group)":
             attention_variant(lo, q, pk, pv, 0, kv_of=lambda i: i % group)},
        relative_max=True)
    mask = torch.ones(t, t, dtype=torch.bool, device=dev).tril()
    rows["prefill"] = row("llama_attention", label, lo.llama_attention,
                          lo.llama_attention_reference, (q, pk, pv, 0),
                          nbytes(q, pk, pv, out), 4 * h * dh * t * (t + 1) // 2,
                          lambda: sdpa_gqa(q, pk, pv, mask))
    stats["llama_attention"] = kernel_row(rows[LLM_DECODE_POS[0]], errs)
    del q, pk, pv, out, ck, cv

    # llama_norm_quant: a decode step's three modes with the quantizer,
    # the final norm, the prefill's norm
    rows, errs, moved = {}, {}, 0
    scale = (1 + 0.1 * randn(d, dtype=torch.float32)).to(torch.bfloat16)
    for m, mode, groups in ((1, 2, n_groups), (1, 1, n_groups), (1, 0, n_groups), (1, 2, 0),
                            (t, 2, 0)):
        x, delta = randn(m, d), randn(m, d)
        args = (x, scale if mode else None, eps, delta if mode == 2 else None, groups,
                mode != 0)
        got, ref = lo.llama_norm_quant(*args), lo.llama_norm_quant_reference(*args)
        torch.cuda.synchronize()
        label = f"m={m} d={d} mode {mode}" + (f", {groups} groups" if groups else "")
        dropped = ({"residual add": lo.llama_norm_quant_reference(x, scale, eps)[1]}
                   if mode == 2 else {})
        errs[label] = compare(f"llama_norm_quant {label}", got[1], ref[1], dropped,
                              relative_max=True)
        if mode == 2:
            assert torch.equal(got[0], ref[0])
        if groups:
            moved += check_payload(label, got[2], ref[2], got[1], ref[1], groups)
        outs = [got[1]] if mode else []
        outs += [got[0]] if mode == 2 else []
        outs += list(got[2]) if groups else []
        n_bytes = nbytes(x, *([scale] if mode else []), *([delta] if mode == 2 else []), *outs)
        lib = None          # F.rms_norm: the norm alone (no residual add, no quantizer)
        if mode:
            lib = lambda x=x: torch.nn.functional.rms_norm(x, (d,), scale, eps)   # noqa: E731
        rows[label] = row("llama_norm_quant", label, lo.llama_norm_quant,
                          lo.llama_norm_quant_reference, args, n_bytes, 0, lib)
    print(f"llama_norm_quant: xq elements off by 1 over the checks: {moved} [{card}]")
    stats["llama_norm_quant"] = kernel_row(rows[f"m=1 d={d} mode 2, {n_groups} groups"], errs)

    # llama_rope_cache: a decode row at both positions, the prefill
    rows, errs = {}, {}
    cos, sin = lm.rope_table(dh // 2, dims.rope_theta, dims.max_ctx, dev)
    for t_, pos in [(1, p) for p in LLM_DECODE_POS] + [(t, 0)]:
        q, k, v = randn(1, t_, h, dh), randn(1, t_, kvh, dh), randn(1, t_, kvh, dh)
        ck, cv = randn(1, LLM_CACHE, kvh * dh), randn(1, LLM_CACHE, kvh * dh)
        rck, rcv = ck.clone(), cv.clone()
        at = torch.tensor(pos, device=dev)
        got = lo.llama_rope_cache(q, k, v, ck, cv, cos, sin, at)
        ref = lo.llama_rope_cache_reference(q, k, v, rck, rcv, cos, sin, pos)
        torch.cuda.synchronize()
        label = f"t={t_} pos={pos}"
        errs[label] = compare(f"llama_rope_cache {label}: q", got, ref,
                              {"half-split layout (interleaved pairs)": rope_interleaved(
                                  lo, q, k, v, ck, cv, cos, sin, pos)}, relative_max=True)
        compare(f"llama_rope_cache {label}: the cache's k rows", ck, rck, {})
        assert torch.equal(cv, rcv) and torch.equal(ck[:, :pos], rck[:, :pos])
        n_bytes = 2 * nbytes(q, k, v) + 2 * t_ * (dh // 2) * 4
        rows[label] = row("llama_rope_cache", label, lo.llama_rope_cache,
                          lo.llama_rope_cache_reference, (q, k, v, ck, cv, cos, sin, at),
                          n_bytes, 0)
    stats["llama_rope_cache"] = kernel_row(rows[f"t=1 pos={LLM_DECODE_POS[0]}"], errs)

    # llama_swiglu_quant: a decode step with the quantizer, the prefill
    rows, errs, moved = {}, {}, 0
    for m, groups in ((1, ff_groups), (t, 0)):
        gate, up = randn(m, dims.d_ff), randn(m, dims.d_ff)
        got = lo.llama_swiglu_quant(gate, up, groups)
        ref = lo.llama_swiglu_quant_reference(gate, up, groups)
        torch.cuda.synchronize()
        label = f"m={m} f={dims.d_ff}" + (f", {groups} groups" if groups else "")
        errs[label] = compare(f"llama_swiglu_quant {label}", got[0], ref[0],
                              {"gate and up swapped": lo.llama_swiglu_quant_reference(
                                  up, gate)[0]}, relative_max=True)
        if groups:
            moved += check_payload(label, got[1], ref[1], got[0], ref[0], groups)
        n_bytes = nbytes(gate, up, got[0], *(got[1] if groups else ()))
        rows[label] = row("llama_swiglu_quant", label, lo.llama_swiglu_quant,
                          lo.llama_swiglu_quant_reference, (gate, up, groups), n_bytes, 0)
    print(f"llama_swiglu_quant: xq elements off by 1 over the checks: {moved} [{card}]")
    stats["llama_swiglu_quant"] = kernel_row(rows[f"m=1 f={dims.d_ff}, {ff_groups} groups"],
                                             errs)
    del gate, up, got, ref

    # one StepGraph replay against the eager step function, bit-equal:
    # logits and cache after GRAPH_CHECK_STEPS steps from the same state
    prompt = torch.randint(1, dims.n_vocab, (1, LLM_LONG_PROMPT),
                           generator=torch.Generator(dev).manual_seed(16), device=dev)
    cache = lm.init_kv_cache(dims, 1, LLM_CACHE, device=dev)
    with torch.no_grad():
        lm.forward(params, dims, prompt, cache, pos=0)
        state = {"pos": torch.tensor(LLM_LONG_PROMPT, device=dev),
                 "tok": prompt[:, -1:].clone(),
                 "logits": torch.zeros(1, dims.n_vocab, device=dev)}

        def step():
            logits, _ = lm.forward(params, dims, state["tok"], cache, pos=state["pos"])
            state["logits"].copy_(logits[:, 0])
            state["tok"].copy_(logits[:, 0].argmax(-1, keepdim=True))
            state["pos"].add_(1)

        start = {n: x.clone() for n, x in {**state, **cache}.items()}
        results = {}
        for graphed in (False, True):
            for n, x in {**state, **cache}.items():
                x.copy_(start[n])
            lo.reset_launch_counts()
            run = StepGraph(step, state).replay if graphed else step
            for _ in range(GRAPH_CHECK_STEPS):
                run()
            torch.cuda.synchronize()
            results[graphed] = ({n: x.clone() for n, x in {**state, **cache}.items()},
                                dict(lo.launch_counts))
    same = all(torch.equal(results[True][0][n], results[False][0][n]) for n in start)
    print(f"{LLM} step at a device position, {GRAPH_CHECK_STEPS} StepGraph replays against "
          f"the eager step function from the same state: logits, tokens, position and "
          f"cache bit-equal {same}; launches eager {results[False][1]}, graphed (warm-up "
          f"step + replays) {results[True][1]} [{card}]")
    assert same
    per_step = {name: dims.n_layer for name in LLAMA_KERNELS}
    per_step["llama_norm_quant"] = 3 * dims.n_layer + 1      # 2 norms + out's quantizer
    assert results[False][1] == {n: c * GRAPH_CHECK_STEPS for n, c in per_step.items()}
    del cache, start, results, state
    return stats


# ---------------------------------------------------------------------------
# Phase 16: the Whisper decoder step's kernels

WHISPER_KERNELS = ("llama_attention", "whisper_norm", "whisper_kv_rows", "whisper_logit_rules")
WHISPER_ROWS = {"greedy": 8, f"beam-{BEAM}": 8 * BEAM, "encoder": 8 * 1500}
STEP_CHECK_LEN = 16        # sampled tokens of the graphed-against-eager step check
C5_DIMS = dict(n_vocab=128256, d_model=2048, n_layer=4, n_head=32, n_kv_head=8, d_ff=8192)
C5_PROMPT = 256


def timed_row(name: str, label: str, fn, plain, args: tuple, n_bytes: float, n_ops: float,
              flush, card: str, library=None) -> dict:
    """A kernel's single-launch, back-to-back, plain and library times
    beside its bound (phase 15's measure, on any argument tuple: its
    tensors cloned into copies over L2_BYTES)."""
    r = timed(f"{name} {label}", lambda: fn(*args), lambda: plain(*args), n_bytes, n_ops, flush)
    tensors = [a for a in args if torch.is_tensor(a)]
    n = min(BACK_TO_BACK, max(2, math.ceil(L2_BYTES / max(nbytes(*tensors), 1)) + 1))
    copies = [args] + [tuple(a.clone() if torch.is_tensor(a) else a for a in args)
                       for _ in range(n - 1)]
    r["b2b_ms"] = back_to_back_ms(fn, copies, flush)
    r["library_ms"] = None if library is None else time_ms(library, flush)
    lib = "none" if library is None else f"{r['library_ms']:.4f} ms"
    print(f"{name} {label}: single launch {r['ms']:.4f} ms, back-to-back {r['b2b_ms']:.4f} ms "
          f"per launch ({BACK_TO_BACK} in a row over {len(copies)} copies), plain "
          f"{r['plain_ms']:.4f} ms, library {lib}, bound {r['bound_ms']:.4f} ms "
          f"({r['bound_by']}) [{card}]")
    del copies
    return r


NEAR_ZERO = 2.0 ** -20     # an absolute floor: near 0 an O(1) term's f32 rounding
                           # is many bf16 ulps of the value (and decides its sign)


def within_one_ulp(got: torch.Tensor, ref: torch.Tensor) -> tuple[int, bool]:
    """(elements that differ, whether each differs by at most one bf16
    ulp at the larger of the two magnitudes, or by at most NEAR_ZERO)."""
    g, r = got.float(), ref.float()
    big = torch.maximum(g.abs(), r.abs())
    _, exp = torch.frexp(big)
    diff = (g - r).abs()
    ok = (diff <= torch.ldexp(torch.ones_like(big), exp - 8)) | (diff <= NEAR_ZERO)
    return int((got != ref).sum()), bool(ok.all())


def check_whisper_norm(wo, dev, gen, flush, card: str) -> dict:
    """whisper_norm at large-v3-turbo's d = 1280 over a greedy step's 8
    rows, a beam step's 40 and a bucket's 12000 encoder rows, with and
    without the residual add, and its entry mode at a device pos: x'
    bit-equal, h within one bf16 ulp of F.layer_norm's (counted), the
    norm without the residual add above the limit."""
    d = 1280
    w = (1 + 0.1 * torch.randn(d, generator=gen, device=dev)).to(torch.bfloat16)
    b = (0.1 * torch.randn(d, generator=gen, device=dev)).to(torch.bfloat16)
    rows, errs, moved, total = {}, {}, 0, 0
    for label, m in WHISPER_ROWS.items():
        x = torch.randn(m, d, generator=gen, device=dev).to(torch.bfloat16)
        delta = torch.randn(m, d, generator=gen, device=dev).to(torch.bfloat16)
        for dl in (delta, None):
            args = (x, w, b, 1e-5, dl)
            (xo, h), (rx, rh) = wo.whisper_norm(*args), wo.whisper_norm_reference(*args)
            torch.cuda.synchronize()
            key = f"{label} m={m} d={d}" + (", residual add" if dl is not None else "")
            dropped = ({"residual add": wo.whisper_norm_reference(x, w, b, 1e-5)[1]}
                       if dl is not None else {})
            errs[key] = compare(f"whisper_norm {key}", h, rh, dropped, relative_max=True)
            n_moved, ok = within_one_ulp(h, rh)
            moved, total = moved + n_moved, total + h.numel()
            assert torch.equal(xo, rx) and ok, key
            n_bytes = nbytes(x, w, b, h, *((dl, xo) if dl is not None else ()))
            rows[key] = timed_row("whisper_norm", key, wo.whisper_norm,
                                  wo.whisper_norm_reference, args, n_bytes, 0, flush, card,
                                  lambda x=x: torch.nn.functional.layer_norm(x, (d,), w, b))
    # the entry: a greedy step's tokens at device position 200
    tokens = torch.randint(0, 51866, (8, 1), generator=gen, device=dev)
    temb = (0.02 * torch.randn(51866, d, generator=gen, device=dev)).to(torch.bfloat16)
    pemb = (0.02 * torch.randn(448, d, generator=gen, device=dev)).to(torch.bfloat16)
    at = torch.tensor(200, device=dev)
    args = (tokens, temb, pemb, at, w, b, 1e-5)
    (x, h), (rx, rh) = wo.whisper_embed_norm(*args), wo.whisper_embed_norm_reference(*args)
    torch.cuda.synchronize()
    errs["entry"] = compare("whisper_norm entry mode (embeddings at device pos 200, 8 rows)",
                            h, rh, {"position 0 in place of 200": wo.whisper_embed_norm_reference(
                                tokens, temb, pemb, 0, w, b, 1e-5)[1]}, relative_max=True)
    assert torch.equal(x, rx) and within_one_ulp(h, rh)[1]
    print(f"whisper_norm: h elements one bf16 ulp from F.layer_norm's: {moved} of {total} "
          f"({100 * moved / total:.3f}%), none further (or within {NEAR_ZERO:.1e}); x' "
          f"bit-equal [{card}]")
    return kernel_row(rows[f"greedy m=8 d={d}, residual add"], errs)


def kv_rows_lane0(wo, k, v, cache: dict, layer: int, pos, h: int, beam: int) -> None:
    """The plain row writer with every beam row writing lane 0 in place of
    lane k (the last beam's rows win there): the error the lane check must
    catch."""
    lane0 = {"k_p": cache["k_p"][:, :, :, :1], "v_p": cache["v_p"][:, :, :1],
             "k_ps": cache["k_ps"][:, :, :, :1], "v_ps": cache["v_ps"][:, :, :, :1]}
    wo.whisper_kv_rows_reference(k[beam - 1::beam], v[beam - 1::beam], lane0, layer, pos, h, 1)


def check_whisper_kv_rows(wo, wm, dev, gen, flush, card: str) -> dict:
    """whisper_kv_rows at large-v3-turbo's 20 heads of 64 and T = 227 into
    layer 1 of each cache: bf16 (a greedy step's 8 rows, the prompt's 3),
    int8 regathered (B·K = 40), lanes (8 items × 5 beams), at a host and
    at a device pos: every payload and scale bit-equal to the plain
    version's; in the lanes, lane 0 in place of lane k above the limit."""
    h, dh, t_len = 20, 64, PROMPT + DECODE
    dims = wm.WHISPER_CONFIGS["large-v3-turbo"]
    rows, errs = {}, {}
    for mode, n, t, beam in (("bf16", 8, 1, 1), ("bf16", 8, PROMPT, 1),
                             ("int8", 8 * BEAM, 1, 1), ("lanes", 8 * BEAM, 1, BEAM)):
        cache = wm.init_kv_cache(dims, n // beam, t_len, device=dev, quantize=mode != "bf16")
        if mode == "lanes":
            cache = wm.beam_lane_cache(cache, beam)
        for pos in (MID_DECODE, torch.tensor(t_len - t, device=dev)):   # the last rows
            k = torch.randn(n, t, h * dh, generator=gen, device=dev).to(torch.bfloat16)
            v = torch.randn(n, t, h * dh, generator=gen, device=dev).to(torch.bfloat16)
            ref = {key: x.clone() for key, x in cache.items()}
            wo.whisper_kv_rows(k, v, cache, 1, pos, h, beam)
            wo.whisper_kv_rows_reference(k, v, ref, 1, pos, h, beam)
            torch.cuda.synchronize()
            p = int(pos)
            label = f"{mode} rows={n} t={t} pos={p}{' (device)' if torch.is_tensor(pos) else ''}"
            same = all(torch.equal(cache[key], ref[key]) for key in cache)
            dropped = ""
            if mode == "lanes":
                wrong = {key: x.clone() for key, x in cache.items()}
                kv_rows_lane0(wo, k, v, wrong, 1, pos, h, beam)
                miss = rel_err(wrong["v_p"][1, :, :, p], ref["v_p"][1, :, :, p])
                dropped = f"; lane 0 in place of lane k: {miss:.3e} (limit {KERNEL_REL_TOL})"
                assert miss > KERNEL_REL_TOL, miss
            print(f"whisper_kv_rows {label}: every payload and scale bit-equal {same}{dropped}")
            assert same, label
            errs[label] = (0.0, 0.0)
            # the rows written: bf16 as they are, or int8 with a bf16 scale a head
            out_bytes = (2 * nbytes(k) if mode == "bf16"
                         else 2 * (k.numel() + n * t * h * 2))
            rows[label] = timed_row("whisper_kv_rows", label, wo.whisper_kv_rows,
                                    wo.whisper_kv_rows_reference, (k, v, cache, 1, pos, h, beam),
                                    nbytes(k, v) + out_bytes, 0, flush, card)
        del cache
    return kernel_row(rows[f"bf16 rows=8 t=1 pos={MID_DECODE}"], errs)


def rules_inputs(sp, rows: int, gen, dev) -> tuple:
    """(logits, last, penult, floor) of `rows` decode rows: logits of
    scale 3 with the timestamp mass raised on every third row (the
    forcing test then goes both ways); the previous two tokens (text,
    text), (timestamp, text: text banned), (timestamp, timestamp:
    timestamps banned) and (text, timestamp) in turn; floors among the
    first 100 timestamps."""
    tsb = sp.timestamp_begin
    logits = torch.randn(rows, sp.n_vocab, generator=gen, device=dev) * 3
    logits[::3, tsb:] += 4.0
    i = torch.arange(rows, device=dev)
    last = torch.where((i % 4 == 1) | (i % 4 == 2), tsb + 5 + i % 50, 220 + i)
    penult = torch.where(i % 4 >= 2, tsb + 3 + i % 40, 300 + i)
    floor = torch.randint(tsb, tsb + 100, (rows,), generator=gen, device=dev)
    return logits, last, penult, floor


def check_whisper_logit_rules(wo, rules, dev, gen, flush, card: str) -> dict:
    """whisper_logit_rules at large-v3-turbo's vocabulary over a greedy
    step's 8 rows (argmax, the token's log-probability; at the first step
    with the begin mask; sampled at T = 0.6 on the same Gumbel draws) and
    a beam step's 40 (cand = alive + log_softmax): tokens equal, the
    probabilities exp(cand − add) and the log-probabilities within the
    limits, the rows whose timestamp forcing flipped counted (none
    allowed); the rules without the pairing bans, and with the begin mask
    at a later step, above the limit."""
    sp = rules.specials
    tsb = sp.timestamp_begin
    sm, bm = rules.static_mask(dev), rules.begin_mask(dev)
    rows, errs, flips = {}, {}, 0
    for label, n, is_begin, sampled in (("greedy", 8, False, False),
                                        ("greedy, first step", 8, True, False),
                                        (f"greedy, T = {SAMPLED_T}", 8, False, True),
                                        (f"beam-{BEAM}", 8 * BEAM, False, False)):
        logits, last, penult, floor = rules_inputs(sp, n, gen, dev)
        noise = (-torch.log(torch.empty_like(logits).exponential_(generator=gen))
                 if sampled else None)
        add = torch.randn(n, generator=gen, device=dev) * 5
        args = (logits, rules, is_begin, last, penult, floor, sm, bm, noise, SAMPLED_T, add)
        got, ref = wo.whisper_logit_rules(*args), wo.whisper_logit_rules_reference(*args)
        torch.cuda.synchronize()
        forced = [(c[:, :tsb] <= -1e29).all(-1) for c in (got[2], ref[2])]   # −1e30 filled
        flips += int((forced[0] != forced[1]).sum())

        def probs(out):
            return torch.exp(out[2] - add[:, None])

        dropped = {}
        if not is_begin:
            dropped["begin mask at a later step"] = probs(wo.whisper_logit_rules_reference(
                logits, rules, True, last, penult, floor, sm, bm, noise, SAMPLED_T, add))
            text = torch.full_like(last, 220)
            dropped["pairing bans"] = probs(wo.whisper_logit_rules_reference(
                logits, rules, False, text, text, floor, sm, bm, noise, SAMPLED_T, add))
        key = f"{label}, {n} rows"
        errs[key] = compare(f"whisper_logit_rules {key}: probabilities exp(cand - add)",
                            probs(got), probs(ref), dropped)
        compare(f"whisper_logit_rules {key}: the token's log-probability", got[1], ref[1], {},
                relative_max=True)
        assert torch.equal(got[0], ref[0]), (key, got[0], ref[0])
        n_bytes = nbytes(logits, sm, last, penult, floor, add, got[0], got[1], got[2],
                         *((noise,) if sampled else ()), *((bm,) if is_begin else ()))
        beam_args = args if label.startswith("beam") else args[:-1]
        rows[key] = timed_row("whisper_logit_rules", key, wo.whisper_logit_rules,
                              wo.whisper_logit_rules_reference, beam_args,
                              n_bytes - (0 if label.startswith("beam") else nbytes(got[2], add)),
                              0, flush, card)
    print(f"whisper_logit_rules: rows whose timestamp forcing flipped against the plain "
          f"version: {flips} [{card}]")
    assert flips == 0
    return kernel_row(rows["greedy, 8 rows"], errs)


def check_whisper_attention(lo, dev, gen, flush, card: str) -> dict:
    """llama_attention at the Whisper decoder's shapes (group 1, 20 heads
    of 64, T = 227, rows past pos random): a greedy step (8 rows) at pos
    115 and 226 and a beam step (40 rows) at 115, device pos, the prompt's
    prefill (t = 3, host pos 0), and a 40-token prompt (the prefill
    regime); without the position mask above the limit; timed beside
    scaled_dot_product_attention on the same inputs."""
    h, dh, t_len = 20, 64, PROMPT + DECODE
    rows, errs = {}, {}
    for n, t, pos in ((8, 1, MID_DECODE), (8, 1, t_len - 1), (8 * BEAM, 1, MID_DECODE),
                      (8, PROMPT, 0), (8, 40, 0)):
        q = torch.randn(n, t, h, dh, generator=gen, device=dev).to(torch.bfloat16)
        ck, cv = (torch.randn(n, t_len, h * dh, generator=gen, device=dev).to(torch.bfloat16)
                  for _ in range(2))
        at = torch.tensor(pos, device=dev) if t == 1 else pos
        out = lo.llama_attention(q, ck, cv, at)
        torch.cuda.synchronize()
        label = (f"Whisper B={n} t={t} pos={pos} S={t_len} H={h} Dh={dh} (plan "
                 f"{checked_plan(lo, t, 1, t_len, n * h)})")
        dropped = ({"position mask": attention_variant(lo, q, ck, cv, pos, mask=False)}
                   if pos + t < t_len else {})
        errs[label] = compare(f"llama_attention {label}", out,
                              lo.llama_attention_reference(q, ck, cv, pos), dropped,
                              relative_max=True)
        mask = (torch.arange(t_len, device=dev)[None, :]
                <= pos + torch.arange(t, device=dev)[:, None])
        keys = pos + t                  # the keys the kernel reads (the last row's)
        rows[label] = timed_row("llama_attention", label, lo.llama_attention,
                                lo.llama_attention_reference, (q, ck, cv, at),
                                nbytes(q, out) + 2 * n * keys * h * dh * 2,
                                4 * n * h * t * keys * dh, flush, card,
                                lambda: sdpa_gqa(q, ck, cv, mask))
    return rows


def check_whisper_steps(transcriber, windows: np.ndarray, dev, card: str) -> None:
    """The greedy step (bf16 self cache) and the beam-5 lanes step, each
    replayed STEP_CHECK_LEN times from a StepGraph (graphed=True) against
    the eager step function (graphed=False) from the same inputs: every
    field of the result bit-equal, and the step's kernels launched."""
    from turbo_whisper_workspace_tpu_torch.decode import beam as beam_mod
    from turbo_whisper_workspace_tpu_torch.decode import greedy as greedy_mod

    model, rules = transcriber.model, transcriber.rules
    with torch.no_grad():
        cross_kv = transcriber._encode_windows(windows)
    prompt = torch.tensor([transcriber._prompt_row("en")] * len(windows), device=dev)
    runs = {
        "greedy (bf16 self cache)": lambda g: greedy_mod.greedy_decode_features(
            model, cross_kv, prompt, rules=rules, max_len=STEP_CHECK_LEN, graphed=g),
        f"beam-{BEAM} (int8 lanes)": lambda g: beam_mod.beam_decode_features(
            model, cross_kv, prompt, rules=rules, beam_size=BEAM, max_len=STEP_CHECK_LEN,
            quantize_cache=True, lane_cache=True, graphed=g)}
    for label, run in runs.items():
        results = {}
        for graphed in (False, True):
            reset_counts()
            results[graphed] = (run(graphed), launches())
            torch.cuda.synchronize()
        (eager, n_eager), (graph, n_graph) = results[False], results[True]
        same = all(torch.equal(a, b) for a, b in zip(eager, graph))
        print(f"{label}, {STEP_CHECK_LEN} steps: the StepGraph replays' result bit-equal to "
              f"the eager step function's {same}; launches eager "
              f"{ {n: c for n, c in n_eager.items() if c} }, graphed (warm-up + replays) "
              f"{ {n: c for n, c in n_graph.items() if c} } [{card}]")
        assert same and all(n_graph[n] > 0 for n in ("whisper_norm", "whisper_kv_rows",
                                                     "whisper_logit_rules")), n_graph


def check_c5(tq, lo, dev, card: str) -> None:
    """C5: a head-dim-64 Llama (2048 wide, 32 heads over 8, 4 layers,
    random bf16 weights quantized at 4 bits on the card) through
    models/llama.py:forward, a C5_PROMPT-token prefill and one decode step
    at a device pos, against the same model with the plain versions."""
    from turbo_whisper_workspace_tpu_torch.models import llama as lm

    dims = lm.LlamaDims(**C5_DIMS)
    assert dims.head_dim == 64
    params = tq.quantize_tree(lm.init_params(dims, torch.Generator(dev).manual_seed(5),
                                             torch.bfloat16, dev), bits=4)
    gen = torch.Generator(dev).manual_seed(6)
    prompt = torch.randint(0, dims.n_vocab, (1, C5_PROMPT), generator=gen, device=dev)
    step = torch.randint(0, dims.n_vocab, (1, 1), generator=gen, device=dev)
    errs = {}
    with torch.no_grad():
        caches = [lm.init_kv_cache(dims, 1, C5_PROMPT + 8, dtype=torch.bfloat16, device=dev)
                  for _ in range(2)]
        lo.reset_launch_counts()
        got = lm.forward(params, dims, prompt, caches[0], pos=0)[0]
        got_step = lm.forward(params, dims, step, caches[0],
                              pos=torch.tensor(C5_PROMPT, device=dev))[0]
        launched = dict(lo.launch_counts)
        with plain_kernels(tq, lo):
            ref = lm.forward(params, dims, prompt, caches[1], pos=0)[0]
            ref_step = lm.forward(params, dims, step, caches[1], pos=C5_PROMPT)[0]
        errs = {"prefill": rel_err(got, ref), "decode step": rel_err(got_step, ref_step)}
    print(f"C5: Llama at head dim 64 ({C5_DIMS}, int4 body) vs its plain twin: prefill of "
          f"{C5_PROMPT} tokens logits rel err {errs['prefill']:.3e}, decode step at a device "
          f"pos {errs['decode step']:.3e} (tolerance {MODEL_TOL}); launches {launched} [{card}]")
    assert launched["llama_attention"] == 2 * dims.n_layer, launched
    assert all(e <= MODEL_TOL for e in errs.values()), errs
    del params, caches


def whisper_kernels_phase(att, tq, transcriber, windows: np.ndarray, dev, card: str) -> dict:
    """Phase 16. Returns the three whisper_ops kernels' stats, the rows of
    the kernels line (a greedy step's shapes)."""
    from turbo_whisper_workspace_tpu_torch.models import whisper as wm
    from turbo_whisper_workspace_tpu_torch.ops import llama_ops as lo

    assert transcriber.rules.specials.n_vocab == wm.WHISPER_CONFIGS["large-v3-turbo"].n_vocab
    stats = whisper_kernel_timings(dev, card)
    check_whisper_steps(transcriber, windows, dev, card)
    check_c5(tq, lo, dev, card)
    return stats


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


def llm_profile_only() -> int:
    """`chip_smoke.py --llm-profile`: the build, then the LLM at the Q4
    point: profile_prefill, profile_decode eager and graphed, and phase
    8's three stage calls, timed (no result line). It reads nothing newer
    than the port's graphed LLM step (llm/generate.py, utils/step_loop.py),
    so the same file, copied into an older tree of the port, measures
    that tree the same way (`--before`)."""
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
    for graphed in (False, True):
        profile_decode(lm, params, dims, dev, card, graphed=graphed)
    run_llm_stages(params, dims, dev, card)
    return 0


def whisper_profile_only() -> int:
    """`chip_smoke.py --whisper-profile`: the build, then large-v3-turbo
    (random bf16 weights from seed 0) through phase 4's batch call
    (greedy, 8 windows) and phase 5's beam-5 batch call, twice each, phase
    14's graphed beam-5 decode over the lane cache of those 8 windows
    (DECODE steps), twice, and the by-kernel profiles of a graphed greedy
    step (int8 cross-KV, bf16 self cache) and a graphed beam-5 lanes step
    (no result line). It reads nothing newer than the port's graphed beam
    loop (decode/beam.py's `graphed` and `timings`), so the same file,
    copied into an older tree of the port, measures that tree the same
    way (`--before`)."""
    from turbo_whisper_workspace_tpu_torch.audio import io as audio_io
    from turbo_whisper_workspace_tpu_torch.config import PipelineConfig, TranscriptionConfig
    from turbo_whisper_workspace_tpu_torch.decode import beam as beam_mod
    from turbo_whisper_workspace_tpu_torch.decode import greedy as greedy_mod
    from turbo_whisper_workspace_tpu_torch.ops import build
    from turbo_whisper_workspace_tpu_torch.pipeline.audio_pipeline import (
        AudioProcessingPipeline)
    from turbo_whisper_workspace_tpu_torch.pipeline.transcriber import load_transcriber

    card = card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"kernels built in {build.build_all():.1f} s")
    dev = torch.device("cuda")
    tr = AudioProcessingPipeline(PipelineConfig(), device="cuda").load_transcription_model()
    beam_tr = load_transcriber(tr.model, TranscriptionConfig(beam_size=BEAM), device="cuda")
    golden, _ = audio_io.read_audio_file(GOLDEN)
    with tempfile.TemporaryDirectory() as tmp:
        long_path = os.path.join(tmp, "synth_75s.wav")
        write_wav(long_path, synth_clip(75.0, seed=1))
        batch = [audio_io.read_audio_file(long_path)[0], golden] + [
            synth_clip(15.0, seed=s) for s in (2, 3, 4)]
    total = sum(len(a) for a in batch) / 16000
    for phase, label, t in ((4, "greedy", tr), (5, f"beam-{BEAM}", beam_tr)):
        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            t.transcribe(batch)
            walls.append(time.perf_counter() - t0)
        print(f"{label} batch call (phase {phase}): {len(batch)} files, {total:.1f} s audio, "
              f"{t.last_n_windows} windows, walls {walls[0]:.3f} and {walls[1]:.3f} s, "
              f"{total / statistics.mean(walls):.2f} audio-s/s [{card}]")
    windows = batch_windows(tr, batch)
    with torch.no_grad():
        cross_kv = tr._encode_windows(windows)
    prompt = torch.tensor([tr._prompt_row("en")] * len(windows), device=dev)

    def greedy(n):
        timings = {}
        greedy_mod.greedy_decode_features(tr.model, cross_kv, prompt, rules=tr.rules,
                                          max_len=n, graphed=True, timings=timings)
        torch.cuda.synchronize()
        return timings

    def beam(n):
        timings = {}
        beam_mod.beam_decode_features(tr.model, cross_kv, prompt, rules=tr.rules,
                                      beam_size=BEAM, max_len=n, quantize_cache=True,
                                      lane_cache=True, graphed=True, timings=timings)
        torch.cuda.synchronize()
        return {**timings, "decode_forwards": timings["decode_forwards"] - 1}   # the loop's

    walls = []
    for _ in range(2):
        t0 = time.perf_counter()
        beam(DECODE)
        walls.append(time.perf_counter() - t0)
    print(f"beam-{BEAM} (int8 lanes) graphed decode (phase 14): {len(windows)} windows x "
          f"{DECODE} steps, walls {walls[0]:.3f} and {walls[1]:.3f} s [{card}]")
    print_step_profile("Whisper greedy (int8, graphed)",
                       step_profile(greedy, *GRAPH_PROFILE["whisper"]), card)
    print_step_profile(f"beam-{BEAM} (int8 lanes, graphed)", step_profile(beam, *BEAM_PROFILE),
                       card)
    return 0


def whisper_kernel_timings(dev, card: str) -> dict:
    """Phase 16's kernel checks and times at large-v3-turbo's shapes
    (whisper_norm, whisper_kv_rows, whisper_logit_rules, llama_attention
    at group 1), on random inputs: the three whisper_ops rows of the
    kernels line."""
    from turbo_whisper_workspace_tpu_torch.decode import rules as rules_mod
    from turbo_whisper_workspace_tpu_torch.decode.tokenizer import special_tokens_for_vocab
    from turbo_whisper_workspace_tpu_torch.models import whisper as wm
    from turbo_whisper_workspace_tpu_torch.ops import llama_ops as lo
    from turbo_whisper_workspace_tpu_torch.ops import whisper_ops as wo

    gen = torch.Generator(dev).manual_seed(16)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rules = rules_mod.DecodeRules(specials=special_tokens_for_vocab(
        wm.WHISPER_CONFIGS["large-v3-turbo"].n_vocab))
    stats = {"whisper_norm": check_whisper_norm(wo, dev, gen, flush, card),
             "whisper_kv_rows": check_whisper_kv_rows(wo, wm, dev, gen, flush, card),
             "whisper_logit_rules": check_whisper_logit_rules(wo, rules, dev, gen, flush, card)}
    check_whisper_attention(lo, dev, gen, flush, card)
    del flush
    torch.cuda.empty_cache()
    return stats


def sources_differ(tree: str, name: str) -> bool:
    """Whether kernel `name`'s source, or a shared header, differs between
    TREE's csrc/ and this checkout's."""
    def text(root, fname):
        path = os.path.join(root, "turbo_whisper_workspace_tpu_torch", "csrc", fname)
        return open(path).read() if os.path.exists(path) else None

    headers = {os.path.basename(p) for root in (tree, REPO) for p in glob.glob(
        os.path.join(root, "turbo_whisper_workspace_tpu_torch", "csrc", "*.cuh"))}
    return any(text(tree, f) != text(REPO, f) for f in (f"{name}.cu", *headers))


# the self-attention kernels' valid_lens in `--before`: both kernels'
# C interface took valid_len by value before it read it from device
# memory, so an earlier tree's library is called through that interface
BEFORE_VALID_LENS = {"self_attention_int8": (MID_DECODE, PROMPT + DECODE),
                     "self_attention_int8_lanes": (PROMPT, MID_DECODE, PROMPT + DECODE)}


def before_only(tree: str) -> int:
    """`chip_smoke.py --before TREE`, TREE an earlier commit of the repo,
    unpacked: first this file's `--llm-profile` run in TREE (a copy of
    this file put there) and in this checkout, in turns (before, this,
    this, before; a process each); then every kernel of BEFORE_SHAPES
    shape by shape, the two self-attention kernels by valid_len and
    mla_attention at MLA_TIMED's (S, position), whose source differs
    between the two trees, built from TREE's sources beside this
    checkout's and timed single launch (mla_attention back to back too)
    at each of its shapes in turns (each checked against its plain
    version). Prints the medians; no result line."""
    import ctypes
    import shutil

    from turbo_whisper_workspace_tpu_torch.ops import attention as att
    from turbo_whisper_workspace_tpu_torch.models import deepseek_v3 as ds
    from turbo_whisper_workspace_tpu_torch.ops import build
    from turbo_whisper_workspace_tpu_torch.ops import mla_ops
    from turbo_whisper_workspace_tpu_torch.ops import quant as tq
    from turbo_whisper_workspace_tpu_torch.ops import whisper_ops as wo
    from turbo_whisper_workspace_tpu_torch.scripts import profile_llm_ops as prof

    tree = os.path.abspath(tree)
    shutil.copy(os.path.abspath(__file__), os.path.join(tree, "chip_smoke.py"))
    for mode in ("--llm-profile", "--whisper-profile"):
        for which, root in (("the earlier tree", tree), ("this tree", REPO),
                            ("this tree", REPO), ("the earlier tree", tree)):
            print(f"{mode} of {which} ({root})", flush=True)
            proc = subprocess.run([sys.executable, os.path.join(root, "chip_smoke.py"), mode],
                                  cwd=root, timeout=900)
            assert proc.returncode == 0, (which, mode, proc.returncode)
    card = card_line()
    print(card)
    print(f"kernels built in {build.build_all():.1f} s")
    dev = torch.device("cuda")
    whisper_kernel_timings(dev, card)
    shapes = dict(BEFORE_SHAPES)
    shapes.update(BEFORE_VALID_LENS, mla_attention=MLA_TIMED)
    shapes = {name: s for name, s in shapes.items() if sources_differ(tree, name)}
    print(f"kernels whose source differs from the earlier tree's: {sorted(shapes) or 'none'}")
    src = os.path.join(tree, "turbo_whisper_workspace_tpu_torch", "csrc")
    out = os.path.join(REPO, "build", "torch_cuda", "before")
    os.makedirs(out, exist_ok=True)
    procs = {name: subprocess.Popen(
        [build._nvcc(), *build.NVCC_FLAGS, "-o", os.path.join(out, f"lib{name}.so"),
         os.path.join(src, f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for name in shapes}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, f"nvcc failed on the earlier {name}:\n{log}"
    libs = {name: {"before": build.load(os.path.join(out, f"lib{name}.so"), name),
                   "this": build.library(name)} for name in shapes}
    for name in (n for n in BEFORE_VALID_LENS if n in shapes):
        entry = getattr(libs[name]["before"], f"tww_{name}")
        with open(os.path.join(src, f"{name}.cu")) as f:
            host_int = "const void* valid_len" not in f.read()
        if host_int:      # valid_len by value, where this tree passes a pointer
            entry.argtypes = [a if a is not ctypes.c_void_p or i != len(entry.argtypes) - 2
                              else ctypes.c_int for i, a in enumerate(entry.argtypes)]
        libs[name]["host_int"] = host_int
    gen = torch.Generator(dev).manual_seed(7)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def self_inputs(name, valid):
        """(the kernel's call, a check of its output) at valid_len `valid`
        over the beam phase's cache; an earlier tree's host-int library is
        called directly, with valid_len by value"""
        def randn(*size):
            return torch.randn(*size, generator=gen, device=dev)

        h, t = 20, PROMPT + DECODE
        if name == "self_attention_int8":
            bk = 8 * BEAM
            kq, ks = wo.quantize_kv_rows(randn(bk, t, h * 64), h)
            vq, vs = wo.quantize_kv_rows(randn(bk, t, h * 64), h)
            args = (randn(bk, h, 1, 64).to(torch.bfloat16), kq, ks, vq, vs)
            dims = (bk * h, 1, t)
        else:
            b = 8
            kq, ks = wo.quantize_kv_rows(randn(b, BEAM * t, h * 64), h)
            vq, vs = wo.quantize_kv_rows(randn(b, BEAM * t, h * 64), h)
            args = (randn(b, h, BEAM, 64).to(torch.bfloat16),
                    kq.permute(0, 1, 3, 2).reshape(b, h * 64, BEAM * t).contiguous(), ks,
                    vq.permute(0, 2, 1, 3).reshape(b, BEAM * t, h * 64).contiguous(), vs,
                    random_ancestry(gen, b, BEAM, t, dev))
            dims = (b, h, BEAM, t)
        ref = getattr(att, f"{name}_reference")(*args, valid)
        vl = device_int(valid, dev)

        def call():
            if build._LIBS[name] is libs[name]["this"] or not libs[name]["host_int"]:
                return getattr(att, name)(*args, vl)
            o = torch.empty_like(args[0])
            code = getattr(build._LIBS[name], f"tww_{name}")(
                *(a.data_ptr() for a in args), o.data_ptr(), *dims, valid,
                torch.cuda.current_stream().cuda_stream)
            assert code == 0, code
            return o

        return call, lambda got: rel_err(got, ref) <= KERNEL_REL_TOL

    def mla_inputs_at(shape):
        """mla_attention's call at B = 1, 16 heads, `shape` = (S, device
        position), its check, and its back-to-back time over caches
        larger than L2"""
        s_len, pos = shape
        dims = ds.DEEPSEEK_V3_CONFIGS[MOE]
        tables = ds.rope_table(dims.qk_rope_dim // 2, dims.rope_theta, dims.max_ctx, dev)
        scale = dims.qk_head_dim ** -0.5
        q_lat, q_pe, c_kv, k_pe, cache = mla_inputs(gen, dev, 1, 16, s_len)
        args = (q_lat, q_pe, c_kv, k_pe, *tables)
        ref = mla_ops.mla_attention_reference(*args, cache.clone(), pos, scale)
        at = torch.tensor(pos, device=dev)
        copies = [args + (cache.clone(), at) for _ in range(
            min(BACK_TO_BACK, max(2, math.ceil(L2_BYTES / nbytes(cache)) + 1)))]
        return (lambda: mla_ops.mla_attention(*args, cache, at, scale),
                lambda got: rel_err(got, ref) <= KERNEL_REL_TOL,
                lambda: back_to_back_ms(lambda *a: mla_ops.mla_attention(*a, scale), copies,
                                        flush))

    def inputs(name, shape):
        """(the kernel's call, a check of its output[, its back-to-back
        time]) at `shape`: (M, K, N) of a matmul, valid_len of a
        self-attention kernel, (S, position) of mla_attention"""
        if name in BEFORE_VALID_LENS:
            return self_inputs(name, shape)
        if name == "mla_attention":
            return mla_inputs_at(shape)

        def randn(*size):
            return torch.randn(*size, generator=gen, device=dev)

        m, k, n = shape
        if name == "s8g4_matmul":
            q = tq.quantize_int4(randn(k, n) * k ** -0.5)
            xq, xs = tq.quant_act_grouped(randn(m, k), q["scale4"].shape[0])
            args = (xq, xs, q["w_q4"], q["scale4"])
            ref = prof.s8g4_matmul_reference(*args)
            return lambda: prof.s8g4_matmul(*args), lambda got: torch.equal(got, ref)
        q = tq.quantize_int8(randn(k, n) * k ** -0.5)
        wq, sc = q["w_q"], q["scale"]
        if name == "int8_matmul":
            x = randn(m, k).to(torch.bfloat16)
            ref = tq.int8_matmul_reference(x, wq, sc)
            return (lambda: tq.int8_matmul(x, wq, sc),
                    lambda got: rel_err(got, ref) <= KERNEL_REL_TOL)
        xq, xs = prof.quant_act(randn(m, k))
        ref = prof.s8_matmul_reference(xq, xs, wq, sc)
        return lambda: prof.s8_matmul(xq, xs, wq, sc), lambda got: torch.equal(got, ref)

    for name, name_shapes in shapes.items():
        for shape in name_shapes:
            call, check, *b2b = inputs(name, shape)
            times = {"before": [], "this": []}
            b2b_times = {"before": [], "this": []}
            for tree_name in ("before", "this", "this", "before"):
                build._LIBS[name] = libs[name][tree_name]
                assert check(call()), (name, tree_name, shape)
                times[tree_name].append(time_ms(call, flush))
                b2b_times[tree_name] += [fn() for fn in b2b]
            build._LIBS[name] = libs[name]["this"]
            label = (f"valid_len={shape}" if name in BEFORE_VALID_LENS
                     else "S={} pos {}".format(*shape) if name == "mla_attention"
                     else "M={} K={} N={}".format(*shape))
            shown = "".join(f", back to back {statistics.median(b2b_times['before']):.4f} → "
                            f"{statistics.median(b2b_times['this']):.4f} ms" for _ in b2b)
            print(f"{name} {label}: single launch, the earlier tree "
                  f"{statistics.median(times['before']):.4f} ms, this tree "
                  f"{statistics.median(times['this']):.4f} ms{shown} [{card}]")
            del call, check, b2b
            torch.cuda.empty_cache()
    return 0


def moe_kernels(tq, dev, gen, flush, card: str) -> dict:
    """Phase 17, the experts' kernel: int4_matmul_s8 (its sweep now in
    csrc/int4_s8.cuh) bit-equal to its plain version at the Llama
    shapes; int4_moe_s8 bit-equal to its plain version at the Moonlight
    decode step's gate|up (8 rows over one quantized input, split into
    gate and up) and down (group 64), a split-K plan (1 row) and a ragged
    one with a repeated and an out-of-range id; timed."""
    for m, k, n in QUANT_SHAPES["int4_matmul_s8"]:
        w = tq.quantize_int4(torch.randn(k, n, generator=gen, device=dev) * k ** -0.5,
                             group=min(128, k // 2))
        xq, xs = tq.quant_act_grouped(torch.randn(m, k, generator=gen, device=dev),
                                      w["scale4"].shape[0])
        assert torch.equal(tq.int4_matmul_s8(xq, xs, w["w_q4"], w["scale4"]),
                           tq.int4_matmul_s8_reference(xq, xs, w["w_q4"], w["scale4"])), (m, k, n)
    print(f"int4_matmul_s8 (sweep in int4_s8.cuh): bit-equal to its plain version at "
          f"{QUANT_SHAPES['int4_matmul_s8']}")
    # label → (rows, x_div, K, N, split, group)
    shapes = {"gate|up": (8, 8, 2048, 2816, True, 128), "down": (8, 1, 1408, 2048, False, 64),
              "down, 1 row (split K)": (1, 1, 1408, 2048, False, 64),
              "ragged": (3, 3, 256, 1000, False, 32)}
    rows_out, moe_errs = {}, {}
    for label, (rows, x_div, k, n, split, group) in shapes.items():
        w = tq.quantize_int4(torch.randn(MOE_EXPERTS, k, n, generator=gen, device=dev)
                             * k ** -0.5, group=group)
        xq, xs = tq.quant_act_grouped(torch.randn(rows // x_div, k, generator=gen, device=dev),
                                      k // group)
        ids = torch.randperm(MOE_EXPERTS, generator=gen, device=dev)[:rows]
        if label == "ragged":
            ids = torch.tensor([5, 5, 99], device=dev)          # 99 reads expert 65
        args = (xq, xs, w["w_q4"], w["scale4"], ids)
        got = tq.int4_moe_s8(*args, x_div=x_div, split=split)
        ref = tq.int4_moe_s8_reference(*args, x_div=x_div, split=split)
        for a, b in zip(got if split else (got,), ref if split else (ref,)):
            assert torch.equal(a, b), label
        got, ref = (torch.cat(got, -1), torch.cat(ref, -1)) if split else (got, ref)
        moe_errs[label] = ((got.float() - ref.float()).abs().max().item(), rel_err(got, ref))
        wide = n % 16 == 0
        pb = tq.s8_pairs_per_block(rows, k, n, k // group, wide, rows_per_block=1)
        print(f"int4_moe_s8 {label}: rows {rows}, x_div {x_div}, {k}→{n}, group {group}, "
              f"pairs a block {pb} of {k // group // 2}: bit-equal to its plain version")
        if label in ("gate|up", "down"):
            n_bytes = rows * (k // 2 * n + 4 * (k // group) * n) + nbytes(xq, xs) + 2 * rows * n
            n_ops = 2.0 * rows * k * n
            row = timed(f"int4_moe_s8 {label}", lambda: tq.int4_moe_s8(*args, x_div=x_div,
                                                                       split=split),
                        lambda: tq.int4_moe_s8_reference(*args, x_div=x_div, split=split),
                        n_bytes, n_ops, flush, PEAK_INT8_OPS)
            # back to back: each launch picks other experts of the 66 (190 MB of
            # gate|up, over the L2), as the steps of a decode do
            copies = [(xq, xs, w["w_q4"], w["scale4"],
                       torch.randperm(MOE_EXPERTS, generator=gen, device=dev)[:rows])
                      for _ in range(BACK_TO_BACK)]
            b2b = back_to_back_ms(lambda *a: tq.int4_moe_s8(*a, x_div=x_div, split=split),
                                  copies, flush)
            print(f"int4_moe_s8 {label}: back-to-back {b2b:.4f} ms per launch, other experts "
                  f"each launch [{card}]")
            rows_out[label] = {**row, "back_to_back_ms": b2b}
    stats = {"int4_moe_s8": kernel_row(rows_out["gate|up"], moe_errs)}
    # the prefill's grouped product: ~12000 rows over the 66 experts, loaded
    # as a 1500-token prompt routes them (uneven, some experts idle)
    load = torch.distributions.Dirichlet(torch.full((64,), 0.3)).sample() * MOE_PROMPT * 6
    counts = [int(c) for c in load.round().tolist()] + [MOE_PROMPT, MOE_PROMPT]
    errs = {}
    for label, (k, n, split, group) in {"gate|up": (2048, 2816, True, 128),
                                        "down": (1408, 2048, False, 64)}.items():
        w = tq.quantize_int4(torch.randn(MOE_EXPERTS, k, n, generator=gen, device=dev)
                             * k ** -0.5, group=group)
        x = torch.randn(sum(counts), k, generator=gen, device=dev).bfloat16()
        args = (x, w["w_q4"], w["scale4"], counts)
        got = tq.int4_group_matmul(*args, split=split)
        ref = tq.int4_group_matmul_reference(*args, split=split)
        got, ref = (torch.cat(got, -1), torch.cat(ref, -1)) if split else (got, ref)
        # outputs of order 5 in bf16: an ulp there is 3e-2, so the max abs
        # limit scales with max|ref|
        errs[label] = compare(f"int4_group_matmul {label} {sum(counts)} rows, {k}→{n}", got,
                              ref, {}, relative_max=True)
        n_ops = 2.0 * sum(counts) * k * n
        n_bytes = MOE_EXPERTS * (k // 2 * n + 4 * (k // group) * n) + 2 * sum(counts) * (k + n)
        row = timed(f"int4_group_matmul {label}", lambda: tq.int4_group_matmul(*args, split=split),
                    lambda: tq.int4_group_matmul_reference(*args, split=split), n_bytes, n_ops,
                    flush)
        if label == "gate|up":
            stats["int4_group_matmul"] = row
    stats["int4_group_matmul"] = kernel_row(stats["int4_group_matmul"], errs)
    return stats


def route_kernel(dev, gen, flush, card: str) -> dict:
    """Phase 17, the router: moe_route against its plain version at
    Moonlight's widths (2048 → 64, top 6, 2 shared) over 1, 8 and 1500
    rows: the chosen sets equal on every row whose k-th and (k+1)-th
    choice scores are not within 1e-5 (those are counted), ids in the
    same order, the weights within 1e-6 relative; timed at one row. The
    row's errors are the weights' over the rows whose ids agree, beside
    the counts of near-ties and of rows whose ids differ."""
    from turbo_whisper_workspace_tpu_torch.ops import moe_ops

    w = (torch.randn(64, 2048, generator=gen, device=dev) * 2048 ** -0.5).bfloat16()
    bias = torch.randn(64, generator=gen, device=dev) * 0.01
    shared = torch.arange(64, 66, device=dev)
    args, errs, near_ties, differ = None, {}, 0, 0
    for rows in (1, 8, MOE_PROMPT):
        h = torch.randn(rows, 2048, generator=gen, device=dev).bfloat16()
        args = (h, w, bias, shared, 6, 2.446)
        ids, wt = moe_ops.moe_route(*args)
        ids_r, wt_r = moe_ops.moe_route_reference(*args)
        choice = (torch.sigmoid(h.float() @ w.float().T) + bias).sort(-1, descending=True).values
        near = (choice[:, 5] - choice[:, 6]) < 1e-5
        same = (ids == ids_r).all(-1)
        assert bool((same | near).all()), (rows, int((~same).sum()))
        err = ((wt - wt_r).abs() / wt_r.abs()).masked_fill(~same[:, None], 0).max().item()
        assert err <= 1e-6, err
        if same.any():
            errs[rows] = ((wt - wt_r)[same].abs().max().item(), rel_err(wt[same], wt_r[same]))
        near_ties, differ = near_ties + int(near.sum()), differ + int((~same).sum())
        print(f"moe_route {rows} rows: ids equal on {int(same.sum())} rows, near-ties "
              f"{int(near.sum())}, weights max rel err {err:.2e}, (max abs, rel l2) "
              f"{errs.get(rows)}")
    h = args[0][:1]
    n_bytes = nbytes(h, w, bias) + 8 * 8 * 2
    row = timed("moe_route 1 row, 2048 → 64, top 6", lambda: moe_ops.moe_route(h, *args[1:]),
                lambda: moe_ops.moe_route_reference(h, *args[1:]), n_bytes,
                2.0 * 2048 * 64, flush)
    return {"moe_route": {**kernel_row(row, errs), "near_ties": near_ties,
                          "rows_ids_differ": differ}}


def mla_inputs(gen, dev, b: int, h: int, s_len: int) -> tuple:
    """mla_attention's inputs: q_lat (B, 1, H, 512), q_pe and k_pe as the
    rope columns of a fused projection's rows (strided views), c_kv, and
    a cache of random rows (the earlier positions)."""
    bf16 = torch.bfloat16
    q_lat = torch.randn(b, 1, h, 512, generator=gen, device=dev).to(bf16)
    q = torch.randn(b, 1, h, 192, generator=gen, device=dev).to(bf16)
    kv = torch.randn(b, 1, 576, generator=gen, device=dev).to(bf16)
    cache = torch.randn(b, s_len, 576, generator=gen, device=dev).to(bf16)
    return q_lat, q[..., 128:], kv[..., :512].contiguous(), kv[..., 512:], cache


def mla_kernels(dev, gen, flush, card: str) -> dict:
    """Phase 17, the latent attention: mla_attention against its plain
    version (limits of phase 3) at B = 1, 16 heads: a 2048-row cache at
    device positions 1800, 0, 2047, 1023 and 1024 (slices of 64 rows
    exactly, and one row past), a 2056-row cache at its last row (the
    cell's longest), a 4096-row one at 2559, 2560 and 4095 (slices of
    RESIDENT_ROWS exactly, one round more by a row, two rounds), a
    100-row cache (2 ranks), a host position, B = 2 at 32 heads (two head
    tiles) and B = 8 at 16 heads (more clusters than the card holds at 16
    ranks: the portable 8); the cache written where the plain version
    writes it, bit-equal, and nowhere else; the kernel without the
    position mask (every row visible) above the limit; one launch
    captured in a CUDA graph and replayed at another position; its ranks
    held to the Python mirror, beside the occupancy query's answer; then
    timed (mla_timings)."""
    from turbo_whisper_workspace_tpu_torch.models import deepseek_v3 as ds
    from turbo_whisper_workspace_tpu_torch.ops import mla_ops

    dims = ds.DEEPSEEK_V3_CONFIGS[MOE]
    cos, sin = ds.rope_table(dims.qk_rope_dim // 2, dims.rope_theta, dims.max_ctx, dev)
    scale = dims.qk_head_dim ** -0.5
    wide = mla_ops.kernel_wide_clusters()
    print(f"mla_attention: {wide} clusters of {mla_ops.WIDE_RANKS} blocks resident at once "
          f"(the occupancy query) [{card}]")
    errs = {}
    for b, h, s_len, pos in ((1, 16, MOE_CACHE, MOE_POS), (1, 16, MOE_CACHE, 0),
                             (1, 16, MOE_CACHE, MOE_CACHE - 1), (1, 16, MOE_CACHE, 1023),
                             (1, 16, MOE_CACHE, 1024), (1, 16, MOE_CACHE + 8, MOE_CACHE + 7),
                             (1, 16, 2 * MOE_CACHE, 2559), (1, 16, 2 * MOE_CACHE, 2560),
                             (1, 16, 2 * MOE_CACHE, 2 * MOE_CACHE - 1), (1, 16, 100, 70),
                             (2, 32, MOE_CACHE, 700), (8, 16, MOE_CACHE, 1500),
                             (1, 16, MOE_CACHE, "host")):
        q_lat, q_pe, c_kv, k_pe, cache = mla_inputs(gen, dev, b, h, s_len)
        at = 900 if pos == "host" else pos
        p = at if pos == "host" else torch.tensor(at, device=dev)
        clusters = b * -(-h // mla_ops.HEADS_A_BLOCK)
        ranks = mla_ops.ranks(s_len, clusters, wide)
        assert ranks == mla_ops.kernel_ranks(s_len, clusters), (s_len, clusters, ranks)
        assert clusters <= wide or ranks == mla_ops.PORTABLE_RANKS, (clusters, ranks)
        c_got, c_ref = cache.clone(), cache.clone()
        got = mla_ops.mla_attention(q_lat, q_pe, c_kv, k_pe, cos, sin, c_got, p, scale)
        ref = mla_ops.mla_attention_reference(q_lat, q_pe, c_kv, k_pe, cos, sin, c_ref, at,
                                              scale)
        assert torch.equal(c_got, c_ref), (b, h, s_len, pos)
        dropped = {}
        if 0 < at < s_len - 1:
            dropped["position mask"] = mla_ops.mla_attention_reference(
                q_lat, q_pe, c_kv, k_pe, cos, sin, cache.clone(), s_len - 1, scale)
        errs[(b, h, s_len, pos)] = compare(
            f"mla_attention B={b} H={h} S={s_len} pos {pos}, {ranks} ranks", got, ref, dropped)
    # a graph replay reads the position from device memory
    q_lat, q_pe, c_kv, k_pe, cache = mla_inputs(gen, dev, 1, 16, MOE_CACHE)
    p = torch.tensor(10, device=dev)
    c_graph = cache.clone()
    mla_ops.mla_attention(q_lat, q_pe, c_kv, k_pe, cos, sin, c_graph.clone(), p, scale)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = mla_ops.mla_attention(q_lat, q_pe, c_kv, k_pe, cos, sin, c_graph, p, scale)
    p.fill_(MOE_POS)
    graph.replay()
    c_ref = cache.clone()
    ref = mla_ops.mla_attention_reference(q_lat, q_pe, c_kv, k_pe, cos, sin, c_ref, MOE_POS,
                                          scale)
    assert torch.equal(c_graph, c_ref)
    errs["graph"] = compare(f"mla_attention captured at pos 10, replayed at {MOE_POS}", out,
                            ref, {})
    row = mla_timings(dev, gen, flush, card, (cos, sin, scale))
    return {"mla_attention": kernel_row(row, errs)}


# phase 17's latent-attention timings: (cache rows S, device position)
MLA_TIMED = ((MOE_CACHE, 0), (MOE_CACHE, 200), (MOE_CACHE, 1200), (MOE_CACHE, MOE_POS),
             (MOE_CACHE, MOE_CACHE - 1), (2 * MOE_CACHE, 2 * MOE_CACHE - 1))


def mla_timings(dev, gen, flush, card: str, tables: tuple) -> dict:
    """mla_attention at B = 1, 16 heads, at each MLA_TIMED shape: single
    launch (L2 flushed) and back to back over caches larger than L2.
    Returns the row at MOE_POS: beside the bound, the plain version and
    scaled_dot_product_attention on the absorbed rows."""
    from turbo_whisper_workspace_tpu_torch.ops import mla_ops

    cos, sin, scale = tables
    row = None
    for s_len, pos in MLA_TIMED:
        q_lat, q_pe, c_kv, k_pe, cache = mla_inputs(gen, dev, 1, 16, s_len)
        p = torch.tensor(pos, device=dev)
        args = (q_lat, q_pe, c_kv, k_pe, cos, sin, cache, p)
        copies = [args[:6] + (cache.clone(), p) for _ in range(
            min(BACK_TO_BACK, max(2, math.ceil(L2_BYTES / nbytes(cache)) + 1)))]
        single = time_ms(lambda: mla_ops.mla_attention(*args, scale), flush)
        b2b = back_to_back_ms(lambda *a: mla_ops.mla_attention(*a, scale), copies, flush)
        print(f"mla_attention B=1 H=16 S={s_len} pos {pos}: single {single:.4f} ms, "
              f"back-to-back {b2b:.4f} ms per launch over {len(copies)} caches [{card}]")
        if (s_len, pos) == (MOE_CACHE, MOE_POS):
            n_rows = pos + 1
            n_bytes = (n_rows * 576 * 2 + nbytes(q_lat) + 16 * 64 * 2 + 576 * 2
                       + 16 * 512 * 2 * 2)
            row = timed(f"mla_attention B=1 H=16 pos {pos}",
                        lambda: mla_ops.mla_attention(*args, scale),
                        lambda: mla_ops.mla_attention_reference(*args[:7], pos, scale),
                        n_bytes, 2.0 * 16 * n_rows * (576 + 512), flush)
            qf = torch.cat([q_lat, q_pe], -1).transpose(1, 2)             # (1, 16, 1, 576)
            keys = cache[:, None, :n_rows]
            row["library_ms"] = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qf, keys.expand(1, 16, n_rows, 576), keys[..., :512].expand(1, 16, n_rows, 512),
                scale=scale), flush)
            row["back_to_back_ms"] = b2b
            print(f"mla_attention B=1 H=16 pos {pos}: library (scaled_dot_product_attention "
                  f"on the absorbed rows) {row['library_ms']:.4f} ms [{card}]")
    return row


def moe_model(tq, lo, dev, card: str) -> dict:
    """Phase 17, the model: Moonlight-16B-A3B's widths at MOE_LAYERS
    layers, Q4 (int4 body, the experts' down in groups of 64, int8
    head), served by TorchLlama: a MOE_PROMPT-token prefill and a decode
    step against the plain twin (the logits' median per-token relative
    error within MODEL_TOL, the routings that differ counted), the
    graphed generation against the eager one (tokens equal), each
    kernel's launches a step, and the graphed step's time."""
    import dataclasses

    from turbo_whisper_workspace_tpu_torch.llm import generate, llm_helper
    from turbo_whisper_workspace_tpu_torch.models import deepseek_v3 as ds
    from turbo_whisper_workspace_tpu_torch.ops import mla_ops, moe_ops

    dims = dataclasses.replace(ds.DEEPSEEK_V3_CONFIGS[MOE], n_layer=MOE_LAYERS, max_ctx=4096)
    gen = torch.Generator(dev).manual_seed(0)
    params = ds.init_params(dims, gen, dtype=torch.bfloat16, bias_std=MOE_BIAS_STD, device=dev)
    params = tq.quantize_tree(params, keys=ds.QUANT_KEYS, bits=4)
    llm = llm_helper.TorchLlama(params, dims, device=dev)
    assert llm.params["blocks"][1]["experts"]["down"]["scale4"].shape[-2] == 1408 // 64
    prompt = torch.randint(0, dims.n_vocab, (1, MOE_PROMPT), generator=gen, device=dev)
    step = torch.randint(0, dims.n_vocab, (1, 1), generator=gen, device=dev)
    routes = []
    route = ds.route

    def recording(*a, **kw):
        ids, w = route(*a, **kw)
        routes.append(ids[:, :dims.top_k].sort(-1).values)
        return ids, w

    mods = (tq, lo, mla_ops, moe_ops)
    with torch.no_grad():
        ds.route = recording
        try:
            cache = ds.init_kv_cache(dims, 1, MOE_PROMPT + 8, device=dev)
            logits, _ = ds.forward(llm.params, dims, prompt, cache, 0)
            prefilled = {k: v.clone() for k, v in cache.items()}
            reset_counts(*mods)
            step_logits, _ = ds.forward(llm.params, dims, step, cache,
                                        torch.tensor(MOE_PROMPT, device=dev))
            step_launches = launches(*mods)
            with plain_kernels(*mods):
                plain, _ = ds.forward(llm.params, dims, prompt,
                                      ds.init_kv_cache(dims, 1, MOE_PROMPT + 8, device=dev), 0)
                step_plain, _ = ds.forward(llm.params, dims, step, prefilled, MOE_PROMPT)
        finally:
            ds.route = route
    half = len(routes) // 2
    flips = [(a != b).any(-1).float().mean().item() for a, b in zip(routes[:half], routes[half:])]
    per_token = ((logits - plain).float().norm(dim=-1) / plain.float().norm(dim=-1))[0]
    e_step = rel_err(step_logits, step_plain)
    print(f"{MOE} at {MOE_LAYERS} layers (Q4) vs its plain twin: prefill of {MOE_PROMPT} "
          f"tokens, per-token logits rel err median {per_token.median().item():.3e}, max "
          f"{per_token.max().item():.3e}; decode step {e_step:.3e} (tolerance {MODEL_TOL}); "
          f"routings that differ a layer (prefill, step): {flips}; step launches "
          f"{step_launches}")
    assert per_token.median().item() <= MODEL_TOL and e_step <= MODEL_TOL
    n_moe = MOE_LAYERS - dims.first_dense
    assert step_launches["int4_moe_s8"] == 2 * n_moe and step_launches["moe_route"] == n_moe
    assert step_launches["mla_attention"] == MOE_LAYERS
    # q|kv_a and out a layer, gate|up and down in the dense layer
    assert step_launches["int4_matmul_s8"] == 2 * MOE_LAYERS + 2 * dims.first_dense
    # graphed against eager, greedy
    short = prompt[:, :256]
    runs = {}
    for graphed in (True, False):
        reset_counts(*mods)
        timings = {}
        res = generate.generate_tokens(llm.params, dims, short, max_len=64, graphed=graphed,
                                       timings=timings)
        torch.cuda.synchronize()
        runs[graphed] = (res, timings, launches(*mods))
    assert torch.equal(runs[True][0].tokens, runs[False][0].tokens)
    t = runs[True][1]
    print(f"graphed generation (256-token prompt, 64 new) equal to the eager one; graphed "
          f"step {1e3 * t['loop_s'] / t['decode_forwards']:.3f} ms at {MOE_LAYERS} layers, "
          f"capture {1e3 * t['capture_s']:.1f} ms; launches {runs[True][2]} [{card}]")
    return {"moe model": runs[True][2]}


def moe_phase(tq, lo, dev, card: str) -> tuple[dict, dict]:
    """Phase 17: the DeepSeek-V3 path's kernels at Moonlight-16B-A3B's
    widths, then the model (moe_kernels, mla_kernels, moe_model)."""
    gen = torch.Generator(dev).manual_seed(17)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=dev)
    stats = moe_kernels(tq, dev, gen, flush, card)
    stats.update(route_kernel(dev, gen, flush, card))
    stats.update(mla_kernels(dev, gen, flush, card))
    del flush
    torch.cuda.empty_cache()
    return stats, moe_model(tq, lo, dev, card)


def moe_only() -> int:
    """`--moe`: the kernels' build and phase 17 alone."""
    from turbo_whisper_workspace_tpu_torch.ops import build
    from turbo_whisper_workspace_tpu_torch.ops import llama_ops as lo
    from turbo_whisper_workspace_tpu_torch.ops import quant as tq

    card = card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"kernels built in {build.build_all():.1f} s")
    for name in ("int4_matmul_s8", "int4_moe_s8", "int4_group_matmul", "mla_attention",
                 "moe_route"):
        used = [ln.split(":", 1)[1].strip() for ln in build.build_log.get(name, "").splitlines()
                if "Used" in ln]
        print(f"  {name}: {'; '.join(used)}")
    moe_phase(tq, lo, torch.device("cuda"), card)
    print(json.dumps({"ok": True, "phase": 17}))
    return 0


def main(argv: list[str] | None = None) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    args = sys.argv[1:] if argv is None else argv
    if "--tp-worker" in args:
        i = args.index("--tp-worker")
        return tp_worker(int(args[i + 1]), int(args[i + 2]), int(args[i + 3]), args[i + 4])
    if "--llm-profile" in args:
        return llm_profile_only()
    if "--whisper-profile" in args:
        return whisper_profile_only()
    if "--before" in args:
        return before_only(args[args.index("--before") + 1])
    if "--moe" in args:
        return moe_only()
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
        counts = launches()
        print(f"launches on the {path} path: {counts}")
        assert all(counts[name] > 0 for name in kernels), (path, counts)
        return counts

    path_counts = {}
    reset_counts()
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
    path_counts["greedy"] = read_counts("greedy", ("flash_attention", "cross_attention_int8",
                                                   *WHISPER_KERNELS))

    # 5. beam path: beam 5 over the int8 lane self-KV cache, same model
    check_beam_step(att, transcriber, golden)
    beam_cfg = TranscriptionConfig(beam_size=BEAM)
    assert beam_cfg.quantize_self_kv and beam_cfg.max_decode_len == DECODE
    beam_tr = load_transcriber(transcriber.model, beam_cfg, device="cuda")
    reset_counts()
    batch_call(beam_tr, batch, f"beam-{BEAM}")
    request(AudioProcessingPipeline(PipelineConfig(transcription=beam_cfg),
                                    transcriber=beam_tr, device="cuda"),
            beam_tr, GOLDEN, f"beam-{BEAM}")
    path_counts["beam"] = read_counts(
        "beam", ("flash_attention", "cross_attention_int8", "self_attention_int8_lanes",
                 "whisper_norm", "whisper_kv_rows", "whisper_logit_rules"))

    # the same beam search called directly on a bucket's cross-KV, in each
    # cache mode (quantize_cache, lane_cache), in turns: ABCCBA
    modes = {"int8 lanes": ((True, True), ("self_attention_int8_lanes",)),
             "int8 regathered": ((True, False), ("self_attention_int8",)),
             "bf16 regathered": ((False, False), ("llama_attention",))}
    windows = np.stack([synth_clip(30.0, seed=s) for s in range(5, 13)])
    with torch.no_grad():
        cross_kv = beam_tr._encode_windows(windows)
    prompt = torch.tensor([beam_tr._prompt_row("en")] * len(windows), device=dev)
    n_vocab = beam_tr.model.dims.n_vocab
    walls = {mode: [] for mode in modes}
    for mode in list(modes) + list(modes)[::-1]:
        (quantize_cache, lane_cache), kernels = modes[mode]
        reset_counts()
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
        reset_counts()
        batch_call(s8_tr, batch, label)
        path_counts[label] = read_counts(label, ("flash_attention", "cross_attention_s8"))
        assert path_counts[label]["cross_attention_int8"] == 0, path_counts[label]

    # 7. the master flow: transcribe → diarize → merge → enrich, same model
    path_counts["master flow"], flow_pipe = master_flow_phase(att, transcriber, dev, card)

    # 8. the LLM enrichment path: llama-3.1-8b at the Q4 point
    del beam_tr, s8_tr, cross_kv, transcriber, pipe
    torch.cuda.empty_cache()
    qstats, path_counts["llm"], llm = llm_phase(att, dev, card)
    stats.update(qstats)

    # 9. the LLM-ops profiler path at llama-3.2-3b width
    torch.cuda.empty_cache()
    pstats, path_counts["profiler"] = profiler_phase(dev, card)
    stats.update(pstats)

    # 10. the offline tool shell: phase 7's pipeline, phase 8's LLM
    from turbo_whisper_workspace_tpu_torch.ops import quant as tq

    path_counts["tool shell"] = tool_shell_phase(att, tq, flow_pipe, llm, dev, card)

    # 11. serving: phase 7's pipeline behind the port's HTTP server
    path_counts["serving"] = serving_phase(att, flow_pipe, dev, card)

    # 12. parallelism: DP = 1 and the train step on an NCCL group of one
    # rank, TP = 2 in two processes sharing the card
    path_counts.update(parallel_phase(att, flow_pipe.load_transcription_model(), dev, card))

    # 13. the greedy and LLM decode loops as CUDA graphs against their
    # eager step functions
    tr = flow_pipe.load_transcription_model()
    windows = batch_windows(tr, batch)
    assert len(windows) == 8, len(windows)
    path_counts["graph loops"] = graph_phase(att, tq, tr, windows, llm, dev, card)

    # 14. the beam loop as a CUDA graph against its eager step function
    path_counts["beam graph loops"] = beam_graph_phase(att, tr, windows, dev, card)

    # 15. the Llama layer's kernels against their plain versions, and the
    # graphed step against the eager one
    stats.update(llama_kernels_phase(att, tq, llm, dev, card))

    # 16. the Whisper decoder step's kernels against their plain versions,
    # the graphed steps against the eager ones, and C5
    del llm
    torch.cuda.empty_cache()
    stats.update(whisper_kernels_phase(att, tq, tr, windows, dev, card))

    # 17. the DeepSeek-V3 path: its kernels, then Moonlight's widths at 3 layers
    del tr, flow_pipe
    torch.cuda.empty_cache()
    from turbo_whisper_workspace_tpu_torch.ops import llama_ops as lo

    moe_stats, moe_counts = moe_phase(tq, lo, dev, card)
    stats.update(moe_stats)
    path_counts.update(moe_counts)

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
