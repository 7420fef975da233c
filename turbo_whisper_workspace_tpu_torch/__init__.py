"""Turbo-Whisper-Workspace on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package `turbo_whisper_workspace_tpu`, which stays the
reference. Module names match the JAX package so each counterpart is easy
to find. The port imports `torch`, never `jax`, and nothing of the JAX
package. Entry points run on CUDA unless the caller passes
`device="cpu"`; the TPU's Pallas kernels are CUDA C++ kernels for
`sm_90a` under `csrc/`, built at first use (`ops/build.py`).

Layering:
    ops/       mel frontend, attention and quantized-matmul kernels'
               wrappers, quantizers, kernel build
    models/    Whisper encoder/decoder as nn.Modules, the Llama LM, the
               segmentation and speaker-embedding nets, weight conversion
    decode/    token rules, greedy and beam decode, long-form chunking/merge
    llm/       Llama generation, speaker naming, summaries, topics
    pipeline/  transcriber, diarizer, the master flow (process_audio /
               process_batch: transcribe → diarize → merge → enrich)
    analysis/  security monitors, preprocessing (torch on a device),
               diagnostics, audio info, visualizer (matplotlib, lazy)
    audio/     first-party audio decode (copy of the JAX package's),
               features (MFCC, silence, splits)
    utils/     model registry, WER/DER metrics and the corpus evaluator,
               profiling, native builds, wordlists
    parallel/  meshes over torch.distributed ranks, Megatron sharding,
               DP/TP decode, the training step, the directory batch driver
    serve/     HTTP API (stdlib server), client, browser UI
    __main__   CLI: api, ui, batch, transcribe, security, info, diagnose,
               preprocess, convert, models, eval, check-gpu
"""

__version__ = "0.1.0"
