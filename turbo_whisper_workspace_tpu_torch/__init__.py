"""Turbo-Whisper-Workspace on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package `turbo_whisper_workspace_tpu`, which stays the
reference. Module names match the JAX package so each counterpart is easy
to find. The port imports `torch`, never `jax`, and nothing of the JAX
package. Entry points run on CUDA unless the caller passes
`device="cpu"`; the TPU's Pallas kernels are CUDA C++ kernels for
`sm_90a` under `csrc/`, built at first use (`ops/build.py`).

Layering:
    ops/       mel frontend, attention kernels' wrappers, kernel build
    models/    Whisper encoder/decoder as nn.Modules, weight conversion
    decode/    token rules, greedy decode, long-form chunking/merge
    pipeline/  transcriber and the single-file pipeline entry
    audio/     first-party audio decode (copy of the JAX package's)
"""

__version__ = "0.1.0"
