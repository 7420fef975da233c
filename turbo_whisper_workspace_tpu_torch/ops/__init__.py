"""Numeric ops: mel frontend and the CUDA attention kernels with their plain
twins (counterpart: turbo_whisper_workspace_tpu/ops/__init__.py)."""
