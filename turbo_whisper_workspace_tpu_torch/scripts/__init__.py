"""Command-line tools of the port, run as `python -m
turbo_whisper_workspace_tpu_torch.scripts.<name>` (counterparts of the
JAX side's `scripts/`)."""
