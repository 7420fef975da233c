"""First-party audio I/O
(counterpart: turbo_whisper_workspace_tpu/audio/__init__.py)."""
