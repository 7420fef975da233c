"""Shared utilities: native-library build/loading
(counterpart: turbo_whisper_workspace_tpu/utils/__init__.py)."""
