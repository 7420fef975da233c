"""Shared utilities: native-library build/loading, wordlists
(counterpart: turbo_whisper_workspace_tpu/utils/__init__.py)."""
