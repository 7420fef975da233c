"""Decoding: tokenizer, token rules, greedy decode, long-form chunking
(counterpart: turbo_whisper_workspace_tpu/decode/__init__.py)."""
