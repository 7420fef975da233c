"""LLM enrichment: Llama generation and the speaker-naming, summary and
topic helpers (counterpart: turbo_whisper_workspace_tpu/llm/__init__.py)."""
