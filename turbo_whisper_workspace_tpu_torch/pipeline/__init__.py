"""Pipeline: transcriber and the single-file transcription entry point
(counterpart: turbo_whisper_workspace_tpu/pipeline/__init__.py)."""
