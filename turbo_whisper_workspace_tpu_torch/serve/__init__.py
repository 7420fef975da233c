"""Serving: HTTP API, client, browser UI (port of turbo_whisper_workspace_tpu/serve/)."""
