"""Text/signal analysis: security monitoring, preprocessing, diagnostics,
visualization, audio info (port of turbo_whisper_workspace_tpu/analysis)."""
