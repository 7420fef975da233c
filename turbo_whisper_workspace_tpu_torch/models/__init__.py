"""Whisper as torch nn.Modules, the Llama LM on plain tensors, and weight
conversion from the JAX tree
(counterpart: turbo_whisper_workspace_tpu/models/__init__.py)."""
