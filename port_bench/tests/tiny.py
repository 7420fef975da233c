"""A checkout-shaped directory for CPU runs of the harness: the real
BENCHMARK.json's cells and metrics over tiny configurations (the
published layouts at a few layers and narrow widths) and short traffic."""

from __future__ import annotations

import json
import os

from port_bench.lib import spec

ROOT = os.path.dirname(spec.BENCH_DIR)

WHISPER = {"model_type": "whisper", "d_model": 128, "encoder_layers": 2,
           "encoder_attention_heads": 2, "encoder_ffn_dim": 512, "decoder_layers": 2,
           "decoder_attention_heads": 2, "decoder_ffn_dim": 512, "num_mel_bins": 128,
           "vocab_size": 51866, "max_source_positions": 1500, "max_target_positions": 448,
           "dtype": "bfloat16"}
LLAMA = {"model_type": "mistral", "hidden_size": 256, "intermediate_size": 512,
         "num_hidden_layers": 2, "num_attention_heads": 2, "num_key_value_heads": 1,
         "vocab_size": 512, "max_position_embeddings": 4096, "rope_theta": 1000000.0,
         "rms_norm_eps": 1e-05,
         "quantization": {"body_bits": 4, "group": 128, "head_bits": 8,
                          "decode_activation_bits": 8}}
TRAFFIC = {
    "batch-32win": {"windows_per_call": 4, "file_seconds": [40, 70], "pool_calls": 2,
                    "transcription": {"max_decode_len": 12, "batch_size": 4}},
    "requests-5-120s": {"pool_calls": 4, "file_seconds": [5, 40],
                        "transcription": {"max_decode_len": 12}},
    "enrich-20seg": {"pool_calls": 3, "greedy_every": 1, "llm": {"max_tokens_names": 4, "max_tokens_summary": 5,
                                              "max_tokens_topics": 5}},
}
CELLS = {"turbo-batch-greedy": {"check_calls": 1, "check_rows": 2},
         "turbo-requests": {"check_calls": 2, "check_rows": 2},
         "mistral7b-enrich": {}}


def make_root(path: str, limits: dict | None = None) -> str:
    """Writes the directory at `path` and returns it; `limits` replaces
    the cells' limits (by cell name)."""
    bench = spec.load_json(os.path.join(os.path.dirname(spec.BENCH_DIR), "BENCHMARK.json"))
    for sub in ("configs", "traffic", "cells"):
        os.makedirs(os.path.join(path, sub), exist_ok=True)
    for c in bench["configs"]:
        cfg = WHISPER if c["name"].startswith("whisper") else LLAMA
        c["file"] = f"configs/{c['name']}.json"
        with open(os.path.join(path, c["file"]), "w") as f:
            json.dump(cfg, f)
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    for name, change in TRAFFIC.items():
        mix = spec.traffic(name)
        for key, value in change.items():
            mix[key] = {**mix[key], **value} if isinstance(value, dict) else value
        with open(os.path.join(path, "traffic", f"{name}.json"), "w") as f:
            json.dump(mix, f)
    for name, change in CELLS.items():
        cell = {**spec.cell(name), **change}
        if limits and name in limits:
            cell["limits"] = limits[name]
        with open(os.path.join(path, "cells", f"{name}.json"), "w") as f:
            json.dump(cell, f)
    return path
