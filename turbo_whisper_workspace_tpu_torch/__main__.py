"""CLI: python -m turbo_whisper_workspace_tpu_torch <command>.

Port of the JAX package's CLI (turbo_whisper_workspace_tpu/__main__.py),
so far its `transcribe` (the master flow on one file: conversation
markdown, summary, or the whole result with --json) and `models
list|check|download`. `--device` (default cuda) picks where the models
run; pass `--device cpu` on a machine without a GPU. Checkpoints are
looked up under `PipelineConfig().models_dir`.

    python -m turbo_whisper_workspace_tpu_torch transcribe -i clip.wav --model tiny
    python -m turbo_whisper_workspace_tpu_torch models list
"""

from __future__ import annotations

import argparse
import json
import logging


def run_transcribe(args):
    from .config import PipelineConfig
    from .pipeline.audio_pipeline import get_pipeline

    config = PipelineConfig()
    if args.model:
        config.transcription.model = args.model
    if args.language:
        config.transcription.language = args.language
    if args.beam_size:
        config.transcription.beam_size = args.beam_size
    res = get_pipeline(config, device=args.device).process_audio(
        args.input, task=args.task, num_speakers=args.num_speakers,
        enrich=not args.no_enrich, initial_prompt=args.initial_prompt,
    )
    if args.json:
        print(json.dumps(res, indent=1, default=str))
    else:
        from .pipeline.diarizer import SpeakerDiarizer

        print(SpeakerDiarizer.format_as_conversation(res["merged_segments"]))
        if res.get("summary"):
            print("\n--- summary ---\n" + res["summary"])


def run_models(args):
    from .config import PipelineConfig
    from .utils import registry

    models_dir = PipelineConfig().models_dir
    if args.action == "check":
        print(json.dumps(registry.check_models(models_dir), indent=1))
    elif args.action == "list":
        print(json.dumps({
            "segmentation": registry.speaker_segmentation_models(),
            "embedding": registry.embedding2models(),
        }, indent=1))
    else:
        print(json.dumps(registry.download_models(models_dir=models_dir), indent=1))


def main(argv=None):
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s [%(levelname)s] %(name)s: %(message)s",
    )
    p = argparse.ArgumentParser(prog="turbo_whisper_workspace_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("transcribe", help="transcribe one file")
    s.add_argument("--input", "-i", required=True)
    s.add_argument("--task", default="transcribe",
                   choices=["transcribe", "translate"])
    s.add_argument("--model", default=None,
                   help="whisper config name (tiny/base/.../large-v3-turbo)")
    s.add_argument("--language", default=None,
                   help="force language (default: auto-detect)")
    s.add_argument("--beam-size", type=int, default=None,
                   help="beam width (default 1 = greedy)")
    s.add_argument("--initial-prompt", default=None,
                   help="condition decode on this text (<|startofprev|>)")
    s.add_argument("--num-speakers", type=int, default=2)
    s.add_argument("--no-enrich", action="store_true")
    s.add_argument("--json", action="store_true")
    s.add_argument("--device", default="cuda",
                   help="torch device the models run on (default: cuda)")
    s.set_defaults(fn=run_transcribe)

    s = sub.add_parser("models", help="model registry")
    s.add_argument("action", choices=["check", "list", "download"])
    s.set_defaults(fn=run_models)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
