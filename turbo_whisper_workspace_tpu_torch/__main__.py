"""CLI: python -m turbo_whisper_workspace_tpu_torch <command>.

Port of the JAX package's CLI (turbo_whisper_workspace_tpu/__main__.py):
`api` (the HTTP API server), `ui` (the browser UI), `batch` (the
directory batch driver: sharded over torch.distributed ranks when
launched by torchrun, resumable), `transcribe` (the master flow on one
file: conversation markdown, summary, or the whole result with --json),
`security` (the security
monitors; `--bar --test` runs the mock transcript), `info` and
`diagnose` (file statistics and a diagnostic report, numpy), `preprocess`
(normalize, denoise, filter), `convert` (an HF Whisper snapshot → the
`.npz` both packages load), `models list|check|download`, `eval` (corpus
WER/DER) and `check-gpu`, which takes the place of the JAX `check-tpu`.
`--device` (default cuda) picks where the models and the torch parts of
preprocessing run; pass `--device cpu` on a machine without a GPU.
Checkpoints are looked up under `PipelineConfig().models_dir`.

    python -m turbo_whisper_workspace_tpu_torch api --port 8000
    python -m turbo_whisper_workspace_tpu_torch batch -i audio_dir -o out --model tiny
    python -m turbo_whisper_workspace_tpu_torch transcribe -i clip.wav --model tiny
    python -m turbo_whisper_workspace_tpu_torch preprocess -i in.wav -o out.wav --dynamic
    python -m turbo_whisper_workspace_tpu_torch models list
"""

from __future__ import annotations

import argparse
import json
import logging
import sys


def run_api(args):
    from .serve.api import run_api_server

    run_api_server(args.host, args.port, args.device)


def run_ui(args):
    from .serve.ui import run_ui as _run

    _run(args.host, args.port, args.device)


def run_batch(args):
    from .parallel.batch_driver import BatchDriver
    from .parallel.infer import maybe_initialize_distributed

    # under torchrun: the group, and this rank's card, before any model loads
    maybe_initialize_distributed(args.device)
    pipeline = None
    if args.model:
        from .config import PipelineConfig
        from .pipeline.audio_pipeline import get_pipeline

        config = PipelineConfig()
        config.transcription.model = args.model
        pipeline = get_pipeline(config, device=args.device)
    driver = BatchDriver(pipeline=pipeline, output_dir=args.output,
                         files_per_call=args.files_per_call, device=args.device)
    stats = driver.run_directory(args.input, num_speakers=args.num_speakers,
                                 enrich=not args.no_enrich)
    print(json.dumps(stats.to_dict(), indent=1))


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


def run_security(args):
    from .analysis import bar_security_monitor, security_monitor

    argv = ["--input", args.input, "--output", args.output,
            "--min-threat-level", str(args.min_threat_level), "--device", args.device]
    if args.bar:
        bar_security_monitor.main(argv + (["--test"] if args.test else []))
    else:
        security_monitor.main(argv)


def run_info(args):
    from .analysis.audio_info import get_audio_info

    print(json.dumps(get_audio_info(args.input), indent=1))


def run_diagnose(args):
    from .analysis.diagnostics import diagnose
    from .audio.io import read_audio_file

    audio, _ = read_audio_file(args.input)
    print(str(diagnose(audio)))


def run_preprocess(args):
    import numpy as np

    from .analysis import preprocess as pp
    from .audio.io import read_audio_file, write_wav

    audio, sr = read_audio_file(args.input, normalize=False)
    if args.denoise > 0:
        audio = pp.spectral_denoise(audio, strength=args.denoise, device=args.device)
    if args.dynamic:
        audio = pp.dynamic_normalize(audio, window_s=args.window,
                                     target_db=args.target_db, device=args.device)
    elif args.normalize:
        audio = pp.rms_normalize(audio, target_db=args.target_db)
    if args.effects:
        audio = pp.apply_audio_effects(audio)
    write_wav(args.output, np.asarray(audio), sr)
    print(f"wrote {args.output}")


def run_convert(args):
    """An HF Whisper snapshot → the flat `.npz` of save_params (f32),
    which both packages' load_params read."""
    import torch

    from .models import convert

    model, dims = convert.load_hf_snapshot(args.input, dtype=torch.float32)
    convert.save_params(args.output, model)
    print(f"converted {args.input} -> {args.output} ({dims})")


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


def run_eval(args):
    from .utils import evaluate

    argv = ["--audio", args.audio, "--num-speakers", str(args.num_speakers),
            "--collar", str(args.collar), "--device", args.device]
    if args.ref:
        argv += ["--ref", args.ref]
    if args.rttm:
        argv += ["--rttm", args.rttm]
    if args.model:
        argv += ["--model", args.model]
    evaluate.main(argv)


def run_check_gpu(args):
    """Device probe and matmul timing (reference check_gpu.py): the
    card's name and power limit, then ten 4096³ bf16 matmuls between two
    CUDA events."""
    import subprocess

    import torch

    if not torch.cuda.is_available():
        sys.exit("check-gpu: no CUDA device is visible to PyTorch "
                 f"(torch {torch.__version__}, CUDA build {torch.version.cuda})")
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError) as e:
        card = f"{torch.cuda.get_device_name(0)} (power limit not read: {e})"
    print(f"devices: {torch.cuda.device_count()} x {torch.cuda.get_device_name(0)}")
    print(f"card: {card}")
    n, reps = 4096, 10
    a = torch.ones(n, n, dtype=torch.bfloat16, device="cuda")
    out = a @ a                               # warm-up
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        torch.mm(a, a, out=out)
    end.record()
    end.synchronize()
    dt = start.elapsed_time(end) / 1e3
    print(f"4096^3 bf16 matmul x{reps}: {dt * 1e3:.3f} ms, "
          f"{2 * n**3 * reps / dt / 1e12:.1f} TFLOP/s [{card}]")


def main(argv=None):
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s [%(levelname)s] %(name)s: %(message)s",
    )
    p = argparse.ArgumentParser(prog="turbo_whisper_workspace_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    device_help = "torch device the models run on (default: cuda)"

    s = sub.add_parser("api", help="run the HTTP API server")
    s.add_argument("--host", default="0.0.0.0")
    s.add_argument("--port", type=int, default=8000)
    s.add_argument("--device", default="cuda", help=device_help)
    s.set_defaults(fn=run_api)

    s = sub.add_parser("ui", help="run the browser UI")
    s.add_argument("--host", default="0.0.0.0")
    s.add_argument("--port", type=int, default=7860)
    s.add_argument("--device", default="cuda", help=device_help)
    s.set_defaults(fn=run_ui)

    s = sub.add_parser("batch", help="batched directory transcription")
    s.add_argument("--input", "-i", required=True)
    s.add_argument("--output", "-o", default="batch_output")
    s.add_argument("--model", default=None,
                   help="whisper config name (tiny/base/.../large-v3-turbo)")
    s.add_argument("--num-speakers", type=int, default=0)
    s.add_argument("--files-per-call", type=int, default=8)
    s.add_argument("--no-enrich", action="store_true")
    s.add_argument("--device", default="cuda", help=device_help)
    s.set_defaults(fn=run_batch)

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

    s = sub.add_parser("security", help="security-monitor a file/directory")
    s.add_argument("--input", "-i", required=True)
    s.add_argument("--output", "-o", default="security_incidents")
    s.add_argument("--min-threat-level", type=int, default=2)
    s.add_argument("--bar", action="store_true")
    s.add_argument("--test", action="store_true")
    s.add_argument("--device", default="cuda",
                   help="torch device the models run on (default: cuda)")
    s.set_defaults(fn=run_security)

    s = sub.add_parser("info", help="audio file info")
    s.add_argument("--input", "-i", required=True)
    s.set_defaults(fn=run_info)

    s = sub.add_parser("diagnose", help="audio diagnostics report")
    s.add_argument("--input", "-i", required=True)
    s.set_defaults(fn=run_diagnose)

    s = sub.add_parser("preprocess", help="normalize/denoise/filter audio")
    s.add_argument("--input", "-i", required=True)
    s.add_argument("--output", "-o", required=True)
    s.add_argument("--normalize", action="store_true")
    s.add_argument("--dynamic", action="store_true",
                   help="rolling-window dynamic normalization")
    s.add_argument("--window", type=float, default=30.0)
    s.add_argument("--target-db", type=float, default=-16.0)
    s.add_argument("--denoise", type=float, default=0.0,
                   help="spectral denoise strength 0-1")
    s.add_argument("--effects", action="store_true",
                   help="highpass/lowpass/EQ chain")
    s.add_argument("--device", default="cuda",
                   help="torch device of denoising and dynamic normalization "
                        "(default: cuda)")
    s.set_defaults(fn=run_preprocess)

    s = sub.add_parser("convert", help="convert an HF snapshot to npz")
    s.add_argument("--input", "-i", required=True)
    s.add_argument("--output", "-o", required=True)
    s.set_defaults(fn=run_convert)

    s = sub.add_parser("models", help="model registry")
    s.add_argument("action", choices=["check", "list", "download"])
    s.set_defaults(fn=run_models)

    s = sub.add_parser("eval", help="WER/DER accuracy gates over a fixture dir")
    s.add_argument("--audio", required=True)
    s.add_argument("--ref", default=None, help="dir of <stem>.txt transcripts")
    s.add_argument("--rttm", default=None, help="dir of <stem>.rttm files")
    s.add_argument("--model", default=None)
    s.add_argument("--num-speakers", type=int, default=0)
    s.add_argument("--collar", type=float, default=0.25)
    s.add_argument("--device", default="cuda",
                   help="torch device the models run on (default: cuda)")
    s.set_defaults(fn=run_eval)

    s = sub.add_parser("check-gpu", help="device probe + matmul timing")
    s.set_defaults(fn=run_check_gpu)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
