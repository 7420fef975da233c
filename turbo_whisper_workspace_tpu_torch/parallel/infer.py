"""Data- and tensor-parallel decode over a mesh.

Port of turbo_whisper_workspace_tpu/parallel/infer.py. Every rank holds
the whole batch of windows (as every host reads the same file list) and
decodes its own rows on the data axis: mel → encoder → cross-KV →
greedy or beam search, the ordinary single-device program, so the CUDA
kernels see ordinary per-rank shapes.

* `make_dp_decode`: the model whole on every rank. The rows are
  independent, so the decode issues no collective at all
  (`dp_collective_report` counts them: 0).
* `make_tp_decode`: the same program on the rank's shard of the model
  (`sharding.shard_params`), H/tp heads a rank; each row-parallel layer
  sums its partial products over the model group.

`gather_dp` assembles the batch's result from the ranks' rows for the
caller (a collective of its own, outside the decode).

Multi-process: `maybe_initialize_distributed()` starts the default
process group from torchrun's environment (WORLD_SIZE, RANK,
MASTER_ADDR, MASTER_PORT) where the JAX package reads
JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID; then
`mesh.make_mesh` lays the ranks out.
"""

from __future__ import annotations

import os
import time

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..decode import beam as beam_mod
from ..decode import greedy as greedy_mod
from ..decode.rules import DecodeRules
from ..models import whisper as wm
from ..ops import mel as mel_ops
from ..pipeline.transcriber import resolve_device
from . import mesh as mesh_mod
from .mesh import BACKENDS, DATA_AXIS, all_gather, data_sharding
from .sharding import shard_params


def maybe_initialize_distributed(device: torch.device | str = "cuda") -> bool:
    """Start the default process group when torchrun's environment names
    a world of more than one process (backend NCCL for a CUDA device,
    gloo for the CPU; a CUDA rank first takes its LOCAL_RANK's card).
    A no-op on one process, so every entry point can call it. Returns
    True when running multi-process."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(BACKENDS[device.type], init_method="env://",
                            rank=int(os.environ["RANK"]), world_size=world)
    return True


@torch.no_grad()
def _local_decode(model: wm.Whisper, audio: torch.Tensor, prompt: torch.Tensor, *,
                  rules: DecodeRules, beam_size: int, max_len: int, quantize_kv: bool,
                  sot_index: int, graphed: bool | None = None):
    mels = mel_ops.log_mel_spectrogram(audio, num_mels=model.dims.n_mels)
    cross_kv = model.decoder.precompute_cross_kv(model.encoder(mels), quantize=quantize_kv)
    if beam_size > 1:
        return beam_mod.beam_decode_features(
            model, cross_kv, prompt, rules=rules, beam_size=beam_size, max_len=max_len,
            sot_index=sot_index, graphed=graphed)
    return greedy_mod.greedy_decode_features(
        model, cross_kv, prompt, rules=rules, max_len=max_len, sot_index=sot_index,
        graphed=graphed)


def put_dp(mesh: DeviceMesh, x, device: torch.device | str | None = None) -> torch.Tensor:
    """This rank's rows (data axis) of a batch every rank holds whole,
    on `device` (default: the mesh's device type)."""
    return data_sharding(mesh, torch.as_tensor(x)).to(device or mesh.device_type)


def _make_decode(model: wm.Whisper, mesh: DeviceMesh, **kw):
    device = next(model.parameters()).device

    def decode_fn(audio, prompt):
        """audio (B, N_SAMPLES) float or int16 PCM and prompt (B, P), the
        whole batch on every rank (B divisible by the data axis) → the
        DecodeResult (greedy) or BeamResult (beam > 1) of this rank's
        rows; gather_dp assembles the batch's."""
        return _local_decode(model, put_dp(mesh, audio, device),
                             put_dp(mesh, prompt, device).long(), **kw)

    decode_fn.model = model
    return decode_fn


def make_dp_decode(model: wm.Whisper, mesh: DeviceMesh, *, rules: DecodeRules,
                   beam_size: int = 1, max_len: int = 224, quantize_kv: bool = False,
                   sot_index: int = 0):
    """A data-parallel decode: each rank runs the whole model on its rows."""
    return _make_decode(model, mesh, rules=rules, beam_size=beam_size, max_len=max_len,
                        quantize_kv=quantize_kv, sot_index=sot_index)


def make_tp_decode(model: wm.Whisper, mesh: DeviceMesh, *, rules: DecodeRules,
                   beam_size: int = 1, max_len: int = 224, quantize_kv: bool = False,
                   sot_index: int = 0):
    """A tensor-parallel (and, with a data axis > 1, DP×TP) decode: the
    same program on this rank's shard of the model (`decode_fn.model`):
    Megatron column/row-parallel projections, H/tp heads, the KV caches
    at D/tp features (sharding.cache_spec). Whisper fits one card, so
    this is the capacity path; the DP decode is the throughput path. Its
    greedy and beam steps run eagerly (`graphed=False`): the row-parallel sums go
    through `mesh.all_reduce`, whose host-side counter (and, on one card,
    gloo) a CUDA graph's replay would skip."""
    return _make_decode(shard_params(model, mesh), mesh, rules=rules, beam_size=beam_size,
                        max_len=max_len, quantize_kv=quantize_kv, sot_index=sot_index,
                        graphed=False)


def gather_dp(mesh: DeviceMesh, result):
    """The batch's result from the ranks' rows: every field of a
    DecodeResult or BeamResult gathered over the data axis, in row
    order (every rank gets it)."""
    group = mesh.get_group(DATA_AXIS)
    return type(result)(*(all_gather(x, group) for x in result))


def count_collectives(fn, *args, **kw):
    """Run fn(*args, **kw) → (its result, the collectives the port's
    parallel code issued during the call, by name)."""
    mesh_mod.reset_collective_counts()
    result = fn(*args, **kw)
    return result, dict(mesh_mod.collective_counts)


def _zeros_batch(rules: DecodeRules, b: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    sot = rules.specials.sot_sequence(language="en", task="transcribe", timestamps=False)
    audio = torch.zeros((b, mel_ops.N_SAMPLES), dtype=torch.float32, device=device)
    prompt = torch.tensor([sot] * b, dtype=torch.long, device=device)
    return audio, prompt


def dp_collective_report(model: wm.Whisper, mesh: DeviceMesh, *, rules: DecodeRules,
                         batch_per_device: int = 1, max_len: int = 4,
                         quantize_kv: bool = False) -> dict:
    """Count the collectives a DP decode issues on a batch of
    `batch_per_device` silent windows a data rank. The DP decode is
    embarrassingly parallel (the model whole on every rank, rows
    independent), so the count is zero and no byte crosses the
    interconnect during a decode: scaling is bound by the host's input
    dispatch, not by communication."""
    fn = make_dp_decode(model, mesh, rules=rules, max_len=max_len, quantize_kv=quantize_kv)
    audio, prompt = _zeros_batch(rules, batch_per_device * mesh.size(0), "cpu")
    _, counts = count_collectives(fn, audio, prompt)
    total = sum(counts.values())
    return {
        "collective_ops": counts,
        "total_collectives": total,
        "interconnect_bytes_per_step": 0 if total == 0 else None,
        "claim": (
            "DP decode is embarrassingly parallel: zero collectives issued during the "
            "decode => zero interconnect bytes per decode step => scaling is bound by "
            "host dispatch, not by communication"
            if total == 0 else
            "collectives present - the zero-traffic claim does not hold"),
    }


def measure_scaling(model: wm.Whisper, mesh: DeviceMesh, *, rules: DecodeRules,
                    widths=(1, 2), batch_per_device: int = 2, max_len: int = 16,
                    repeats: int = 3) -> dict:
    """Weak-scaling probe of the DP decode: audio-s/s at each width in
    `widths` that the mesh's data axis holds (wider ones are skipped).
    At width w the data ranks 0..w−1 each decode `batch_per_device`
    silent windows and the rest wait; a width's time is the slowest
    rank's (mean of `repeats` after one warm-up call). Every rank of the
    world calls it. On CPU ranks sharing one host's cores the figures
    check the program end to end, not the hardware's scaling."""
    dp = mesh.size(0)
    i = mesh.get_local_rank(DATA_AXIS)
    device = next(model.parameters()).device
    kw = dict(rules=rules, beam_size=1, max_len=max_len, quantize_kv=False, sot_index=0)
    audio, prompt = _zeros_batch(rules, batch_per_device, device)
    results = {}
    for w in widths:
        if w > dp:
            continue
        dt = 0.0
        if i < w:
            _local_decode(model, audio, prompt, **kw)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            for _ in range(repeats):
                r = _local_decode(model, audio, prompt, **kw)
            r.lengths.tolist()
            dt = (time.perf_counter() - t0) / repeats
        slowest = torch.tensor([dt], dtype=torch.float64, device=device)
        mesh_mod.all_reduce(slowest, dist.group.WORLD, op=dist.ReduceOp.MAX)
        results[w] = batch_per_device * w * 30.0 / float(slowest)
    base = results.get(widths[0])
    eff = {w: results[w] / (base * w / widths[0]) for w in results} if base else {}
    analytic = dp_collective_report(model, mesh, rules=rules, max_len=max_len)
    return {"audio_s_per_s": results, "efficiency_vs_linear": eff, "analytic": analytic}
