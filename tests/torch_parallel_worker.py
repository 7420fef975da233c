"""One rank of the gloo world that tests/test_torch_parallel.py starts.

    python tests/torch_parallel_worker.py RANK WORLD PORT DIR

Imports the port only (no jax, no JAX package). DIR holds the inputs the
test wrote (`inputs.npz`, `decode.npz` and `train.npz`: JAX parameter
trees in the shared `.npz` format); rank 0 writes every case's result
to DIR/results.pt. A failure raises (the process exits non-zero), and
every collective times out after COLLECTIVE_TIMEOUT_S, so a hang ends
the world instead of the test session.
"""

from __future__ import annotations

import datetime
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from turbo_whisper_workspace_tpu_torch.decode.rules import DecodeRules  # noqa: E402
from turbo_whisper_workspace_tpu_torch.decode.tokenizer import (  # noqa: E402
    special_tokens_for_vocab)
from turbo_whisper_workspace_tpu_torch.models import convert  # noqa: E402
from turbo_whisper_workspace_tpu_torch.models import whisper as wm  # noqa: E402
from turbo_whisper_workspace_tpu_torch.parallel import infer, sharding, train  # noqa: E402
from turbo_whisper_workspace_tpu_torch.parallel.mesh import all_gather, make_mesh  # noqa: E402

COLLECTIVE_TIMEOUT_S = 60
# the JAX tests' tiny f32 dims: tests/test_parallel.py (vocab 1024) for the
# forward and the train step, tests/test_parallel_decode.py for decoding
DIMS = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=2,
            n_audio_layer=2, n_text_ctx=448, n_text_state=64, n_text_head=2,
            n_text_layer=2)
TRAIN_VOCAB, DECODE_VOCAB = 1024, 51865
MAX_LEN, QUANT_MAX_LEN = 12, 8
TRAIN_STEPS, TRAIN_LR = 2, 1e-3


def load_model(path: str, vocab: int) -> wm.Whisper:
    return convert.from_jax_params(convert.load_params(path),
                                   wm.WhisperDims(n_vocab=vocab, **DIMS))


def decoded(result, counts: dict | None = None) -> dict:
    out = {"tokens": result.tokens, "lengths": result.lengths,
           "avg_logprobs": result.avg_logprobs}
    if counts is not None:
        out["collectives"] = counts
    return out


def main(rank: int, world: int, port: int, root: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    inp = np.load(os.path.join(root, "inputs.npz"))
    out = {}
    mesh22 = make_mesh(model_parallel=2, data_parallel=2, device_type="cpu")
    mesh14 = make_mesh(model_parallel=1, device_type="cpu")
    mesh12 = make_mesh(model_parallel=2, device_type="cpu", ranks=[0, 1])

    # TP forward, dp 2 x tp 2
    fwd = load_model(os.path.join(root, "train.npz"), TRAIN_VOCAB)
    local = sharding.shard_params(fwd, mesh22)
    with torch.no_grad():
        logits, counts = infer.count_collectives(
            local, infer.put_dp(mesh22, inp["fwd_mel"]), infer.put_dp(mesh22, inp["fwd_tokens"]))
    out["tp_forward"] = {
        "logits": all_gather(logits, mesh22.get_group("data")), "collectives": counts,
        "q_shape": tuple(local.decoder.blocks[0].attn.q.weight.shape),
        "fc2_shape": tuple(local.encoder.blocks[0].mlp.fc2.weight.shape),
        "n_head": (local.encoder.blocks[0].n_head, local.decoder.n_head),
        "cache_spec": sharding.cache_spec(fwd.dims, mesh22, batch=8, max_len=16),
        "cache_shape": tuple(wm.init_kv_cache(fwd.dims, 4, max_len=16, dtype=torch.float32,
                                              n_head=local.decoder.n_head)["k"].shape)}

    # DP greedy / beam 3 (dp 4), DP with int8 cross-KV, TP decode
    model = load_model(os.path.join(root, "decode.npz"), DECODE_VOCAB)
    rules = DecodeRules(specials=special_tokens_for_vocab(DECODE_VOCAB), timestamps=True)
    audio, prompt = inp["audio"], inp["prompt"]
    for name, kw in (("dp_greedy", dict(max_len=MAX_LEN)),
                     ("dp_beam3", dict(beam_size=3, max_len=MAX_LEN)),
                     ("dp_int8", dict(max_len=QUANT_MAX_LEN, quantize_kv=True))):
        fn = infer.make_dp_decode(model, mesh14, rules=rules, **kw)
        res, counts = infer.count_collectives(fn, audio, prompt)
        out[name] = decoded(infer.gather_dp(mesh14, res), counts)
        out[name]["local_rows"] = res.tokens.shape[0]
    for name, mesh in (("tp_1x2", mesh12), ("tp_2x2", mesh22)):
        if mesh.get_coordinate() is None:
            continue
        fn = infer.make_tp_decode(model, mesh, rules=rules, max_len=MAX_LEN)
        res, counts = infer.count_collectives(fn, audio, prompt)
        out[name] = decoded(infer.gather_dp(mesh, res), counts)
        out[name]["cross_k_shape"] = tuple(fn.model.decoder.precompute_cross_kv(
            torch.zeros(1, 1500, DIMS["n_text_state"]))["k"].shape)
    try:
        infer.make_dp_decode(model, mesh14, rules=rules, max_len=4)(audio[:6], prompt[:6])
        out["not_divisible"] = None
    except ValueError as e:
        out["not_divisible"] = str(e)
    out["multi_process"] = infer.maybe_initialize_distributed("cpu")
    out["scaling"] = infer.measure_scaling(
        model, mesh14, rules=DecodeRules(specials=rules.specials, timestamps=False),
        widths=(1, 2, 4), batch_per_device=1, max_len=4, repeats=1)

    # two train steps, dp 2 x tp 2
    init_fn, step_fn = train.make_train_step(
        load_model(os.path.join(root, "train.npz"), TRAIN_VOCAB), mesh22,
        learning_rate=TRAIN_LR)
    local, opt = init_fn()
    losses = []
    for _ in range(TRAIN_STEPS):
        local, opt, loss = step_fn(local, opt, inp["train_mel"], inp["train_tokens"],
                                   inp["train_mask"])
        losses.append(float(loss))
    out["train"] = {"losses": losses,
                    "state": sharding.gather_state_dict(local, mesh22)}

    if rank == 0:
        torch.save(out, os.path.join(root, "results.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
