"""Port parallel paths (turbo_whisper_workspace_tpu_torch/parallel/) against
the JAX package on the CPU.

One gloo world of four spawned ranks runs for the module
(tests/torch_parallel_worker.py, which imports only the port): the TP
forward (dp 2 × tp 2), DP greedy / beam 3 / int8 cross-KV decode (dp 4),
TP decode (tp 2 over two of the ranks, and dp 2 × tp 2), the collective
counts, the indivisible batch, measure_scaling and two train steps
(dp 2 × tp 2). The JAX references run here, in the pytest process, on
the same numpy inputs and weights (JAX init, carried across by
models/convert.py), at the JAX tests' tiny f32 dims, while the world
runs. Then the batch driver (the cases of tests/test_batch_driver.py,
and its artifacts against the JAX driver's on a tiny real pipeline) and
flash_attention's gradient route.
"""

import json
import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_parallel_worker as W
from test_torch_serve import _same
from turbo_whisper_workspace_tpu.audio import io as jio
from turbo_whisper_workspace_tpu.config import PipelineConfig as JPipelineConfig
from turbo_whisper_workspace_tpu.config import TranscriptionConfig as JTConfig
from turbo_whisper_workspace_tpu.decode import tokenizer as jtok
from turbo_whisper_workspace_tpu.decode.rules import DecodeRules as JRules
from turbo_whisper_workspace_tpu.llm import llm_helper as jllm
from turbo_whisper_workspace_tpu.models import whisper as jwm
from turbo_whisper_workspace_tpu.ops import mel as jmel
from turbo_whisper_workspace_tpu.parallel import infer as jinfer
from turbo_whisper_workspace_tpu.parallel import mesh as jmesh
from turbo_whisper_workspace_tpu.parallel import train as jtrain
from turbo_whisper_workspace_tpu.parallel.batch_driver import BatchDriver as JBatchDriver
from turbo_whisper_workspace_tpu.pipeline import audio_pipeline as jpipe
from turbo_whisper_workspace_tpu.pipeline import transcriber as jtr
from turbo_whisper_workspace_tpu_torch.audio import io as tio
from turbo_whisper_workspace_tpu_torch.config import PipelineConfig, TranscriptionConfig
from turbo_whisper_workspace_tpu_torch.llm import llm_helper as tllm
from turbo_whisper_workspace_tpu_torch.models import convert
from turbo_whisper_workspace_tpu_torch.models import whisper as twm
from turbo_whisper_workspace_tpu_torch.ops import attention as att
from turbo_whisper_workspace_tpu_torch.parallel import infer
from turbo_whisper_workspace_tpu_torch.parallel.batch_driver import BatchDriver
from turbo_whisper_workspace_tpu_torch.pipeline import audio_pipeline as tpipe
from turbo_whisper_workspace_tpu_torch.pipeline import transcriber as ttr

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_parallel_worker.py")
WORLD = 4
WORLD_TIMEOUT_S = 300
DECODE_DIMS = jwm.WhisperDims(n_vocab=W.DECODE_VOCAB, **W.DIMS)
TRAIN_DIMS = jwm.WhisperDims(n_vocab=W.TRAIN_VOCAB, **W.DIMS)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _decode_inputs():
    """tests/test_parallel_decode.py's batch: 8 windows, 5 s of noise each."""
    rng = np.random.default_rng(0)
    audio = np.zeros((8, jmel.N_SAMPLES), np.float32)
    audio[:, :16000 * 5] = rng.normal(size=(8, 16000 * 5)).astype(np.float32) * 0.1
    sp = jtok.special_tokens_for_vocab(W.DECODE_VOCAB)
    sot = sp.sot_sequence(language="en", task="transcribe", timestamps=True)
    return audio, np.tile(np.asarray(sot, np.int32), (8, 1))


def _train_inputs():
    rng = np.random.default_rng(1)
    mel = rng.standard_normal((4, 80, 3000)).astype(np.float32)
    tokens = rng.integers(0, W.TRAIN_VOCAB, (4, 12)).astype(np.int32)
    # unequal counts per data shard (rows 0-1: 22, rows 2-3: 10), so a
    # mean of the shards' means would differ from the batch's mean
    mask = np.zeros((4, 11), np.float32)
    mask[:2] = 1.0
    mask[2, :3] = 1.0
    mask[3, :7] = 1.0
    return mel, tokens, mask


class World:
    def __init__(self, root):
        self.root = root
        self.logs = [open(root / f"rank{r}.log", "w") for r in range(WORLD)]
        port = _free_port()
        env = dict(os.environ, OMP_NUM_THREADS="1")
        self.procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(WORLD), str(port),
                                        str(root)], stdout=log, stderr=subprocess.STDOUT, env=env)
                      for r, log in enumerate(self.logs)]
        self.deadline = time.monotonic() + WORLD_TIMEOUT_S
        self._results = None

    def results(self) -> dict:
        if self._results is None:
            for p in self.procs:
                try:
                    p.wait(timeout=max(self.deadline - time.monotonic(), 1))
                except subprocess.TimeoutExpired:
                    self.close()
            for log in self.logs:
                log.close()
            rcs = [p.returncode for p in self.procs]
            if rcs != [0] * WORLD:
                tails = "\n".join(f"--- rank {r}: rc {rc}\n"
                                  + (self.root / f"rank{r}.log").read_text()[-3000:]
                                  for r, rc in enumerate(rcs))
                pytest.fail(f"gloo world failed or timed out:\n{tails}")
            self._results = torch.load(self.root / "results.pt")
        return self._results

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def jax_params():
    return (jwm.init_params(DECODE_DIMS, jax.random.PRNGKey(0)),
            jwm.init_params(TRAIN_DIMS, jax.random.PRNGKey(1)))


@pytest.fixture(scope="module")
def world(tmp_path_factory, jax_params):
    root = tmp_path_factory.mktemp("world")
    decode_p, train_p = jax_params
    convert.save_params(str(root / "decode.npz"), jax.tree.map(np.asarray, decode_p))
    convert.save_params(str(root / "train.npz"), jax.tree.map(np.asarray, train_p))
    audio, prompt = _decode_inputs()
    mel, tokens, mask = _train_inputs()
    rng = np.random.default_rng(2)
    np.savez(root / "inputs.npz", audio=audio, prompt=prompt,
             fwd_mel=rng.standard_normal((2, 80, 3000)).astype(np.float32),
             fwd_tokens=rng.integers(0, W.TRAIN_VOCAB, (2, 6)),
             train_mel=mel, train_tokens=tokens, train_mask=mask)
    w = World(root)
    yield w
    w.close()


@pytest.fixture(scope="module")
def jax_decodes(world, jax_params):
    """The JAX DP decode on a one-device mesh (the JAX tests' reference),
    computed while the world runs."""
    audio, prompt = _decode_inputs()
    rules = JRules(specials=jtok.special_tokens_for_vocab(W.DECODE_VOCAB), timestamps=True)
    mesh1 = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    out = {}
    for name, kw in (("greedy", dict(max_len=W.MAX_LEN)),
                     ("beam3", dict(beam_size=3, max_len=W.MAX_LEN)),
                     ("int8", dict(max_len=W.QUANT_MAX_LEN, quantize_kv=True))):
        r = jinfer.make_dp_decode(DECODE_DIMS, mesh1, rules=rules, **kw)(
            jax_params[0], jnp.asarray(audio), jnp.asarray(prompt))
        out[name] = {k: np.asarray(getattr(r, k))
                     for k in ("tokens", "lengths", "avg_logprobs")}
    return out


def _assert_decode_equal(got: dict, ref: dict, atol: float):
    np.testing.assert_array_equal(got["tokens"].numpy(), ref["tokens"])
    np.testing.assert_array_equal(got["lengths"].numpy(), ref["lengths"])
    np.testing.assert_allclose(got["avg_logprobs"].numpy(), ref["avg_logprobs"],
                               atol=atol, rtol=atol)


def test_tp_forward_matches_jax(world, jax_params):
    inp = np.load(world.root / "inputs.npz")
    ref = np.asarray(jwm.forward(jax_params[1], TRAIN_DIMS, inp["fwd_mel"], inp["fwd_tokens"]))
    got = world.results()["tp_forward"]
    np.testing.assert_allclose(got["logits"].numpy(), ref, atol=2e-4, rtol=1e-4)
    # column-parallel q: half the rows; row-parallel fc2: half the columns;
    # each rank counts its own heads
    assert got["q_shape"] == (32, 64) and got["fc2_shape"] == (64, 128)
    assert got["n_head"] == (1, 1)
    # the rank-local (L, B/dp, T, D/tp) cache is the one a shard's decode allocates
    assert got["cache_spec"] == got["cache_shape"] == (2, 4, 16, 32)


@pytest.mark.parametrize("name", ["greedy", "beam3"])
def test_dp_decode_matches_jax(world, jax_decodes, name):
    got = world.results()[f"dp_{name}"]
    assert got["local_rows"] == 2                 # 8 windows over a data axis of 4
    _assert_decode_equal(got, jax_decodes[name], atol=1e-4)


def test_dp_decode_int8_cross_kv_matches_jax(world, jax_decodes):
    """int8 cross-KV: the port's CPU route is the TPU kernel's math, the
    JAX CPU route its XLA twin; the tokens agree."""
    _assert_decode_equal(world.results()["dp_int8"], jax_decodes["int8"], atol=2e-3)


@pytest.mark.parametrize("name", ["tp_1x2", "tp_2x2"])
def test_tp_decode_matches_jax(world, jax_decodes, name):
    got = world.results()[name]
    _assert_decode_equal(got, jax_decodes["greedy"], atol=2e-3)
    # (L, B, H/tp, 1500, Dh): one head a rank
    assert got["cross_k_shape"] == (2, 1, 1, 1500, 32)


@pytest.mark.parametrize("name,zero", [("dp_greedy", True), ("dp_beam3", True),
                                       ("dp_int8", True), ("tp_1x2", False),
                                       ("tp_2x2", False), ("tp_forward", False)])
def test_collective_counts(world, name, zero):
    """DP decode issues no collective (rows are independent); TP sums each
    row-parallel layer over the model group."""
    counts = world.results()[name]["collectives"]
    if zero:
        assert sum(counts.values()) == 0, counts
    else:
        assert counts["all_reduce"] > 0 and counts["all_gather"] == 0, counts


def test_dp_batch_not_divisible_raises(world):
    assert "not divisible by data axis 4" in world.results()["not_divisible"]


def test_maybe_initialize_distributed(world, monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert infer.maybe_initialize_distributed("cpu") is False
    assert world.results()["multi_process"] is True


def test_measure_scaling_runs(world):
    rep = world.results()["scaling"]
    assert set(rep["audio_s_per_s"]) == {1, 2, 4}
    assert all(v > 0 for v in rep["audio_s_per_s"].values())
    assert set(rep["efficiency_vs_linear"]) == {1, 2, 4}
    assert rep["analytic"]["total_collectives"] == 0
    assert rep["analytic"]["interconnect_bytes_per_step"] == 0


def test_train_steps_match_jax(world, jax_params):
    """Two AdamW steps on dp 2 × tp 2 against optax.adamw on the JAX
    package's 8-device mesh: losses and every updated tensor, the
    encoder's pos_emb included, within 1e-4 relative."""
    mel, tokens, mask = _train_inputs()
    mesh = jmesh.make_mesh(model_parallel=2)
    init_fn, step_fn = jtrain.make_train_step(TRAIN_DIMS, mesh, learning_rate=W.TRAIN_LR)
    params0 = jax.tree.map(jnp.copy, jax_params[1])
    losses = []
    with mesh:
        params, opt_state = init_fn(params0)
        for _ in range(W.TRAIN_STEPS):
            params, opt_state, loss = step_fn(params, opt_state, jnp.asarray(mel),
                                              jnp.asarray(tokens), jnp.asarray(mask))
            losses.append(float(loss))
    got = world.results()["train"]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-4)
    ref = convert.state_dict_from_jax_params(jax.tree.map(np.asarray, params))
    start = convert.state_dict_from_jax_params(jax.tree.map(np.asarray, jax_params[1]))
    assert set(got["state"]) == set(ref)
    for name, want in ref.items():
        have = got["state"][name]
        err = float((have - want).norm() / want.norm().clamp_min(1e-12))
        assert err <= 1e-4, (name, err)
    moved = (got["state"]["encoder.pos_emb"] - start["encoder.pos_emb"]).abs().max()
    assert float(moved) > 1e-3                    # pos_emb is trained, as in JAX


# ---------------------------------------------------------------------------
# the model paths the parallel code relies on


def test_teacher_forced_decoder_equals_cached_prefill():
    """The teacher-forced decoder (no cache, as the train step runs it) is
    bit-equal to a prefill into a fresh cache of the same length."""
    dims = twm.WhisperDims(n_vocab=W.TRAIN_VOCAB, **W.DIMS)
    model = twm.init_params(dims, torch.Generator().manual_seed(0))
    feats = torch.randn(2, 1500, 64, generator=torch.Generator().manual_seed(1))
    tokens = torch.randint(0, W.TRAIN_VOCAB, (2, 7), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        ckv = model.decoder.precompute_cross_kv(feats)
        cache = twm.init_kv_cache(dims, 2, max_len=7, dtype=torch.float32)
        want, _ = model.decoder(tokens, ckv, cache, pos=0)
        got, none = model.decoder(tokens, ckv)
    assert none is None and torch.equal(got, want)


def test_flash_attention_backward_matches_autograd_of_plain_version():
    gen = torch.Generator().manual_seed(0)
    q, k, v, g = (torch.randn(2, 3, 300, 64, generator=gen, dtype=torch.float64)
                  for _ in range(4))
    qkv = [t.clone().requires_grad_() for t in (q, k, v)]
    torch.autograd.backward(att.flash_attention_reference(*qkv), g)
    got = att.flash_attention_backward(q, k, v, g)
    for have, want in zip(got, (t.grad for t in qkv)):
        torch.testing.assert_close(have.double(), want, rtol=1e-5, atol=1e-5)


def test_flash_attention_autograd_route(monkeypatch):
    """FlashAttention's wiring on the CPU: its forward's launch patched to
    the plain version, its gradients those of the plain version, and the
    route taken only when autograd records."""
    calls = []

    def launch(q, k, v):
        calls.append(torch.is_grad_enabled())
        return att.flash_attention_reference(q, k, v)

    monkeypatch.setattr(att, "_flash_attention_launch", launch)
    gen = torch.Generator().manual_seed(1)
    q, k, v, g = (torch.randn(1, 2, 256, 64, generator=gen) for _ in range(4))
    ours = [t.clone().requires_grad_() for t in (q, k, v)]
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    out = att.FlashAttention.apply(*ours)
    torch.testing.assert_close(out, att.flash_attention_reference(*plain))
    out.backward(g)
    att.flash_attention_reference(*plain).backward(g)
    for a, b in zip(ours, plain):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-4, atol=1e-5)
    assert calls == [False]                       # the forward runs without autograd


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this check on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_flash_attention_gradients_match_plain_version(cuda_device):
    """The kernel route's q/k/v gradients against the plain version's
    autograd gradients, bf16, within 1e-2 relative L2."""
    gen = torch.Generator(cuda_device).manual_seed(0)
    q, k, v, g = (torch.randn(2, 20, 1500, 64, generator=gen, device=cuda_device)
                  .to(torch.bfloat16) for _ in range(4))
    ours = [t.clone().requires_grad_() for t in (q, k, v)]
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    before = att.launch_counts["flash_attention"]
    att.flash_attention(*ours).backward(g)
    assert att.launch_counts["flash_attention"] == before + 1
    att.flash_attention_reference(*plain).backward(g)
    for a, b in zip(ours, plain):
        err = float((a.grad.float() - b.grad.float()).norm() / b.grad.float().norm())
        assert err <= 1e-2, err


# ---------------------------------------------------------------------------
# the batch driver: tests/test_batch_driver.py's cases on the port


class CountingPipeline:
    def __init__(self, fail_on=None):
        self.calls = []
        self.fail_on = fail_on or set()

    def process_batch(self, paths, **kw):
        self.calls.append(list(paths))
        for p in paths:
            if os.path.basename(p) in self.fail_on:
                raise RuntimeError(f"boom on {p}")
        return [{"duration": 2.0, "text": "ok", "audio_path": p} for p in paths]


def _make_files(tmp_path, n):
    for i in range(n):
        tio.write_wav(str(tmp_path / f"f{i}.wav"), np.zeros(16000, np.float32))
    return tmp_path


def test_batch_processes_and_writes_artifacts(tmp_path):
    _make_files(tmp_path, 5)
    pipe = CountingPipeline()
    d = BatchDriver(pipeline=pipe, output_dir=str(tmp_path / "out"), files_per_call=2)
    stats = d.run_directory(str(tmp_path))
    assert stats.processed == 5 and stats.audio_seconds == 10.0
    outs = [f for f in os.listdir(tmp_path / "out")
            if f.endswith(".json") and not f.startswith("manifest")]
    assert len(outs) == 5
    assert len(pipe.calls) == 3                   # 2 + 2 + 1


def test_manifest_resume_skips_done(tmp_path):
    _make_files(tmp_path, 4)
    out = str(tmp_path / "out")
    BatchDriver(pipeline=CountingPipeline(), output_dir=out).run_directory(str(tmp_path))
    pipe2 = CountingPipeline()
    stats = BatchDriver(pipeline=pipe2, output_dir=out).run_directory(str(tmp_path))
    assert stats.processed == 0 and stats.skipped == 4 and pipe2.calls == []


def test_failure_isolation(tmp_path):
    _make_files(tmp_path, 3)
    pipe = CountingPipeline(fail_on={"f1.wav"})
    d = BatchDriver(pipeline=pipe, output_dir=str(tmp_path / "out"), files_per_call=3,
                    max_retries=0)
    stats = d.run_directory(str(tmp_path))
    assert stats.processed == 2 and stats.failed == 1
    assert stats.failures and "f1.wav" in stats.failures[0]
    # the failed file is NOT in the manifest, so the next run retries it
    manifest = json.load(open(d._manifest_path()))
    assert not any("f1.wav" in p for p in manifest["done"])


def test_shard_files_single_process():
    files = [f"x{i}" for i in range(5)]
    assert BatchDriver.shard_files(files) == files          # no process group: 1 of 1


def test_batch_artifacts_match_jax_driver(tmp_path, jax_params, monkeypatch):
    """Both drivers over one directory of two clips, each with its
    package's pipeline on the same tiny Whisper (greedy at T = 0,
    weight-free diarization, DummyLLM enrichment): equal manifests and
    per-file artifacts (processing times aside)."""
    monkeypatch.setattr(jtr, "FALLBACK_TEMPERATURES", (0.0,))
    monkeypatch.setattr(ttr, "FALLBACK_TEMPERATURES", (0.0,))
    audio_dir = tmp_path / "audio"
    audio_dir.mkdir()
    rng = np.random.default_rng(3)
    for i, seconds in enumerate((2.0, 3.5)):
        t = np.arange(int(seconds * 16000)) / 16000
        x = 0.2 * np.sin(2 * np.pi * (180 + 60 * i) * t) + 0.02 * rng.standard_normal(t.size)
        jio.write_wav(str(audio_dir / f"clip{i}.wav"), x.astype(np.float32))
    kw = dict(batch_size=2, max_decode_len=8, language="en")
    jt = jtr.load_transcriber(jax_params[0], DECODE_DIMS, JTConfig(**kw))
    model = convert.from_jax_params(jax.tree.map(np.asarray, jax_params[0]),
                                    twm.WhisperDims(**DECODE_DIMS.__dict__))
    tt = ttr.load_transcriber(model, TranscriptionConfig(**kw), device="cpu")
    jllm.set_llm(jllm.DummyLLM())
    tllm.set_llm(tllm.DummyLLM())
    try:
        for driver, out in (
                (JBatchDriver(pipeline=jpipe.AudioProcessingPipeline(JPipelineConfig(),
                                                                    transcriber=jt),
                              output_dir=str(tmp_path / "jax")), "jax"),
                (BatchDriver(pipeline=tpipe.AudioProcessingPipeline(PipelineConfig(),
                                                                   transcriber=tt,
                                                                   device="cpu"),
                             output_dir=str(tmp_path / "torch"), device="cpu"), "torch")):
            stats = driver.run_directory(str(audio_dir), num_speakers=2)
            assert stats.processed == 2 and stats.failed == 0, out
    finally:
        jllm.set_llm(None)
        tllm.set_llm(None)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "torch")) == [
        "clip0.json", "clip1.json", "manifest_host0.json"]
    for name in names:
        want = json.load(open(tmp_path / "jax" / name))
        got = json.load(open(tmp_path / "torch" / name))
        want.pop("processing_times", None)
        got.pop("processing_times", None)
        _same(got, want)
