"""Port Whisper model (turbo_whisper_workspace_tpu_torch/models) against
the JAX package, on the same weights (JAX init → from_jax_params) and
inputs, in f32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from turbo_whisper_workspace_tpu.models import convert as jconvert
from turbo_whisper_workspace_tpu.models import whisper as jwm
from turbo_whisper_workspace_tpu_torch.models import convert as tconvert
from turbo_whisper_workspace_tpu_torch.models import whisper as twm

DIMS = jwm.WhisperDims(80, 1500, 64, 2, 2, 517, 448, 64, 2, 2)


@pytest.fixture(scope="module")
def pair():
    params = jwm.init_params(DIMS, jax.random.PRNGKey(0))
    model = tconvert.from_jax_params(jax.tree.map(np.asarray, params),
                                     twm.WhisperDims(**DIMS.__dict__))
    return params, model


@pytest.fixture(scope="module")
def feats():
    rng = np.random.default_rng(1)
    return (rng.standard_normal((2, DIMS.n_audio_ctx, DIMS.n_audio_state)) * 0.3
            ).astype(np.float32)


def test_configs_and_sinusoids_match_jax():
    assert {k: v.__dict__ for k, v in twm.WHISPER_CONFIGS.items()} == \
        {k: v.__dict__ for k, v in jwm.WHISPER_CONFIGS.items()}
    np.testing.assert_array_equal(twm.sinusoids(1500, 64), jwm.sinusoids(1500, 64))


def test_from_jax_params_same_tensors(pair):
    params, model = pair
    sd = model.state_dict()
    enc = params["encoder"]
    np.testing.assert_array_equal(sd["encoder.conv1.weight"].numpy(),
                                  np.asarray(enc["conv1"]["w"]))
    np.testing.assert_array_equal(sd["encoder.pos_emb"].numpy(), np.asarray(enc["pos_emb"]))
    for li in range(DIMS.n_audio_layer):
        blk = jax.tree.map(lambda x, li=li: np.asarray(x[li]), enc["blocks"])
        np.testing.assert_array_equal(
            sd[f"encoder.blocks.{li}.attn.q.weight"].numpy(), blk["attn"]["q"]["w"].T)
        np.testing.assert_array_equal(
            sd[f"encoder.blocks.{li}.mlp.fc2.bias"].numpy(), blk["mlp"]["fc2"]["b"])
        np.testing.assert_array_equal(
            sd[f"encoder.blocks.{li}.attn_ln.weight"].numpy(), blk["attn_ln"]["scale"])
    dec_blk = jax.tree.map(lambda x: np.asarray(x[1]), params["decoder"]["blocks"])
    np.testing.assert_array_equal(sd["decoder.blocks.1.cross.k.weight"].numpy(),
                                  dec_blk["cross"]["k"]["w"].T)
    assert "decoder.blocks.1.cross.k.bias" not in sd
    np.testing.assert_array_equal(sd["decoder.token_emb"].numpy(),
                                  np.asarray(params["decoder"]["token_emb"]))
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(params))
    assert sum(t.numel() for t in sd.values()) == n_jax


def test_load_params_reads_jax_checkpoint(pair, tmp_path):
    params, model = pair
    path = str(tmp_path / "whisper-test.npz")
    jconvert.save_params(path, jax.tree.map(lambda x: x.astype(jnp.bfloat16), params),
                         meta={"n_vocab": DIMS.n_vocab})
    loaded = tconvert.from_jax_params(tconvert.load_params(path), model.dims,
                                      dtype=torch.bfloat16)
    want = {k: v.to(torch.bfloat16) for k, v in model.state_dict().items()}
    got = loaded.state_dict()
    assert got.keys() == want.keys()
    for name in want:
        torch.testing.assert_close(got[name], want[name], rtol=0, atol=0)


def test_init_params_distributions():
    dims = twm.WhisperDims(80, 1500, 256, 4, 2, 1000, 448, 256, 4, 2)
    model = twm.init_params(dims, torch.Generator().manual_seed(0))
    sd = model.state_dict()
    assert abs(sd["encoder.blocks.0.mlp.fc1.weight"].std().item() - 256 ** -0.5) < 0.01
    assert abs(sd["encoder.blocks.0.mlp.fc2.weight"].std().item() - 1024 ** -0.5) < 0.01
    assert abs(sd["encoder.conv2.weight"].std().item() - 0.02) < 0.002
    assert abs(sd["decoder.token_emb"].std().item() - 0.02) < 0.002
    assert sd["decoder.blocks.1.cross.v.bias"].abs().max() == 0
    assert (sd["decoder.ln.weight"] == 1).all()
    np.testing.assert_array_equal(sd["encoder.pos_emb"].numpy(), twm.sinusoids(1500, 256))
    again = twm.init_params(dims, torch.Generator().manual_seed(0)).state_dict()
    assert all(torch.equal(sd[k], again[k]) for k in sd)


def test_encoder_matches_jax(pair):
    params, model = pair
    mel = np.random.default_rng(0).standard_normal((2, DIMS.n_mels, 3000)).astype(np.float32)
    ref = np.asarray(jwm.encoder_forward(params, DIMS, mel))
    got = model.encoder(torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=1e-3)  # test_whisper_model.py:68


def test_decoder_prefill_and_step_match_jax(pair, feats):
    """bf16-layout self-cache (f32 here) and int8 cross-KV, prefill then
    one step at pos 3."""
    params, model = pair
    ckv_j = jwm.precompute_cross_kv(params, DIMS, feats, quantize=True)
    ckv_t = model.decoder.precompute_cross_kv(torch.from_numpy(feats), quantize=True)
    for key in ckv_j:
        np.testing.assert_array_equal(ckv_t[key].numpy(), np.asarray(ckv_j[key]))
    prefill = np.array([[11, 3, 7], [42, 9, 1]], np.int32)
    step = np.array([[500], [300]], np.int32)

    cache_j = jwm.init_kv_cache(DIMS, 2, max_len=8, dtype=jnp.float32)
    ref1, cache_j = jwm.decoder_forward(params, DIMS, prefill, ckv_j, cache_j, pos=0)
    ref2, cache_j = jwm.decoder_forward(params, DIMS, step, ckv_j, cache_j, pos=3)

    cache_t = twm.init_kv_cache(model.dims, 2, max_len=8, dtype=torch.float32)
    got1, cache_t = model.decoder(torch.from_numpy(prefill).long(), ckv_t, cache_t,
                                   pos=0)
    got2, cache_t = model.decoder(torch.from_numpy(step).long(), ckv_t, cache_t,
                                   pos=3)
    assert got1.dtype == torch.float32 and got2.shape == (2, 1, DIMS.n_vocab)
    # q and the cross weights round to bf16 on both sides (test_pallas_model_path.py:94)
    np.testing.assert_allclose(got1.numpy(), np.asarray(ref1), atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(got2.numpy(), np.asarray(ref2), atol=2e-2, rtol=2e-2)
    for key in ("k", "v"):
        np.testing.assert_allclose(cache_t[key].numpy(), np.asarray(cache_j[key]),
                                   atol=2e-2, rtol=2e-2)
    assert cache_t["k"][:, :, 4:].abs().max() == 0


def test_forward_matches_jax(pair):
    """Teacher-forced forward with the dense cross-KV branch."""
    params, model = pair
    rng = np.random.default_rng(5)
    mel = rng.standard_normal((1, DIMS.n_mels, 3000)).astype(np.float32)
    tokens = rng.integers(0, DIMS.n_vocab, (1, 6)).astype(np.int32)
    ref = np.asarray(jwm.forward(params, DIMS, mel, tokens))
    got = model(torch.from_numpy(mel), torch.from_numpy(tokens).long()).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-3, rtol=1e-3)


def test_decoder_quantized_prefill_and_step_match_jax(pair, feats):
    """int8 self-cache: the prefill (plain masked path) then a step at
    pos 3 (self_attention_int8's plain version here), int8 cross-KV."""
    params, model = pair
    ckv_j = jwm.precompute_cross_kv(params, DIMS, feats, quantize=True)
    ckv_t = model.decoder.precompute_cross_kv(torch.from_numpy(feats), quantize=True)
    prefill = np.array([[11, 3, 7], [42, 9, 1]], np.int32)
    step = np.array([[500], [300]], np.int32)

    cache_j = jwm.init_kv_cache(DIMS, 2, max_len=8, quantize=True)
    ref1, cache_j = jwm.decoder_forward(params, DIMS, prefill, ckv_j, cache_j, pos=0)
    ref2, cache_j = jwm.decoder_forward(params, DIMS, step, ckv_j, cache_j, pos=3)

    cache_t = twm.init_kv_cache(model.dims, 2, max_len=8, dtype=torch.float32,
                                quantize=True)
    assert cache_t["k_q"].shape == (2, 2, 2, 8, 32) and cache_t["k_q"].dtype == torch.int8
    assert cache_t["k_s"].dtype == torch.bfloat16        # whatever the model dtype
    got1, cache_t = model.decoder(torch.from_numpy(prefill).long(), ckv_t, cache_t, pos=0)
    got2, cache_t = model.decoder(torch.from_numpy(step).long(), ckv_t, cache_t, pos=3)
    np.testing.assert_allclose(got1.numpy(), np.asarray(ref1), atol=5e-3, rtol=5e-3)
    np.testing.assert_allclose(got2.numpy(), np.asarray(ref2), atol=5e-3, rtol=5e-3)
    for key in ("k_q", "v_q"):
        # a row may round across a .5 boundary from a last-bit f32 difference
        diff = np.abs(cache_t[key].numpy().astype(int) - np.asarray(cache_j[key], int))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    assert cache_t["k_q"][:, :, :, 4:].abs().max() == 0


def test_decoder_lane_step_matches_jax(pair, feats):
    """Two beam steps (beam 3) over the lane cache after a quantized
    prefill; the second reads a non-trivial ancestry: at t = 3 beam 0
    reads lane 2, beams 1 and 2 read lane 0."""
    params, model = pair
    beam = 3
    ckv_j = jwm.precompute_cross_kv(params, DIMS, feats, quantize=True)
    ckv_t = model.decoder.precompute_cross_kv(torch.from_numpy(feats), quantize=True)
    prefill = np.array([[11, 3, 7], [42, 9, 1]], np.int32)
    steps = [np.array([[500], [300], [12], [7], [99], [1]], np.int32),
             np.array([[5], [30], [120], [70], [9], [10]], np.int32)]
    lane_maps = [np.zeros((2, beam, 8), np.int32) for _ in steps]
    lane_maps[0][:, :, 3] = np.arange(beam)
    lane_maps[1][:, :, 3] = [2, 0, 0]
    lane_maps[1][:, :, 4] = np.arange(beam)

    cache_j = jwm.init_kv_cache(DIMS, 2, max_len=8, quantize=True)
    _, cache_j = jwm.decoder_forward(params, DIMS, prefill, ckv_j, cache_j, pos=0)
    cache_j = jwm.beam_lane_cache(cache_j, beam)
    cache_t = twm.init_kv_cache(model.dims, 2, max_len=8, dtype=torch.float32,
                                quantize=True)
    _, cache_t = model.decoder(torch.from_numpy(prefill).long(), ckv_t, cache_t, pos=0)
    cache_t = twm.beam_lane_cache(cache_t, beam)
    for i, (tok, lane_map) in enumerate(zip(steps, lane_maps)):
        ref, cache_j = jwm.decoder_forward(params, DIMS, tok, ckv_j, cache_j, pos=3 + i,
                                           beam=beam, lane_map=jnp.asarray(lane_map))
        got, cache_t = model.decoder(torch.from_numpy(tok).long(), ckv_t, cache_t,
                                     pos=3 + i, beam=beam,
                                     lane_map=torch.from_numpy(lane_map))
        assert got.shape == (6, 1, DIMS.n_vocab)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-3, rtol=5e-3)
    kp = cache_t["k_p"].numpy()                 # (L, B, H·Dh, K, T)
    assert kp.shape == (DIMS.n_text_layer, 2, DIMS.n_text_state, beam, 8)
    assert (np.abs(kp[:, :, :, :, 3:5]).sum(axis=(0, 1, 2)) > 0).all()   # every lane, both steps
    assert np.abs(kp[:, :, :, 1:, :3]).sum() == 0                        # prompt in lane 0 only
    assert np.abs(kp[..., 5:]).sum() == 0
    for key in cache_j:
        diff = np.abs(cache_t[key].float().numpy() - np.asarray(cache_j[key], np.float32))
        assert diff.max() <= (1 if key in ("k_p", "v_p") else 1e-2), key
